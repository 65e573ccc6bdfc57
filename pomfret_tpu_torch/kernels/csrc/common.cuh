// Device code shared by the greedy-loop kernels of this directory: warp and
// block reductions, the valid-site range, the scoring of candidate rows,
// bulk copies and the shared-memory opt-in. The loop and probe kernels run
// blocks of kThreads threads, the per-iteration kernels of kStepThreads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace pomfret {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// placement bits: which per-lane buffers of a kernel live in shared memory
// (the others in per-lane global buffers, reached through the same pointers)
enum Place { kSumsShared = 1, kTableShared = 2, kRowsShared = 4,
             kSlotsShared = 8 };

__host__ __device__ inline unsigned align_up(unsigned x, unsigned a) {
  return (x + a - 1) / a * a;
}

// The most dynamic shared memory a block may opt in to on the current
// device; returns a CUDA error code.
inline int optin_bytes(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return static_cast<int>(e);
}

// Lets `kernel` launch with up to the opt-in maximum of dynamic shared
// memory on the current device (above 48 KB a launch needs it). The
// attribute belongs to the (kernel, device) pair, so each launcher keeps in
// `done` one bit per device index it has set it on; a device from index 64
// on has it set at every launch. Returns a CUDA error code.
template <typename Kernel>
inline int allow_optin(Kernel* kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return 0;
  int optin = 0;
  const int rc = optin_bytes(&optin);
  if (rc != 0) return rc;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  done.fetch_or(bit, std::memory_order_release);
  return 0;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide min/max, returned to every thread. The leading barrier keeps a
// previous call's readers of `red` ahead of this call's writers.
__device__ __forceinline__ int block_min(int v, int* red) {
  v = warp_min(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < kWarps; ++w) r = min(r, red[w]);
  return r;
}

__device__ __forceinline__ int block_max(int v, int* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < kWarps; ++w) r = max(r, red[w]);
  return r;
}

// The scoring of a candidate row over the sites [lo, hi): for each site
// whose mer id is found in the table, the ratio cnt/max(sum, 1) of each
// haplotype whose sum is positive (an f32 IEEE division), summed in f64.
// Every ratio is an f32 multiple of 2^-(23+ceil(log2 sum)), so the f64 sum
// is exact and independent of the order of summation; rounding it once to
// f32 gives the plain versions' bits. The counts f (found) and nz (nonzero
// ratio) are the l_found and l_nonzero of the score_l double count.
// cnt and the sums carry no __restrict__: the kernels write them between
// two scorings, so their loads must not go through the non-coherent
// read-only cache.
struct Score {
  double a0, a1;
  int f0, f1, nz0, nz1;
};

// Per-phase cycle counts of one block, kept by one thread: lap(p) adds the
// clock64() cycles since the previous lap (or start) to phase p. With a
// null output nothing reads the clock. Phases of the loop kernel:
// prologue, range, candidates, scoring, decide, commit.
constexpr int kPhases = 6;
enum Phase { kPrologue, kRange, kCandidates, kScoring, kDecide, kCommit };

// clock64() that the compiler keeps in place among memory operations and
// barriers (a plain clock64() may move across them)
__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

struct PhaseClock {
  long long* out;  // this block's kPhases counters, or null
  long long t;
  long long acc[kPhases];

  __device__ __forceinline__ explicit PhaseClock(long long* o) : out(o), t(0) {
    for (int p = 0; p < kPhases; ++p) acc[p] = 0;
    if (out) t = clock_now();
  }
  __device__ __forceinline__ void lap(int p) {
    if (!out) return;
    const long long n = clock_now();
    acc[p] += n - t;
    t = n;
  }
  __device__ __forceinline__ void store() {
    if (!out) return;
    for (int p = 0; p < kPhases; ++p) out[p] = acc[p];
  }
};

// Adds to r one site whose mer has the counts c0, c1 and the site sums
// t0, t1 (all 0 for a site whose mer is absent or out of the table).
__device__ __forceinline__ void score_cells(Score& r, float c0, float c1,
                                            float t0, float t1) {
  if (!(c0 + c1 > 0.f)) return;  // not found in the table
  if (t0 > 0.f) {
    const float q = __fdiv_rn(c0, fmaxf(t0, 1.f));
    r.a0 += static_cast<double>(q);
    ++r.f0;
    r.nz0 += q > 0.f;
  }
  if (t1 > 0.f) {
    const float q = __fdiv_rn(c1, fmaxf(t1, 1.f));
    r.a1 += static_cast<double>(q);
    ++r.f1;
    r.nz1 += q > 0.f;
  }
}

// --- bulk copies (cp.async.bulk, the Tensor Memory Accelerator's
// one-dimensional form) completing on an mbarrier in shared memory ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's generic-proxy accesses to shared memory before the
// async proxy's (the bulk copies') later ones.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The barrier's one arrival, expecting `bytes` of copies to complete on it.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One arrival that expects `bytes`, then the copy of those bytes.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  mbar_arrive_expect_tx(bar, bytes);
  bulk_g2s(dst, src, bytes, bar);
}

// Spin until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// --- the per-iteration kernels (score_kernel.cu, score_commit_kernel.cu):
// one block per lane scores the lane's NC candidate rows ---

// Their blocks are twice the others': a lane's scoring is a chain of
// dependent shuffles and lookups, so an SM needs many warps to hide their
// latency, and there are only ~2 lanes an SM (G=256 over 132 SMs). Two
// blocks of kStepThreads share an SM at up to 64 registers a thread.
constexpr int kStepThreads = 512;
constexpr int kStepWarps = kStepThreads / 32;

// Dynamic shared memory of one block of either kernel: the mbarrier, the
// range partials, then the slots' sums, the site sums and the count table
// where their placement bits say so (kSlotsShared, kSumsShared,
// kTableShared), else nothing: they stay in global memory.
struct StepLayout {
  unsigned bar, red, slots, sums, table, total;
};

// The slots' sums of one lane: per slot the f64 ratio sums and the found
// and nonzero counts of each haplotype.
__host__ __device__ inline unsigned slot_sums_bytes(int NC) {
  return align_up(static_cast<unsigned>(NC) * 32u, 16);
}

__host__ __device__ inline StepLayout step_layout(int NC, int S, int D,
                                                 int place) {
  StepLayout L;
  unsigned o = 0;
  L.bar = o;   o += 16;
  L.red = o;   o += 2 * kStepWarps * 4;
  o = align_up(o, 16);
  L.slots = o;
  if (place & kSlotsShared) o += slot_sums_bytes(NC);
  o = align_up(o, 128);
  L.sums = o;
  if (place & kSumsShared) o += 2u * S * 4;
  o = align_up(o, 16);
  L.table = o;
  if (place & kTableShared) o += 2u * D * S * 4;
  L.total = o;
  return L;
}

struct SlotSums {
  double *a0, *a1;
  int *f0, *f1, *nz0, *nz1;
};

__device__ __forceinline__ SlotSums slot_sums_at(unsigned char* base,
                                                 int NC) {
  double* d = reinterpret_cast<double*>(base);
  int* i = reinterpret_cast<int*>(d + 2 * NC);
  return SlotSums{d, d + NC, i, i + NC, i + 2 * NC, i + 3 * NC};
}

// A lane's count table and site sums, wherever they live: the count of mer
// id d, haplotype h at site s is cnt[(2d+h) * stride + s - toff], its sums
// sum0[s - soff], sum1[s - soff].
struct TableView {
  const float* cnt;
  const float* sum0;
  const float* sum1;
  int stride, toff, soff;
};

// Adds site s, whose mer id is `id`, to r if s is in [lo, hi) and the id
// in [0, D).
__device__ __forceinline__ void score_at(Score& r, int id, int s, int lo,
                                         int hi, const TableView& t, int D) {
  if (id < 0 || id >= D || s < lo || s >= hi) return;
  const float* c =
      t.cnt + static_cast<size_t>(2 * id) * t.stride + (s - t.toff);
  score_cells(r, c[0], c[t.stride], t.sum0[s - t.soff], t.sum1[s - t.soff]);
}

// A lane loads a candidate row's ids 16 bytes at once (16 int8 or 4 int32
// sites), from 16-byte aligned addresses: a row whose bytes are not a
// multiple of 16 starts and ends inside a chunk, whose sites outside the
// row fail the range test. A tile is the kTileChunks chunks of one warp.
constexpr int kChunk = 16, kTileChunks = 32;

__device__ __forceinline__ uint4 load_chunk(uintptr_t c) {
  return __ldg(reinterpret_cast<const uint4*>(c));
}

// The site of element 0 of the chunk at address c of a row that starts at
// `row` (negative for a chunk that starts before the row).
template <typename IdT>
__device__ __forceinline__ int chunk_site0(uintptr_t c, const IdT* row) {
  return static_cast<int>(
      (static_cast<long long>(c) -
       static_cast<long long>(reinterpret_cast<uintptr_t>(row))) /
      static_cast<long long>(sizeof(IdT)));
}

// Tiles of a row over the sites [lo, hi): its chunks from the one holding
// site lo (one more than the range's bytes fill, as the range need not
// start on a chunk boundary), kTileChunks a tile.
template <typename IdT>
__device__ __forceinline__ int tiles_per_row(int lo, int hi) {
  if (hi <= lo) return 0;
  const int chunks =
      ((hi - lo) * static_cast<int>(sizeof(IdT)) + kChunk - 1) / kChunk + 1;
  return (chunks + kTileChunks - 1) / kTileChunks;
}

// Warp-wide: adds the warp's partial sums r of slot k into the slots' sums
// (atomics: several warps may score tiles of one slot; the sums are exact,
// so their order does not matter).
__device__ __forceinline__ void flush_slot(const Score& r, const SlotSums& acc,
                                           int k) {
  const double a0 = warp_sum(r.a0), a1 = warp_sum(r.a1);
  const int f0 = warp_sum(r.f0), f1 = warp_sum(r.f1);
  const int z0 = warp_sum(r.nz0), z1 = warp_sum(r.nz1);
  if ((threadIdx.x & 31) == 0) {
    if (a0 != 0.0) atomicAdd(acc.a0 + k, a0);
    if (a1 != 0.0) atomicAdd(acc.a1 + k, a1);
    if (f0) atomicAdd(acc.f0 + k, f0);
    if (f1) atomicAdd(acc.f1 + k, f1);
    if (z0) atomicAdd(acc.nz0 + k, z0);
    if (z1) atomicAdd(acc.nz1 + k, z1);
  }
}

// Bit j set where element j of a chunk holds a non-negative id (16 bits
// for int8 ids, 4 for int32).
template <typename IdT>
__device__ __forceinline__ uint32_t present_mask(const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(IdT) == 1) {
      const uint32_t t = ~w[q] & 0x80808080u;  // the sign bits, inverted
      m |= (((t >> 7) | (t >> 14) | (t >> 21) | (t >> 28)) & 0xfu) << (4 * q);
    } else {
      m |= (static_cast<int32_t>(w[q]) >= 0 ? 1u : 0u) << q;
    }
  }
  return m;
}

// Element j of a chunk whose words are w0..w3.
template <typename IdT>
__device__ __forceinline__ int chunk_element(uint32_t w0, uint32_t w1,
                                             uint32_t w2, uint32_t w3,
                                             int j) {
  if constexpr (sizeof(IdT) == 1) {
    const uint32_t w = (j & 8) ? ((j & 4) ? w3 : w2) : ((j & 4) ? w1 : w0);
    return static_cast<int>(static_cast<int8_t>((w >> (8 * (j & 3))) & 0xffu));
  } else {
    const uint32_t w = (j & 2) ? ((j & 1) ? w3 : w2) : ((j & 1) ? w1 : w0);
    return static_cast<int>(w);
  }
}

// Warp-wide: scores the (slot, tile) pairs [p0, p1) of a lane whose NC
// candidate rows of S ids start at `rows`, T tiles a slot (pair p is tile
// p % T of slot p / T), into the slots' sums. Each lane loads its chunk of
// the next pair before it scores the current one, so that two loads are in
// flight. A read holds a mer at few sites, so the present ids of a tile
// are dealt out to the lanes 32 at a time (each lane finds the owner of
// its entry by a binary search over the lanes' running counts, then takes
// the element from the owner's chunk by shuffles): the table and sums are
// read, and the ratios taken, in full warps. With `bar` set, the first
// chunk's load is issued before the wait for the table's bulk copy.
template <typename IdT>
__device__ __forceinline__ void score_pairs(const IdT* rows, int S, int lo,
                                            int hi, int T, int p0, int p1,
                                            const TableView& tv, int D,
                                            const SlotSums& acc,
                                            uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  // this lane's chunk of tile j of slot k, or 0 when it lies past the range
  auto chunk_of = [&](int k, int j) -> uintptr_t {
    const IdT* row = rows + static_cast<size_t>(k) * S;
    const uintptr_t c =
        (reinterpret_cast<uintptr_t>(row + lo) & ~static_cast<uintptr_t>(15)) +
        static_cast<uintptr_t>(j * kTileChunks + lane) * kChunk;
    return c < reinterpret_cast<uintptr_t>(row + hi) ? c : 0;
  };
  int kn = p0 < p1 ? p0 / T : 0, jn = p0 - kn * T;  // the next pair's
  uintptr_t c_next = p0 < p1 ? chunk_of(kn, jn) : 0;
  uint4 v_next = c_next ? load_chunk(c_next) : make_uint4(0, 0, 0, 0);
  if (bar) mbar_wait(bar, 0);
  Score r{0.0, 0.0, 0, 0, 0, 0};
  int k = -1;
  for (int p = p0; p < p1; ++p) {
    const int kp = kn;  // this pair's slot
    const uintptr_t c = c_next;
    const uint4 v = v_next;
    if (++jn == T) {
      jn = 0;
      ++kn;
    }
    if (p + 1 < p1) {
      c_next = chunk_of(kn, jn);
      if (c_next) v_next = load_chunk(c_next);
    }
    if (kp != k) {
      if (k >= 0) flush_slot(r, acc, k);
      r = Score{0.0, 0.0, 0, 0, 0, 0};
      k = kp;
    }
    // this lane's present elements, and the running count over the lanes
    const uint32_t m = c ? present_mask<IdT>(v) : 0u;
    const int n = __popc(m);
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += x;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int excl = incl - n;
    const int s0 = c ? chunk_site0(c, rows + static_cast<size_t>(kp) * S) : 0;
    for (int base = 0; base < total; base += 32) {
      const int e = base + lane;  // the entry this lane scores
      int o = 0;                  // its owner: lanes whose count is <= e
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFull, incl, o + step - 1) <= e) o += step;
      const int oe = __shfl_sync(kFull, excl, o);
      const uint32_t om = __shfl_sync(kFull, m, o);
      const uint32_t w0 = __shfl_sync(kFull, v.x, o);
      const uint32_t w1 = __shfl_sync(kFull, v.y, o);
      const uint32_t w2 = __shfl_sync(kFull, v.z, o);
      const uint32_t w3 = __shfl_sync(kFull, v.w, o);
      const int os0 = __shfl_sync(kFull, s0, o);
      if (e < total) {
        const int j = static_cast<int>(__fns(om, 0, e - oe + 1));
        score_at(r, chunk_element<IdT>(w0, w1, w2, w3, j), os0 + j, lo, hi,
                 tv, D);
      }
    }
  }
  if (k >= 0) flush_slot(r, acc, k);
}

}  // namespace pomfret
