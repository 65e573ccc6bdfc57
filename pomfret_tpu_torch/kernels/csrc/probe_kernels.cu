// The Mosaic feasibility probes of tools/probe_*.py as Hopper kernels.
//
// The sixteen pallas_call sites under tools/ asked, on the TPU, whether the
// building blocks of a whole-loop kernel compile and give the right bits:
// an async copy of a row at a runtime row index into on-chip scratch, scalar
// and vector scratch moves, an in-kernel while loop, and a masked ratio sum
// over only the site tiles of a runtime range. Four kernels here answer the
// same questions on an H100 (pomfret_tpu_torch/kernels/probes.py holds the
// wrappers, the plain versions and the map from each probe to its kernel):
//
//  - row_copy_kernel (probe_dma.py:28, probe_dma2.py:34/48, probe_dma3.py:26,
//    probe_dma4.py:30/49, probe_dma5.py:24, probe_dma6.py:30,
//    probe_v3_parts.py:88): per lane, a bulk async copy (cp.async.bulk
//    completing on mbarriers) of W rows at a row read from device memory
//    into a shared stage, placement of the stage at the lane's slot of a
//    zero (NB, S) buffer, and an int32 sum per lane and over all lanes;
//  - lane_vec_kernel (probe_v3_parts.py:31/45/66/123): per-lane row minima
//    kept in shared memory and read back at a static or runtime index, or
//    moved by a shared-to-shared bulk copy into a second shared array
//    first; or a loop with a runtime trip count summing rows;
//  - v3_loop_kernel (probe_v3_feasibility.py:37): a loop in the kernel that
//    picks each lane's first eligible read, bulk-copies its row into slot
//    it % NC and accumulates the candidate buffer's sum;
//  - stile_kernel (probe_stile.py:27/45, probe_stile2.py:24): the masked
//    ratio sum sum_s [c0 > 0, lo <= s < hi] c0 / (7 + i 1e-6) over all S
//    sites or only the 256-site tiles between the batch's range bounds,
//    for n_iter iterations accumulated in f32.
//
// What bounds them on an H100: every probe shape is tiny (at most 512 KB
// moved, 0.8 M sites per iteration), so a launch costs its latency, a few
// microseconds against bounds well under one, and what a block does before
// its first useful byte (fills, barriers, a counter in global memory) adds
// to it. The 400 iterations of probe_stile2 make the one kernel whose time
// is its work, and three things bound it: the chain of iterations (each
// ends in a reduction whose result the next one's f32 sum waits for, a
// cost per iteration that no site count changes), the issue of the divides (one
// per kept site and iteration: 67 M in all, ~16 us at the MUFU unit's 16
// reciprocals a clock an SM; the reciprocal-and-FMA quotient takes no MUFU
// op), and the instructions per visited site (~18: two shared loads, the
// quotient, the tests, the f64 add), issued by one warp per sub-partition.
//
// All four are second designs (the first ones: one block per lane or per
// (b, k), zero-filled scratch, block-wide reductions and barriers). Every
// launch costs the launch floor first: the empty kernel below, at the same
// grid, block and cluster shape, ~1.7 us queued on an H100.
//
// Numerics: the integer sums are exact (wrapping as the plain versions'
// int32 sums do; lane_vec and v3_loop add in uint32, where wrapping is
// defined). The ratios are f32 IEEE quotients (-prec-div=true, no
// fast math, no FMA contraction), summed in f64 and rounded once to f32:
// every ratio c0 / (7 + i 1e-6) with small integer c0 is an f32 with the
// same few exponents, so the f64 sum is exact and the full-S and tiled-S
// results are equal bit for bit, whatever the order (which lets each warp
// sum in its own order; tests/test_torch_probes.py pins it on the plain
// version by permuting the sites).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

using namespace pomfret;

constexpr int kTile = 256;  // probe_stile.py's TS

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

// Lets `kernel` launch in clusters above the portable 8 blocks on the
// current device; like allow_optin, once per (kernel, device) through the
// bits of `done`. Returns a CUDA error code.
template <typename Kernel>
inline int allow_wide_clusters(Kernel* kernel,
                               std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return 0;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  done.fetch_or(bit, std::memory_order_release);
  return 0;
}

// ---------------------------------------------------------------------------
// K1: src (L,R,S) int8|int32; rows, slots (L,) int32; lane_sum (L,) int32;
// total (1,) int32; buf_out (L,NB,S) of the source type, or null. Lane l
// copies rows [rows[l], rows[l] + W) of src[l] into its stage when they lie
// inside [0, R) (else the stage is zero), places the stage at rows
// [slots[l], slots[l] + W) of a zero (NB, S) buffer when they lie inside
// [0, NB) (NB may be 0: no buffer), and sums its stage (sum_stage) or its
// buffer; total sums the lanes. The buffer is written back only when
// buf_out is given, to check placement: no probe returns it.
//
// One block per lane, all L blocks one thread block cluster (up to 8
// portably, 16 with the non-portable attribute). Besides 256 bytes of
// barriers and sums, only the stage lives in shared memory (W*S
// elements): a stage out of range is never read, so
// nothing is zero-filled, and the buffer is never built, since its sum is
// the stage's where the stage is placed and 0 elsewhere (with buf_out its
// rows are written straight from the stage or as zeros). Thread 0 issues
// the copy as `chunks` bulk copies of chunk_bytes (the last one shorter),
// each on its own mbarrier, and the threads sum each chunk (16 bytes a
// load; __dp4a for int8) as soon as it lands, while the next ones are in
// flight. The lane sums meet in block 0 through distributed shared
// memory: each block stores its sum into block 0's shared memory and
// arrives on block 0's mbarrier, then leaves (a cluster barrier arrived at
// on entry and waited on before that store orders block 0's barrier
// initialisation first), which costs less than two full cluster barriers
// around a read of every block's shared memory. So no state outlives a
// launch, and two launches in flight on two streams never share a
// counter.
constexpr int kCopyChunks = 4;

template <typename T>
__device__ __forceinline__ int sum_vec(const int4& v) {
  if constexpr (sizeof(T) == 1) {
    constexpr int kOnes = 0x01010101;  // the four signed bytes, summed
    return __dp4a(v.x, kOnes, __dp4a(v.y, kOnes, __dp4a(v.z, kOnes,
                                                        __dp4a(v.w, kOnes, 0))));
  } else {
    return v.x + v.y + v.z + v.w;
  }
}

// Dynamic shared memory of a block (no static part, which would leave the
// opt-in maximum of allow_optin out of reach): the chunks' barriers, the
// total's barrier, the warp sums and the lanes' sums (block 0's), then
// the stage at byte kRowCopyHead.
constexpr int kRowCopyHead = 256;
constexpr int kMaxClusterLanes = 16;

// The shared::cluster address of `p` (this block's shared memory) in the
// block of cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_copy_kernel(const T* __restrict__ src, const int32_t* __restrict__ rows,
                const int32_t* __restrict__ slots, T* __restrict__ buf_out,
                int32_t* __restrict__ lane_sum, int32_t* __restrict__ total,
                int R, int S, int W, int NB, int sum_stage, int chunks,
                int chunk_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // kCopyChunks
  uint64_t* done = bars + kCopyChunks;                 // block 0's
  int* red = reinterpret_cast<int*>(smem + 48);        // kWarps
  int* sums = red + kWarps;                            // block 0's, L
  unsigned char* stage = smem + kRowCopyHead;
  // the grid is one cluster along x: a block's index is its rank in it
  const int l = blockIdx.x, L = gridDim.x, tid = threadIdx.x;
  const int bytes = W * S * static_cast<int>(sizeof(T));

  // block 0's barrier takes one arrival from each block; the cluster
  // barrier, arrived at here and waited on before the first remote
  // arrival, orders its initialisation before them. The chunks' barriers
  // are initialised while the row index is on its way.
  if (tid == 0) {
    if (l == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(done)),
                   "r"(L)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int c = 0; c < chunks; ++c) mbar_init(bars + c);
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int row = rows[l], slot = slots[l];
  const bool copy = row >= 0 && row <= R - W;
  const bool place = slot >= 0 && slot <= NB - W;
  __syncthreads();  // the chunks' barriers before anyone waits on them

  int acc = 0;
  if (copy) {
    if (tid == 0) {
      const unsigned char* from = reinterpret_cast<const unsigned char*>(
          src + (static_cast<size_t>(l) * R + row) * S);
      for (int c = 0; c < chunks; ++c) {
        const int off = c * chunk_bytes;
        bulk_copy_g2s(stage + off, from + off,
                      static_cast<uint32_t>(min(chunk_bytes, bytes - off)),
                      bars + c);
      }
    }
    const bool summed = sum_stage || place;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(bars + c, 0);
      if (!summed) continue;
      const int off = c * chunk_bytes;
      const int4* v = reinterpret_cast<const int4*>(stage + off);
      const int nv = min(chunk_bytes, bytes - off) / 16;
      for (int i = tid; i < nv; i += kThreads) acc += sum_vec<T>(v[i]);
    }
  }
  if (buf_out != nullptr) {
    // rows [slot, slot + W) from the stage where it is placed, zeros
    // elsewhere; 16 bytes a store (S * sizeof(T) is a multiple of 16)
    const int row_vecs = S * static_cast<int>(sizeof(T)) / 16;
    const int n = NB * row_vecs;
    const int p0 = copy && place ? slot * row_vecs : n;
    const int p1 = copy && place ? p0 + bytes / 16 : n;
    const int4* v = reinterpret_cast<const int4*>(stage);
    int4* out = reinterpret_cast<int4*>(buf_out + static_cast<size_t>(l) * NB * S);
    for (int i = tid; i < n; i += kThreads)
      out[i] = (i >= p0 && i < p1) ? v[i - p0] : make_int4(0, 0, 0, 0);
  }

  acc = warp_sum(acc);
  if ((tid & 31) == 0) red[tid >> 5] = acc;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid != 0) return;
  int s = 0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  lane_sum[l] = s;
  // this lane's sum into block 0's sums[l], then one arrival on its
  // barrier (release: the store is seen by whoever sees the arrival);
  // every block but 0 is then done and leaves
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(
                   cluster_addr(sums + l, 0)),
               "r"(s)
               : "memory");
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          cluster_addr(done, 0))
      : "memory");
  if (l != 0) return;
  uint32_t ready = 0;
  while (!ready) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(ready)
        : "r"(smem_u32(done))
        : "memory");
  }
  int t = 0;
  for (int j = 0; j < L; ++j) t += sums[j];
  *total = t;
}

// ---------------------------------------------------------------------------
// K2: hp (L,Rh) int32, out (L,) int32; one block of L warps, warp w owns
// lane w. mode 0 store2d: out[w] = min_q hp[w,q], through shared memory;
// 1 sload / 2 sload_dyn: v[w] = min_q hp[w,q] + w in shared memory, out[w] =
// sum_l v[idx(l)] with idx(l) = l (1) or (l + dyn) mod L (2), a runtime
// index; 3 smem_dma: the same v, moved into a second shared array by a bulk
// copy first and summed from there; 4 whileloop: out[w] = n_iter * sum_q
// hp[w,q], a loop whose trip count is a runtime argument. Sums in uint32:
// they wrap as the plain version's int32 sums do.
//
// A mode does only the synchronisation it needs: store2d and whileloop
// stay inside their warp (no block barrier), the others wait at one block
// barrier for the lane vector and then sum it in one warp reduction, lane
// j of every warp reading element idx(j). whileloop loads its row once and
// adds each lane's part n_iter times in registers. smem_dma's copy is the
// counterpart of the TPU probe's VMEM -> SMEM DMA: a shared-to-shared
// cp.async.bulk on an mbarrier, which needs a cluster launch (of one block
// here; outside one it stops with an illegal instruction): no byte leaves
// the SM and no scratch is needed, in the time a round trip through global
// memory takes.
constexpr int kMaxVecLanes = 32;
enum LaneVecMode { kStore2d, kSload, kSloadDyn, kSmemDma, kWhileLoop };
// A lane's loads of a row, issued kVecLoads at a time: a loop over them
// with a runtime trip count issues one load a latency, the next one behind
// the use of the last (two of them a lane at the probes' Rh = 64).
constexpr int kVecLoads = 4;

// op folded over a lane's values row[q], q = lane + 32 i < Rh, from `pad`
// (which also stands in for the values past Rh).
template <typename Op>
__device__ __forceinline__ int32_t fold_row(const int32_t* row, int Rh,
                                            int lane, int32_t pad, Op op) {
  int32_t acc = pad;
  for (int q0 = 0; q0 < Rh; q0 += 32 * kVecLoads) {
    int32_t v[kVecLoads];
#pragma unroll
    for (int u = 0; u < kVecLoads; ++u) {
      const int q = q0 + 32 * u + lane;
      v[u] = q < Rh ? row[q] : pad;
    }
#pragma unroll
    for (int u = 0; u < kVecLoads; ++u) acc = op(acc, v[u]);
  }
  return acc;
}

// Warp-wide sum (wrapping) and minimum in one redux.sync each, where five
// dependent shuffles would take five shuffle latencies.
__device__ __forceinline__ uint32_t warp_sum_u32(uint32_t v) {
  return __reduce_add_sync(kFull, v);
}

// A bulk copy of `bytes` between two arrays of this block's shared memory,
// completing on `bar` (in a cluster launch, even of one block).
__device__ __forceinline__ void bulk_copy_s2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  mbar_arrive_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "r"(smem_u32(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__global__ void lane_vec_kernel(const int32_t* __restrict__ hp,
                                int32_t* __restrict__ out, int L, int Rh,
                                int mode, int n_iter, int dyn) {
  __shared__ __align__(16) int32_t vec[kMaxVecLanes];
  __shared__ __align__(16) int32_t vec2[kMaxVecLanes];
  __shared__ __align__(8) uint64_t bar;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t* row = hp + static_cast<size_t>(w) * Rh;
  // what needs no input goes first, under the row's loads: smem_dma's
  // barrier, and the element idx(lane) that the lane sums
  if (mode == kSmemDma && threadIdx.x == 0) mbar_init(&bar);
  int j = lane;
  if (mode == kSloadDyn && lane < L) {  // (lane + dyn) mod L, in 32 bits
    const int d = dyn % L;
    j += d < 0 ? d + L : d;
    if (j >= L) j -= L;
  }

  if (mode == kWhileLoop) {
    const uint32_t part = static_cast<uint32_t>(
        fold_row(row, Rh, lane, 0, [](int32_t a, int32_t b) {
          return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                      static_cast<uint32_t>(b));
        }));
    uint32_t acc = 0;
    int it = 0;
#pragma unroll 1
    while (it < n_iter) {
      acc += part;
      // one add an iteration: kept a loop, not folded into a multiply
      asm volatile("" : "+r"(acc));
      ++it;
    }
    acc = warp_sum_u32(acc);
    if (lane == 0) out[w] = static_cast<int32_t>(acc);
    return;
  }
  const int m = __reduce_min_sync(
      kFull, fold_row(row, Rh, lane, INT32_MAX,
                      [](int32_t a, int32_t b) { return min(a, b); }));
  if (mode == kStore2d) {
    if (lane == 0) vec[w] = m;
    __syncwarp();
    if (lane == 0) out[w] = vec[w];
    return;
  }
  if (lane == 0)
    vec[w] = static_cast<int32_t>(static_cast<uint32_t>(m) +
                                  static_cast<uint32_t>(w));
  const int32_t* from = vec;
  if (mode == kSmemDma) {
    fence_proxy_async();  // the lane vector's writes before the copy reads it
    __syncthreads();
    if (threadIdx.x == 0)
      bulk_copy_s2s(vec2, vec, static_cast<uint32_t>(L * sizeof(int32_t)),
                    &bar);
    mbar_wait(&bar, 0);
    from = vec2;
  } else {
    __syncthreads();
  }
  uint32_t v = lane < L ? static_cast<uint32_t>(from[j]) : 0u;
  v = warp_sum_u32(v);
  if (lane == 0) out[w] = static_cast<int32_t>(v);
}

// ---------------------------------------------------------------------------
// K3: ids (L,R,S) int32, hp (L,R) int32, out (L,) int32. n_iter iterations
// per lane: r = the first q with hp[q] == 2 and q >= 2 it (else R - 1); row
// ids[l, r] into slot it % NC of an (NC, S) candidate buffer that starts
// at zero; acc += the buffer's sum. Sums in uint32, wrapping as the plain
// version's int32 sums do.
//
// The loop kernel's candidate upkeep in miniature (its warp 0 picks a
// read, bulk-copies its row into a slot and sums it), one warp per lane,
// up to wpb lanes a block, each warp on its own: its mbarrier, its NC slot
// sums, the ballot words of its eligible reads and its (NC, S) slot rows
// in shared memory, and no block barrier. The eligible reads are found
// once, as one ballot word per 32 reads; each iteration's pick is then the
// first set bit at or after 2 it among the words (a ballot over the words
// left, two find-first-sets and a shuffle). The row is copied straight
// into its slot: the warp's reads of that slot's previous row are ordered
// before the async write (fence.proxy.async, __syncwarp), lane 0 issues
// cp.async.bulk of S int32 on the warp's mbarrier and the warp waits on
// the iteration's parity (kBulk); or the warp copies it with its own
// 16-byte loads (kBulk false, for timing against it). The warp sums the
// row (16-byte shared loads, or the loaded registers, and a warp sum) and
// lane 0 keeps the total as total += new - slot_sum[k]: nothing is
// zero-filled, since a slot never written adds 0, and only the row that
// changed is summed. Each iteration's pick, copy, wait and sum complete
// before the next one starts (the loop kernel's next pick waits on the
// decisions its sums make), so the loop's time per iteration is the
// latency of that chain.
//
// Dynamic shared memory of a block (kernels/probes.py v3_loop_plan): wpb
// mbarriers (8 bytes each), then wpb x NC slot sums and wpb x nw ballot
// words (4 bytes each, nw = ceil(R / 32)), then from the next 16-byte
// boundary wpb x NC slot rows of S int32.
constexpr int kV3MaxWarps = 32;
constexpr int kRowLoads = 8;

__host__ __device__ inline size_t v3_head_bytes(int wpb, int NC, int R) {
  const int nw = (R + 31) / 32;
  return align_up(8u * wpb + 4u * wpb * (NC + nw), 16u);
}

__host__ __device__ inline size_t v3_smem_bytes(int wpb, int NC, int S,
                                                int R) {
  return v3_head_bytes(wpb, NC, R) + static_cast<size_t>(wpb) * NC * S * 4;
}

__device__ __forceinline__ uint32_t sum4(const int4& v) {
  return static_cast<uint32_t>(v.x) + static_cast<uint32_t>(v.y) +
         static_cast<uint32_t>(v.z) + static_cast<uint32_t>(v.w);
}

// The first read q >= t (t <= R) whose bit is set in the nw ballot words
// `words`, or R - 1 when there is none; warp-uniform.
__device__ __forceinline__ int v3_pick(const uint32_t* words, int nw, int t,
                                       int R, int lane) {
  const int tw = t >> 5;
  for (int c = tw; c < nw; c += 32) {
    const int j = c + lane;
    uint32_t m = j < nw ? words[j] : 0u;
    if (j == tw) m &= ~0u << (t & 31);
    const uint32_t b = __ballot_sync(kFull, m != 0u);
    if (b) {
      const int f = __ffs(b) - 1;
      return 32 * (c + f) + __ffs(__shfl_sync(kFull, m, f)) - 1;
    }
  }
  return R - 1;
}

template <bool kBulk>
__global__ void v3_loop_kernel(const int32_t* __restrict__ ids,
                               const int32_t* __restrict__ hp,
                               int32_t* __restrict__ out, int L, int R, int S,
                               int NC, int n_iter) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int wpb = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = blockIdx.x * wpb + w;
  if (l >= L) return;  // a whole warp; no block barrier follows
  const int nw = (R + 31) / 32;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + w;
  uint32_t* slot_sum =
      reinterpret_cast<uint32_t*>(smem + 8 * wpb) + static_cast<size_t>(w) * NC;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + 8 * wpb) +
                    static_cast<size_t>(wpb) * NC + static_cast<size_t>(w) * nw;
  int32_t* rows = reinterpret_cast<int32_t*>(smem + v3_head_bytes(wpb, NC, R)) +
                  static_cast<size_t>(w) * NC * S;
  const int32_t* lane_hp = hp + static_cast<size_t>(l) * R;
  const int32_t* lane_ids = ids + static_cast<size_t>(l) * R * S;

  if (kBulk && lane == 0) mbar_init(bar);
  if (lane == 0)
    for (int k = 0; k < NC; ++k) slot_sum[k] = 0u;
  for (int c0 = 0; c0 < nw; c0 += kVecLoads) {  // loads issued together
    bool e[kVecLoads];
#pragma unroll
    for (int u = 0; u < kVecLoads; ++u) {
      const int q = 32 * (c0 + u) + lane;
      e[u] = q < R && lane_hp[q] == 2;
    }
#pragma unroll
    for (int u = 0; u < kVecLoads; ++u) {
      const uint32_t b = __ballot_sync(kFull, e[u]);
      if (lane == 0 && c0 + u < nw) words[c0 + u] = b;
    }
  }
  __syncwarp();

  const int nv = S / 4;  // 16-byte vectors a row
  uint32_t total = 0, acc = 0;
  for (int it = 0, k = 0; it < n_iter; ++it, k = k + 1 < NC ? k + 1 : 0) {
    const int t = it < (R + 1) / 2 ? 2 * it : R;
    const int r = v3_pick(words, nw, t, R, lane);  // k = it % NC
    int4* dst = reinterpret_cast<int4*>(rows + static_cast<size_t>(k) * S);
    const int4* src =
        reinterpret_cast<const int4*>(lane_ids + static_cast<size_t>(r) * S);
    uint32_t part = 0;
    if (kBulk) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0)
        bulk_copy_g2s(dst, src, static_cast<uint32_t>(S * sizeof(int32_t)),
                      bar);
      mbar_wait(bar, it & 1);
    }
    // kRowLoads 16-byte loads a lane at a time, issued together (S = 1536:
    // 384 vectors, 12 a lane)
    for (int i0 = 0; i0 < nv; i0 += 32 * kRowLoads) {
      int4 v[kRowLoads];
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int i = i0 + 32 * u + lane;
        v[u] = i < nv ? (kBulk ? dst[i] : src[i]) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int i = i0 + 32 * u + lane;
        if (!kBulk && i < nv) dst[i] = v[u];
        part += sum4(v[u]);
      }
    }
    uint32_t row_sum = warp_sum_u32(part);
    // the next pick starts after this sum, as the loop kernel's waits on
    // its decisions: no load of the next iteration moves above it
    asm volatile("" : "+r"(row_sum) : : "memory");
    if (lane == 0) {
      total += row_sum - slot_sum[k];
      slot_sum[k] = row_sum;
      acc += total;
    }
  }
  if (lane == 0) out[l] = static_cast<int32_t>(acc);
}

// ---------------------------------------------------------------------------
// K4: cnt (B,2D,S) f32, cids (B,NC,S) int32, ranges (B,2) int32 [lo, hi),
// out (B,NC) f32. c0[s] = cnt[b, 2 cids[b,k,s], s] where 0 <= cids < D,
// else 0. For i < n_iter: score_i = the f64 sum of the f32 ratios
// c0 / (7 + f32(i) 1e-6) over the sites with c0 > 0 and lo <= s < hi,
// rounded once to f32; out = the f32 sum of the scores in iteration order.
// tiled: only the sites of the 256-wide tiles from floor(min lo / 256) to
// ceil(max hi / 256) over the whole batch.
//
// One warp per (b, k), up to kStileWarps k's of one b per block (16 k's:
// 128 blocks for 132 SMs, one warp on each SM sub-partition). Each block
// stages its sites [s0, s1) once: the D even count planes of its b and
// the id rows of its k's, by bulk copies on one mbarrier when every row
// is 16-byte aligned (S % 4 == 0), else by plain loads. Each iteration
// then gathers c0 from the staged planes at the staged ids (the loop
// kernel's table changes after every commit, so nothing is kept from one
// iteration to the next), 16 sites a lane at a time in straight-line
// code (stile_sites), with an accumulator each (the f64 sum is exact, so
// any order gives the same bits), and ends in a warp's shuffles: no block
// barrier inside the iteration loop. A lone warp on its sub-partition
// hides no latency with another warp's work, so the sites of a lane are
// what overlaps. The iterations of a (b, k) stay in
// order. The quotient is __fdiv_rn (kRcp false), or c0 times the
// iteration's correctly rounded reciprocal with one FMA correction (kRcp
// true), which is the IEEE quotient wherever c0 and the quotient are
// normal (the CPU tests emulate it exactly and the card tests run it, for
// every integer c0 in [1, 2^16] against all 400 divisors and for random
// normal c0); a block whose staged counts leave that range takes
// __fdiv_rn throughout.
constexpr int kStileWarps = 4;

// Dynamic shared memory of one block: the mbarrier (128 bytes), then D
// count planes, a plane of zeros (where an id outside [0, D) reads its
// count) and kpb id rows, of align_up(S, 4) elements each, site s0 at
// element 0 (so the size does not depend on the ranges).
__host__ __device__ inline size_t stile_smem_bytes(int S, int D, int kpb) {
  return 128 + static_cast<size_t>(D + 1 + kpb) * align_up(S, 4) * 4;
}

// c0 / div by the reciprocal rdiv = __frcp_rn(div) and one FMA
// correction: rounded to nearest even where stile_rcp_exact(c0) and div
// lies in [1, 2^12] (c0 and the quotient normal).
__device__ __forceinline__ float stile_rcp_quotient(float c0, float div,
                                                    float rdiv) {
  const float q = __fmul_rn(c0, rdiv);
  const float e = __fmaf_rn(-q, div, c0);  // the remainder, rounded once
  return __fmaf_rn(e, rdiv, q);
}

__device__ __forceinline__ bool stile_rcp_exact(float c0) {
  return c0 >= 0x1p-100f && c0 <= 0x1p100f;
}

// c0 / div rounded to nearest even, as stile_kernel<kRcp> takes it.
template <bool kRcp>
__device__ __forceinline__ float stile_ratio(float c0, float div,
                                             float rdiv) {
  if (kRcp && stile_rcp_exact(c0)) return stile_rcp_quotient(c0, div, rdiv);
  return __fdiv_rn(c0, div);
}

__device__ __forceinline__ float stile_divisor(int i) {
  return __fadd_rn(7.f, __fmul_rn(static_cast<float>(i), 1e-6f));
}

// Warp-wide: the U sites base + lane + 32 u of a lane (kTail: some past
// n) added to its sums p[u], the quotient by reciprocal and FMA (kRcp) or
// __fdiv_rn. With kRcp the code is straight-line, so that all the sites'
// loads and quotients are in flight at once: every id read first, then
// every count (an id outside [0, D), or a site past n, reads the zero
// plane), then the quotients, and the kept ones (c0 > 0, lo <= s < hi:
// (s - lo) below hi - lo, as unsigned) added; a site not kept adds 0.
template <int U, bool kRcp, bool kTail>
__device__ __forceinline__ void stile_sites(const int32_t* my,
                                            const float* planes, int Sp,
                                            int D, int n, int base,
                                            unsigned rel, unsigned width,
                                            float div, float rdiv,
                                            double* p) {
  const int lane = threadIdx.x & 31;
  int i[U], d[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    i[u] = base + lane + 32 * u;
    if (kTail && i[u] >= n) i[u] = n - 1;
    d[u] = static_cast<int>(
        min(static_cast<unsigned>(my[i[u]]), static_cast<unsigned>(D)));
    if (kTail && base + lane + 32 * u >= n) d[u] = D;
  }
  float c0[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    c0[u] = planes[static_cast<size_t>(d[u]) * Sp + i[u]];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool keep = c0[u] > 0.f && rel + 32u * u + lane < width;
    if (kRcp) {
      // the f64 of the quotient (normal and positive, or not kept: 0)
      // built on the integer units: F2F.F64.F32 issues at a quarter rate
      const uint32_t bq = __float_as_uint(stile_rcp_quotient(c0[u], div, rdiv));
      const int hi = keep ? static_cast<int>((bq >> 3) + 0x38000000u) : 0;
      const int lo = keep ? static_cast<int>(bq << 29) : 0;
      p[u] += __hiloint2double(hi, lo);
    } else if (keep) {
      p[u] += static_cast<double>(__fdiv_rn(c0[u], div));
    }
  }
}

// Warp-wide: n_iter iterations of the ratio sum over the staged sites
// [0, n) of one (b, k); each iteration's f64 sum is rounded to f32 and
// added to the result in order. Sites go 16 to a lane at a time, then 4.
template <bool kRcp>
__device__ __forceinline__ float stile_iterations(const int32_t* my,
                                                  const float* planes,
                                                  int Sp, int D, int n,
                                                  unsigned rel0,
                                                  unsigned width,
                                                  int n_iter) {
  constexpr int kBig = 16, kSmall = 4;
  float acc = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    const float div = stile_divisor(it);
    const float rdiv = kRcp ? __frcp_rn(div) : 0.f;
    double p[kBig];
#pragma unroll
    for (int u = 0; u < kBig; ++u) p[u] = 0.0;
    int base = 0;
    for (; base + 32 * kBig <= n; base += 32 * kBig)
      stile_sites<kBig, kRcp, false>(my, planes, Sp, D, n, base, rel0 + base,
                                     width, div, rdiv, p);
    for (; base + 32 * kSmall <= n; base += 32 * kSmall)
      stile_sites<kSmall, kRcp, false>(my, planes, Sp, D, n, base,
                                       rel0 + base, width, div, rdiv, p);
    if (base < n)
      stile_sites<kSmall, kRcp, true>(my, planes, Sp, D, n, base, rel0 + base,
                                      width, div, rdiv, p);
    // a tree, not a chain (written out: a loop over the levels puts p on
    // the stack)
    const double s0 = (p[0] + p[1]) + (p[2] + p[3]);
    const double s1 = (p[4] + p[5]) + (p[6] + p[7]);
    const double s2 = (p[8] + p[9]) + (p[10] + p[11]);
    const double s3 = (p[12] + p[13]) + (p[14] + p[15]);
    acc = __fadd_rn(acc, __double2float_rn(warp_sum((s0 + s1) + (s2 + s3))));
  }
  return acc;
}

template <bool kRcp>
__global__ void __launch_bounds__(kStileWarps * 32)
stile_kernel(const float* __restrict__ cnt, const int32_t* __restrict__ cids,
             const int32_t* __restrict__ ranges, float* __restrict__ out,
             int B, int NC, int S, int D, int tiled, int n_iter, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int Sp = static_cast<int>(align_up(S, 4));
  float* planes = reinterpret_cast<float*>(smem + 128);
  int32_t* ids =
      reinterpret_cast<int32_t*>(planes + static_cast<size_t>(D + 1) * Sp);
  const int kpb = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, k0 = blockIdx.x * kpb;
  const int nk = min(kpb, NC - k0);

  // the staged sites, computed alike by every warp (no barrier)
  int s0 = 0, s1 = S;
  if (tiled) {
    int mn = INT32_MAX, mx = INT32_MIN;
    for (int j = lane; j < B; j += 32) {
      mn = min(mn, ranges[2 * j]);
      mx = max(mx, ranges[2 * j + 1]);
    }
    mn = warp_min(mn);
    mx = warp_max(mx);
    s0 = static_cast<int>(max(floor_div(mn, kTile), 0ll) * kTile);
    s1 = static_cast<int>(
        min(floor_div(static_cast<long long>(mx) + kTile - 1, kTile) * kTile,
            static_cast<long long>(S)));
  }
  const int n = s1 > s0 ? s1 - s0 : 0;
  if (n == 0) {
    if (w < nk && lane == 0) out[static_cast<size_t>(b) * NC + k0 + w] = 0.f;
    return;
  }
  const float* cb = cnt + static_cast<size_t>(b) * 2 * D * S + s0;
  const int32_t* crow = cids + (static_cast<size_t>(b) * NC + k0) * S + s0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    planes[static_cast<size_t>(D) * Sp + i] = 0.f;
  if (bulk) {
    const uint32_t row_bytes = static_cast<uint32_t>(n) * 4;
    if (threadIdx.x == 0) mbar_init(bar);
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar, row_bytes * (D + nk));
      for (int d = 0; d < D; ++d)
        bulk_g2s(planes + static_cast<size_t>(d) * Sp,
                 cb + static_cast<size_t>(2 * d) * S, row_bytes, bar);
      for (int j = 0; j < nk; ++j)
        bulk_g2s(ids + static_cast<size_t>(j) * Sp,
                 crow + static_cast<size_t>(j) * S, row_bytes, bar);
    }
    mbar_wait(bar, 0);
  } else {
    for (int d = 0; d < D; ++d)
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        planes[static_cast<size_t>(d) * Sp + i] =
            cb[static_cast<size_t>(2 * d) * S + i];
    for (int j = 0; j < nk; ++j)
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        ids[static_cast<size_t>(j) * Sp + i] = crow[static_cast<size_t>(j) * S + i];
  }
  // the reciprocal's quotient is exact for every count the block may keep
  // (those of the sites in [lo, hi); always so for counts), or every
  // quotient is by __fdiv_rn
  const int lo = ranges[2 * b], hi = ranges[2 * b + 1];
  int inexact = 0;
  if (kRcp) {
    const int i0 =
        static_cast<int>(max(static_cast<long long>(lo) - s0, 0ll));
    const int i1 = static_cast<int>(
        min(static_cast<long long>(hi) - s0, static_cast<long long>(n)));
    for (int d = 0; d < D; ++d)
      for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
        const float c = planes[static_cast<size_t>(d) * Sp + i];
        inexact |= c > 0.f && !stile_rcp_exact(c);
      }
  }
  inexact = __syncthreads_or(inexact);
  if (w >= nk) return;

  // s in [lo, hi) <=> (s - lo) < (hi - lo) in 32-bit unsigned arithmetic
  const unsigned width =
      hi > lo ? static_cast<unsigned>(hi) - static_cast<unsigned>(lo) : 0u;
  const unsigned rel0 = static_cast<unsigned>(s0) - static_cast<unsigned>(lo);
  const int32_t* my = ids + static_cast<size_t>(w) * Sp;
  const float acc =
      kRcp && !inexact
          ? stile_iterations<true>(my, planes, Sp, D, n, rel0, width, n_iter)
          : stile_iterations<false>(my, planes, Sp, D, n, rel0, width, n_iter);
  if (lane == 0) out[static_cast<size_t>(b) * NC + k0 + w] = acc;
}

// out (n_iter, n) f32: stile_kernel's quotient of each c0 (n) by each
// iteration's divisor; the check of its division, not a probe.
template <bool kRcp>
__global__ void stile_ratio_kernel(const float* __restrict__ c0,
                                   float* __restrict__ out, int n,
                                   int n_iter) {
  const size_t total = static_cast<size_t>(n) * n_iter;
  for (size_t x = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       x < total; x += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float div = stile_divisor(static_cast<int>(x / n));
    out[x] = stile_ratio<kRcp>(c0[x % n], div, kRcp ? __frcp_rn(div) : 0.f);
  }
}

// The launch floor: a kernel that does nothing. Launched at a probe's grid,
// block and cluster shape, its device time is what a launch of that shape
// costs before any work, the floor under that probe's time.
__global__ void empty_kernel() {}

template <typename T>
int launch_row_copy(const void* src, const void* rows, const void* slots,
                    void* buf, void* lane_sum, void* total, int L, int R,
                    int S, int W, int NB, int sum_stage, int chunks,
                    int chunk_bytes, int threads, cudaStream_t st) {
  static std::atomic<unsigned long long> optin{0}, wide{0};
  int rc = allow_optin(row_copy_kernel<T>, optin);
  if (rc == 0 && L > 8) rc = allow_wide_clusters(row_copy_kernel<T>, wide);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = kRowCopyHead + static_cast<size_t>(W) * S * sizeof(T);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, row_copy_kernel<T>, static_cast<const T*>(src),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(slots),
      static_cast<T*>(buf), static_cast<int32_t*>(lane_sum),
      static_cast<int32_t*>(total), R, S, W, NB, sum_stage, chunks,
      chunk_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRcp>
int launch_stile(const void* cnt, const void* cids, const void* ranges,
                 void* out, int B, int NC, int S, int D, int tiled,
                 int n_iter, int kpb, cudaStream_t st) {
  static std::atomic<unsigned long long> optin{0};
  const int rc = allow_optin(stile_kernel<kRcp>, optin);
  if (rc != 0) return rc;
  const int bulk = S % 4 == 0 && reinterpret_cast<uintptr_t>(cnt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cids) % 16 == 0;
  stile_kernel<kRcp><<<dim3((NC + kpb - 1) / kpb, B), 32 * kpb,
                       stile_smem_bytes(S, D, kpb), st>>>(
      static_cast<const float*>(cnt), static_cast<const int32_t*>(cids),
      static_cast<const int32_t*>(ranges), static_cast<float*>(out), B, NC, S,
      D, tiled, n_iter, bulk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher launches on `stream` and returns cudaGetLastError() (0 on
// success); the wrappers check shapes, alignment and the shared-memory size.
// row_copy and lane_vec launch at the threads a block and cluster size
// that their wrappers pass (kernels/probes.py row_copy_shape,
// lane_vec_shape, which the launch floor is timed at too), and refuse any
// shape their kernel is not written for.
// row_copy: 1 <= L <= 16 lanes (one cluster of L blocks of kThreads); the
// copy in `chunks` (1 to kCopyChunks) pieces of chunk_bytes (a multiple of
// 16) covering W*S elements (kernels/probes.py row_copy_plan).
extern "C" int pomfret_probe_row_copy_launch(int elt_bytes, const void* src,
                                             const void* rows,
                                             const void* slots, void* buf,
                                             void* lane_sum, void* total,
                                             int L, int R, int S, int W,
                                             int NB, int sum_stage,
                                             int chunks, int chunk_bytes,
                                             int threads, int cluster,
                                             void* stream) {
  const long long bytes = static_cast<long long>(W) * S * elt_bytes;
  if (L < 1 || L > kMaxClusterLanes || threads != kThreads || cluster != L ||
      chunks < 1 || chunks > kCopyChunks ||
      chunk_bytes <= 0 || chunk_bytes % 16 ||
      static_cast<long long>(chunks) * chunk_bytes < bytes ||
      static_cast<long long>(chunks - 1) * chunk_bytes >= bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elt_bytes == 1)
    return launch_row_copy<int8_t>(src, rows, slots, buf, lane_sum, total, L,
                                   R, S, W, NB, sum_stage, chunks,
                                   chunk_bytes, threads, st);
  if (elt_bytes == 4)
    return launch_row_copy<int32_t>(src, rows, slots, buf, lane_sum, total, L,
                                    R, S, W, NB, sum_stage, chunks,
                                    chunk_bytes, threads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// lane_vec: one block of a warp a lane (threads 32 L), a cluster of one
// block (cluster 1) or none (0); smem_dma needs the cluster and L % 4 == 0.
extern "C" int pomfret_probe_lane_vec_launch(const void* hp, void* out,
                                             int L, int Rh, int mode,
                                             int n_iter, int dyn, int threads,
                                             int cluster, void* stream) {
  if (L <= 0 || L > kMaxVecLanes || mode < kStore2d || mode > kWhileLoop ||
      threads != 32 * L || cluster < 0 || cluster > 1 ||
      (mode == kSmemDma && (L % 4 || cluster != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, lane_vec_kernel, static_cast<const int32_t*>(hp),
      static_cast<int32_t*>(out), L, Rh, mode, n_iter, dyn);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// v3_loop: wpb (1 to kV3MaxWarps) lanes a block (kernels/probes.py
// v3_loop_plan); S a positive multiple of 4 (16-byte rows); bulk 1 copies
// each row by cp.async.bulk, 0 by the warp's own loads. The shared-memory
// opt-in is set once per (kernel, device), and only for a block above the
// 48 KB that every launch may take.
template <bool kBulk>
int launch_v3_loop(const void* ids, const void* hp, void* out, int L, int R,
                   int S, int NC, int n_iter, int wpb, cudaStream_t st) {
  static std::atomic<unsigned long long> optin{0};
  const size_t shm = v3_smem_bytes(wpb, NC, S, R);
  if (shm > 48 * 1024) {
    const int rc = allow_optin(v3_loop_kernel<kBulk>, optin);
    if (rc != 0) return rc;
  }
  v3_loop_kernel<kBulk><<<(L + wpb - 1) / wpb, 32 * wpb, shm, st>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(hp),
      static_cast<int32_t*>(out), L, R, S, NC, n_iter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pomfret_probe_v3_loop_launch(const void* ids, const void* hp,
                                            void* out, int L, int R, int S,
                                            int NC, int n_iter, int wpb,
                                            int bulk, void* stream) {
  if (L <= 0) return 0;
  if (R < 1 || S < 4 || S % 4 || NC < 1 || n_iter < 0 || wpb < 1 ||
      wpb > kV3MaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bulk ? launch_v3_loop<true>(ids, hp, out, L, R, S, NC, n_iter, wpb,
                                     st)
              : launch_v3_loop<false>(ids, hp, out, L, R, S, NC, n_iter, wpb,
                                      st);
}

// The empty kernel on a (grid_x, grid_y) grid of `block` threads, in
// clusters of `cluster` blocks along x (0: a launch without clusters; up
// to kMaxClusterLanes, dividing grid_x).
extern "C" int pomfret_probe_empty_launch(int grid_x, int grid_y, int block,
                                          int cluster, void* stream) {
  if (grid_x < 1 || grid_y < 1 || block < 1 || cluster < 0 ||
      cluster > kMaxClusterLanes || (cluster > 0 && grid_x % cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> wide{0};
  if (cluster > 8) {
    const int rc = allow_wide_clusters(empty_kernel, wide);
    if (rc != 0) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, grid_y);
  cfg.blockDim = dim3(block);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// stile: kpb (1 to kStileWarps) k's a block (kernels/probes.py
// stile_plan); rcp 1 for the reciprocal-and-FMA quotient, 0 for __fdiv_rn.
extern "C" int pomfret_probe_stile_launch(const void* cnt, const void* cids,
                                          const void* ranges, void* out,
                                          int B, int NC, int S, int D,
                                          int tiled, int n_iter, int kpb,
                                          int rcp, void* stream) {
  if (B <= 0 || NC <= 0) return 0;
  if (kpb < 1 || kpb > kStileWarps || D < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rcp ? launch_stile<true>(cnt, cids, ranges, out, B, NC, S, D, tiled,
                                  n_iter, kpb, st)
             : launch_stile<false>(cnt, cids, ranges, out, B, NC, S, D, tiled,
                                   n_iter, kpb, st);
}

extern "C" int pomfret_probe_stile_ratio_launch(const void* c0, void* out,
                                                int n, int n_iter, int rcp,
                                                void* stream) {
  if (n <= 0 || n_iter <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(c0);
  float* o = static_cast<float*>(out);
  if (rcp)
    stile_ratio_kernel<true><<<1024, 256, 0, st>>>(in, o, n, n_iter);
  else
    stile_ratio_kernel<false><<<1024, 256, 0, st>>>(in, o, n, n_iter);
  return static_cast<int>(cudaGetLastError());
}
