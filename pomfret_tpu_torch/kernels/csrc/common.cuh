// Device code shared by the greedy-loop kernels of this directory: warp and
// block reductions, the valid-site range and the scoring of one candidate
// row. Every kernel here runs blocks of kThreads threads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pomfret {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// Valid-site range of one lane (closed form of blockjoin.c:3669-3691),
// given each thread's partial first-blocked-right (fb) and
// last-blocked-left (lnb) sites; returned to every thread.
__device__ __forceinline__ void site_range(int fb, int lnb, int min0,
                                           int max0, int* red, int* min_i,
                                           int* max_i) {
  fb = block_min(fb, red);
  lnb = block_max(lnb, red);
  *max_i = fb > max0 ? fb - 1 : max0;
  *min_i = min0 < 0 ? min0 : (lnb == min0 ? min0 : (lnb >= 0 ? lnb + 1 : 0));
}

// One warp scores one candidate row over the sites [lo, hi): for each site
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

// Adds site s of a candidate whose mer id there is `id` to r.
__device__ __forceinline__ void score_site(Score& r, int id, int s,
                                           const float* cnt,
                                           const float* sum0,
                                           const float* sum1, int S, int D) {
  if (id < 0 || id >= D) return;
  score_cells(r, cnt[static_cast<size_t>(2 * id) * S + s],
              cnt[static_cast<size_t>(2 * id + 1) * S + s], sum0[s], sum1[s]);
}

template <typename IdT>
__device__ __forceinline__ Score warp_score(const IdT* __restrict__ row,
                                            const float* cnt,
                                            const float* sum0,
                                            const float* sum1, int lo,
                                            int hi, int S, int D) {
  Score r{0.0, 0.0, 0, 0, 0, 0};
  for (int s = lo + static_cast<int>(threadIdx.x & 31); s < hi; s += 32)
    score_site(r, static_cast<int>(row[s]), s, cnt, sum0, sum1, S, D);
  r.a0 = warp_sum(r.a0);
  r.a1 = warp_sum(r.a1);
  r.f0 = warp_sum(r.f0);
  r.f1 = warp_sum(r.f1);
  r.nz0 = warp_sum(r.nz0);
  r.nz1 = warp_sum(r.nz1);
  return r;
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

}  // namespace pomfret
