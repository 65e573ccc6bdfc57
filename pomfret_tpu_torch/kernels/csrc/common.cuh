// Device code shared by the greedy-loop kernels of this directory: warp and
// block reductions, the valid-site range and the scoring of one candidate
// row. Every kernel here runs blocks of kThreads threads.
#pragma once

#include <cuda_runtime.h>

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

template <typename IdT>
__device__ __forceinline__ Score warp_score(const IdT* __restrict__ row,
                                            const float* cnt,
                                            const float* sum0,
                                            const float* sum1, int lo,
                                            int hi, int S, int D) {
  Score r{0.0, 0.0, 0, 0, 0, 0};
  for (int s = lo + static_cast<int>(threadIdx.x & 31); s < hi; s += 32) {
    const int id = static_cast<int>(row[s]);
    if (id < 0 || id >= D) continue;
    const float c0 = cnt[static_cast<size_t>(2 * id) * S + s];
    const float c1 = cnt[static_cast<size_t>(2 * id + 1) * S + s];
    if (!(c0 + c1 > 0.f)) continue;  // not found in the table
    const float t0 = sum0[s], t1 = sum1[s];
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
  r.a0 = warp_sum(r.a0);
  r.a1 = warp_sum(r.a1);
  r.f0 = warp_sum(r.f0);
  r.f1 = warp_sum(r.f1);
  r.nz0 = warp_sum(r.nz0);
  r.nz1 = warp_sum(r.nz1);
  return r;
}

}  // namespace pomfret
