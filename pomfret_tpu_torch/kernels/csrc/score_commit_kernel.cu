// One greedy iteration of every lane: one block of kThreads threads per lane.
//
// Replaces pomfret_tpu/kernels/engine_fused.py::_score_commit_kernel (the
// Pallas v2 kernel, launched once per greedy iteration by
// run_batch_fused2_core). For an active lane it does, in order: the
// valid-site range recomputed from the count table (tot = sum of every
// row, blockjoin.c:3669-3691), the scores of every candidate slot (v1's
// math), the diff<3 / l_total<3 gate and the best pick among the valid
// slots whose read has mers (ties to the highest slot), then the commit of
// the winner's mers into the count table and of its tag into hp, both in
// place (the Pallas call aliases them), and flags[g, :] = do_commit. An
// inactive lane changes nothing and gets flags 0.
//
// What bounds it on an H100: per launch each lane reads its count table
// (2D x S floats, 48 KB at the bench shape D=4, S=1536) to rebuild the sums
// and the range, then NC candidate rows (24 KB of int8 ids at NC=16) with
// two table cells per covered site, then writes one row of increments:
// about 19 MB per launch at G=256, out of L2. The lane's steps are serial
// (range -> scores -> pick -> commit) with 6 block barriers, so a launch is
// bound by that chain's latency, and the loop by one launch per iteration.
//
// What the design does about it: one block per lane (G=256 blocks over 132
// SMs, all resident at once), warps score slots in parallel with the loop
// kernel's scoring (common.cuh, exact f64 sums rounded once to f32, so the
// picks equal score_commit_plain's and the loop kernel's), the sums go to a
// per-lane scratch row in global memory instead of shared memory so that
// every S fits, and an inactive lane leaves at once. A barrier separates
// the last read of the count table by the scoring warps from the first
// write of the commit. Later work: keep the table in shared memory where it
// fits, and fuse the candidate collection into the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace pomfret;

// scal (G,8) int32 = [min0, max0, cov, n_sites, active, 0, 0, 0];
// cmeta (G,4,NC) int32 = [cand_read, cand_valid, has_mmr_c, 0];
// cids (G,NC,S) int8|int32, -1 = absent; cnt (G,2D,S) f32, updated in
// place; hp (G,R) int32, updated in place; flags (G,8) int32; sums (G,2,S)
// f32 scratch.
template <typename IdT>
__global__ void __launch_bounds__(kThreads)
score_commit_kernel(const int32_t* __restrict__ scal,
                    const int32_t* __restrict__ cmeta,
                    const IdT* __restrict__ cids, float* cnt_all,
                    int32_t* hp_all, int32_t* __restrict__ flags,
                    float* sums_all, int NC, int S, int D, int R) {
  extern __shared__ int smem[];
  float* sc0 = reinterpret_cast<float*>(smem);       // [NC] scores
  float* sc1 = sc0 + NC;
  int* lt0 = reinterpret_cast<int*>(sc1 + NC);       // [NC] l_total
  int* lt1 = lt0 + NC;
  __shared__ int red[kWarps];
  __shared__ int s_best, s_tag;

  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* sc = scal + static_cast<size_t>(g) * 8;
  int32_t* fl = flags + static_cast<size_t>(g) * 8;
  if (sc[4] <= 0) {  // inactive: the whole block leaves
    if (tid < 8) fl[tid] = 0;
    return;
  }
  const int min0 = sc[0], max0 = sc[1], cov = sc[2], n_sites = sc[3];
  const IdT* lane_cids = cids + static_cast<size_t>(g) * NC * S;
  const int32_t* cm = cmeta + static_cast<size_t>(g) * 4 * NC;
  float* cnt = cnt_all + static_cast<size_t>(g) * 2 * D * S;
  float* sum0 = sums_all + static_cast<size_t>(g) * 2 * S;
  float* sum1 = sum0 + S;

  // --- per-haplotype sums and the range, from the table ---
  const float covf = static_cast<float>(cov);
  int fb = S, lnb = -1;
  for (int s = tid; s < S; s += kThreads) {
    float a = 0.f, b = 0.f;  // small integers: exact in any order
    for (int d = 0; d < D; ++d) {
      a += cnt[static_cast<size_t>(2 * d) * S + s];
      b += cnt[static_cast<size_t>(2 * d + 1) * S + s];
    }
    sum0[s] = a;
    sum1[s] = b;
    const bool ok = (a + b >= covf) && s < n_sites;
    if ((!ok && s >= max0) || s >= n_sites) fb = min(fb, s);
    if (!ok && s <= min0 && min0 >= 0) lnb = max(lnb, s);
  }
  int min_i, max_i;
  site_range(fb, lnb, min0, max0, red, &min_i, &max_i);  // barriers: the
  // sums written above are visible to every warp from here on

  // --- scoring: one warp per slot, lanes stride over the range ---
  const int lo = max(min_i, 0), hi = min(max_i, S);
  for (int k = warp; k < NC; k += kWarps) {
    const Score r = warp_score(lane_cids + static_cast<size_t>(k) * S, cnt,
                               sum0, sum1, lo, hi, S, D);
    if (lane == 0) {
      sc0[k] = __double2float_rn(r.a0);
      sc1[k] = __double2float_rn(r.a1);
      lt0[k] = r.f0 + r.nz0;  // l_found + l_nonzero (score_l quirk)
      lt1[k] = r.f1 + r.nz1;
    }
  }
  __syncthreads();  // every read of cnt above precedes the commit below

  // --- decide (blockjoin.c:3645-3765): best diff, ties -> highest slot ---
  if (tid == 0) {
    float best = -1.f;
    int bk = -1;
    for (int k = 0; k < NC; ++k) {
      const float diff = fabsf(sc0[k] - sc1[k]);
      const bool tag_ok = !(diff < 3.f && (lt0[k] < 3 || lt1[k] < 3));
      if (tag_ok && cm[NC + k] > 0 && cm[2 * NC + k] > 0 && diff >= best) {
        best = diff;
        bk = k;
      }
    }
    s_best = bk;
    s_tag = (bk >= 0 && !(sc0[bk] > sc1[bk])) ? 1 : 0;
    if (bk >= 0) hp_all[static_cast<size_t>(g) * R + cm[bk]] = s_tag;
  }
  __syncthreads();

  // --- commit the winner's mers into the table ---
  const int bk = s_best;
  if (tid < 8) fl[tid] = bk >= 0 ? 1 : 0;
  if (bk >= 0) {
    const int t = s_tag;
    const IdT* row = lane_cids + static_cast<size_t>(bk) * S;
    for (int s = tid; s < S; s += kThreads) {
      const int id = static_cast<int>(row[s]);
      if (id >= 0 && id < D)
        cnt[static_cast<size_t>(2 * id + t) * S + s] += 1.f;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pomfret_score_commit_launch(int id_bytes, const void* scal,
                                           const void* cmeta,
                                           const void* cids, void* cnt,
                                           void* hp, void* flags, void* sums,
                                           int G, int NC, int S, int D,
                                           int R, void* stream) {
  if (G <= 0) return 0;
  const size_t shm = static_cast<size_t>(NC) * 4 * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* sc = static_cast<const int32_t*>(scal);
  const int32_t* cm = static_cast<const int32_t*>(cmeta);
  float* c = static_cast<float*>(cnt);
  int32_t* h = static_cast<int32_t*>(hp);
  int32_t* f = static_cast<int32_t*>(flags);
  float* sm = static_cast<float*>(sums);
  if (id_bytes == 1) {
    score_commit_kernel<int8_t><<<G, pomfret::kThreads, shm, st>>>(
        sc, cm, static_cast<const int8_t*>(cids), c, h, f, sm, NC, S, D, R);
  } else if (id_bytes == 4) {
    score_commit_kernel<int32_t><<<G, pomfret::kThreads, shm, st>>>(
        sc, cm, static_cast<const int32_t*>(cids), c, h, f, sm, NC, S, D, R);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
