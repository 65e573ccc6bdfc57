// Scores of every candidate slot of every lane: one warp per (lane, slot).
//
// Replaces pomfret_tpu/kernels/engine_fused.py::_score_kernel (the Pallas
// v1 scoring kernel, launched once per greedy iteration by
// run_batch_fused_core). For each slot k of lane g it writes
// out[g, :, k] = [score0, score1, l_found0, l_found1, l_nonzero0,
// l_nonzero1, 0, 0]: over the sites in [min_i, max_i) whose mer id is in
// the table, the ratio cnt/max(sum, 1) of each haplotype whose sum is
// positive, and the counts of found sites and of nonzero ratios. The loop
// adds l_found and l_nonzero afterwards (the score_l double count). Every
// slot is scored, the empty ones too (they carry read row 0; the loop masks
// them out of the pick).
//
// What bounds it on an H100: one launch reads G x NC candidate rows over
// the range (int8 or int32 ids, coalesced: lanes of a warp on neighbouring
// sites; at most 6.3 MB of int8 ids at the bench shape G=256, NC=16,
// S=1536) and two count-table cells plus two sums per covered site, out of
// tables of 12.6 MB in all that stay in the 50 MB L2. That is a few
// microseconds of memory traffic, so a launch is bound by its latency and
// the loop by the host's launch rate, not by bandwidth.
//
// What the design does about it: G x NC independent warps (4096 at the
// bench shape, 16 per SM), no shared memory, no block barrier, one warp
// reduction per score; the scoring loop is the loop kernel's (common.cuh),
// so the f64 sums round to the same f32 bits as score_plain and
// loop_plain. Later work: fuse the candidate gather into the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace pomfret;

// cnt (G,2D,S) f32; sums (G,2,S) f32; cids (G,NC,S) int8|int32, -1 =
// absent; min_i, max_i (G,) int32; out (G,8,NC) f32.
template <typename IdT>
__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ cnt_all,
             const float* __restrict__ sums_all, const IdT* __restrict__ cids,
             const int32_t* __restrict__ min_i,
             const int32_t* __restrict__ max_i, float* __restrict__ out,
             int G, int NC, int S, int D) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (w >= static_cast<int64_t>(G) * NC) return;  // the whole warp leaves
  const int g = static_cast<int>(w / NC), k = static_cast<int>(w % NC);
  const float* cnt = cnt_all + static_cast<size_t>(g) * 2 * D * S;
  const float* sum0 = sums_all + static_cast<size_t>(g) * 2 * S;
  const Score r = warp_score(cids + static_cast<size_t>(w) * S, cnt, sum0,
                             sum0 + S, max(min_i[g], 0), min(max_i[g], S), S,
                             D);
  if ((threadIdx.x & 31) == 0) {
    float* o = out + static_cast<size_t>(g) * 8 * NC + k;
    o[0] = __double2float_rn(r.a0);
    o[NC] = __double2float_rn(r.a1);
    o[2 * NC] = static_cast<float>(r.f0);
    o[3 * NC] = static_cast<float>(r.f1);
    o[4 * NC] = static_cast<float>(r.nz0);
    o[5 * NC] = static_cast<float>(r.nz1);
    o[6 * NC] = 0.f;
    o[7 * NC] = 0.f;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pomfret_score_launch(int id_bytes, const void* cnt,
                                    const void* sums, const void* cids,
                                    const void* min_i, const void* max_i,
                                    void* out, int G, int NC, int S, int D,
                                    void* stream) {
  if (G <= 0 || NC <= 0) return 0;
  const int64_t warps = static_cast<int64_t>(G) * NC;
  constexpr int kW = pomfret::kWarps;
  const unsigned blocks = static_cast<unsigned>((warps + kW - 1) / kW);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cnt);
  const float* sm = static_cast<const float*>(sums);
  const int32_t* lo = static_cast<const int32_t*>(min_i);
  const int32_t* hi = static_cast<const int32_t*>(max_i);
  float* o = static_cast<float*>(out);
  if (id_bytes == 1) {
    score_kernel<int8_t><<<blocks, pomfret::kThreads, 0, st>>>(
        c, sm, static_cast<const int8_t*>(cids), lo, hi, o, G, NC, S, D);
  } else if (id_bytes == 4) {
    score_kernel<int32_t><<<blocks, pomfret::kThreads, 0, st>>>(
        c, sm, static_cast<const int32_t*>(cids), lo, hi, o, G, NC, S, D);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
