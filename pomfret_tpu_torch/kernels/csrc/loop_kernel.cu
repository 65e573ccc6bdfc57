// Whole greedy haplotag loop of one (gap, direction) lane per thread block.
//
// Replaces pomfret_tpu/kernels/engine_fused3.py::_loop_kernel (the Pallas
// v3 kernel). Semantics are haplotag_region1's greedy loop
// (blockjoin.c:3958-4080) as run_direction_core / run_batch_fused_core
// batch it: per iteration, the valid-site range from the count table, the
// first n_cand untagged reads at or after q_last as candidates, per-candidate
// scores sum(cnt/max(sum,1)) with the score_l double count, the
// diff<3 / l_total<3 gate, the best pick (ties to the highest read), the
// commit into count table and hp, and the failure bookkeeping
// (failed<=10, q_last += n_cand).
//
// What bounds it on an H100: each iteration depends on the one before (the
// commit changes the count table the next scoring reads), so a lane is a
// serial chain of a few hundred short iterations. Each one reads
// n_cand x range sites of mer ids plus two count-table cells per covered
// site (tens of KB, from L1/L2) and synchronises the block ~8 times: it is
// latency-bound, not bandwidth- or FLOP-bound. The parallelism across lanes
// is G blocks against 132 SMs (G=256 at the bench shape, so every block is
// resident at once).
//
// What the design does about it: one block of 256 threads per lane, so a
// lane never waits for another (each block leaves its loop when its own
// lane is done); warps score candidates in parallel, lanes of a warp stride
// over sites; the count table stays in a per-lane global buffer small
// enough to live in L1/L2, which takes every shape the packer makes with one
// code path. Later work: stage the count table and candidate rows in shared
// memory, and overlap the candidate scan with scoring.
//
// Numerics, kept equal to loop_plain (engine_fused3.py) bit for bit:
//  - ratios are f32 IEEE divisions (__fdiv_rn; built without fast math);
//  - each score is accumulated in f64 and rounded once to f32. Every ratio
//    is an f32 multiple of 2^-(23+ceil(log2 sum)), so the f64 sum is exact
//    for any realistic (S, coverage) and hence independent of the order of
//    summation: the warp tree here and torch's reduction in loop_plain give
//    the same bits. Float atomics are not used anywhere;
//  - counts are small integers held in f32 (exact).
//
// stats[g] = [iterations of this lane, q_last, failed, commits, 0, 0, 0, 0].
// The iteration count is the lane's own; the Pallas kernel reported the
// iteration count of its whole lane block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace pomfret;

// ids (G,R,S) int8|int32, -1 = absent; hm (G,R) bool; scal (G,8) int32 =
// [min0, max0, cov, n_sites, n_reads, q_break, n_cand, max_iters];
// hp_init (G,R) int32; cnt (G,2D,S) f32 seeded counts, updated in place;
// sums (G,2,S) f32 scratch; hp_out (G,R) int32; stats (G,8) int32.
template <typename IdT>
__global__ void __launch_bounds__(kThreads)
loop_kernel(const IdT* __restrict__ ids, const uint8_t* __restrict__ hm,
            const int32_t* __restrict__ scal,
            const int32_t* __restrict__ hp_init, float* __restrict__ cnt_all,
            float* __restrict__ sums_all, int32_t* __restrict__ hp_all,
            int32_t* __restrict__ stats, int R, int S, int D, int nc_cap) {
  extern __shared__ int smem[];
  int* cand = smem;                                   // [nc_cap] read rows
  float* sc0 = reinterpret_cast<float*>(cand + nc_cap);  // [nc_cap] scores
  float* sc1 = sc0 + nc_cap;
  int* lt0 = reinterpret_cast<int*>(sc1 + nc_cap);    // [nc_cap] l_total
  int* lt1 = lt0 + nc_cap;
  __shared__ int red[kWarps];
  __shared__ int wcount[kWarps];
  __shared__ int s_best, s_tag;

  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* sc = scal + static_cast<size_t>(g) * 8;
  const int min0 = sc[0], max0 = sc[1], cov = sc[2], n_sites = sc[3];
  const int n_reads = sc[4], q_break = sc[5], n_cand = sc[6];
  const int max_iters = sc[7];
  const int n_slots = min(n_cand, nc_cap);
  const IdT* lane_ids = ids + static_cast<size_t>(g) * R * S;
  const uint8_t* lane_hm = hm + static_cast<size_t>(g) * R;
  float* cnt = cnt_all + static_cast<size_t>(g) * 2 * D * S;
  float* sum0 = sums_all + static_cast<size_t>(g) * 2 * S;
  float* sum1 = sum0 + S;
  int32_t* hp = hp_all + static_cast<size_t>(g) * R;

  for (int r = tid; r < R; r += kThreads)
    hp[r] = hp_init[static_cast<size_t>(g) * R + r];
  for (int s = tid; s < S; s += kThreads) {
    float a = 0.f, b = 0.f;
    for (int d = 0; d < D; ++d) {
      a += cnt[static_cast<size_t>(2 * d) * S + s];
      b += cnt[static_cast<size_t>(2 * d + 1) * S + s];
    }
    sum0[s] = a;
    sum1[s] = b;
  }
  __syncthreads();

  const float covf = static_cast<float>(cov);
  int it = 0, q_last = 0, failed = 0, ncom = 0;
  while (q_last < q_break && failed <= 10 && it < max_iters) {
    // --- valid-site range (closed form of blockjoin.c:3669-3691) ---
    int fb = S, lnb = -1;
    for (int s = tid; s < S; s += kThreads) {
      const bool ok = (sum0[s] + sum1[s] >= covf) && s < n_sites;
      if ((!ok && s >= max0) || s >= n_sites) fb = min(fb, s);
      if (!ok && s <= min0 && min0 >= 0) lnb = max(lnb, s);
    }
    int min_i, max_i;
    site_range(fb, lnb, min0, max0, red, &min_i, &max_i);

    // --- candidates: first n_cand untagged rows in [q_last, n_reads),
    //     found by a block scan in chunks of kThreads rows ---
    int found = 0;
    for (int base = q_last; base < n_reads && found < n_slots;
         base += kThreads) {
      const int q = base + tid;
      bool e = false;
      if (q < n_reads) {
        const int h = hp[q];
        e = h != 0 && h != 1;
      }
      const unsigned bal = __ballot_sync(kFull, e);
      __syncthreads();
      if (lane == 0) wcount[warp] = __popc(bal);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = wcount[w];
        before += w < warp ? c : 0;
        total += c;
      }
      const int slot = found + before + __popc(bal & ((1u << lane) - 1u));
      if (e && slot < n_slots) cand[slot] = q;
      found += total;
    }
    const int n_valid = min(found, n_slots);
    __syncthreads();

    // --- scoring: one warp per candidate, lanes stride over the range ---
    const int lo = max(min_i, 0), hi = min(max_i, S);
    for (int k = warp; k < n_valid; k += kWarps) {
      const Score r = warp_score(lane_ids + static_cast<size_t>(cand[k]) * S,
                                 cnt, sum0, sum1, lo, hi, S, D);
      if (lane == 0) {
        sc0[k] = __double2float_rn(r.a0);
        sc1[k] = __double2float_rn(r.a1);
        lt0[k] = r.f0 + r.nz0;  // l_found + l_nonzero (score_l quirk)
        lt1[k] = r.f1 + r.nz1;
      }
    }
    __syncthreads();

    // --- decide (blockjoin.c:3645-3765): best diff, ties -> highest read ---
    if (tid == 0) {
      float best = -1.f;
      int bk = -1;
      for (int k = 0; k < n_valid; ++k) {
        const float diff = fabsf(sc0[k] - sc1[k]);
        const bool tag_ok = !(diff < 3.f && (lt0[k] < 3 || lt1[k] < 3));
        if (tag_ok && lane_hm[cand[k]] && diff >= best) {
          best = diff;
          bk = k;
        }
      }
      s_best = bk;
      s_tag = (bk >= 0 && !(sc0[bk] > sc1[bk])) ? 1 : 0;
      if (bk >= 0) hp[cand[bk]] = s_tag;
    }
    __syncthreads();

    // --- commit the winner's mers into the table, or fail the batch ---
    const int bk = s_best;
    if (bk >= 0) {
      const int t = s_tag;
      const IdT* row = lane_ids + static_cast<size_t>(cand[bk]) * S;
      float* st = t ? sum1 : sum0;
      for (int s = tid; s < S; s += kThreads) {
        const int id = static_cast<int>(row[s]);
        if (id >= 0 && id < D) {
          cnt[static_cast<size_t>(2 * id + t) * S + s] += 1.f;
          st[s] += 1.f;
        }
      }
      failed = 0;
      ++ncom;
    } else {  // blockjoin.c:4046-4070
      ++failed;
      q_last += n_cand;
    }
    ++it;
    __syncthreads();
  }

  if (tid == 0) {
    int32_t* o = stats + static_cast<size_t>(g) * 8;
    o[0] = it;
    o[1] = q_last;
    o[2] = failed;
    o[3] = ncom;
    o[4] = o[5] = o[6] = o[7] = 0;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pomfret_loop_launch(int id_bytes, const void* ids,
                                   const void* hm, const void* scal,
                                   const void* hp_init, void* cnt, void* sums,
                                   void* hp_out, void* stats, int G, int R,
                                   int S, int D, int nc_cap, void* stream) {
  if (G <= 0) return 0;
  const size_t shm = static_cast<size_t>(nc_cap) * 5 * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* h = static_cast<const uint8_t*>(hm);
  const int32_t* sc = static_cast<const int32_t*>(scal);
  const int32_t* hi = static_cast<const int32_t*>(hp_init);
  float* c = static_cast<float*>(cnt);
  float* sm = static_cast<float*>(sums);
  int32_t* ho = static_cast<int32_t*>(hp_out);
  int32_t* so = static_cast<int32_t*>(stats);
  if (id_bytes == 1) {
    loop_kernel<int8_t><<<G, pomfret::kThreads, shm, st>>>(
        static_cast<const int8_t*>(ids), h, sc, hi, c, sm, ho, so, R, S, D,
        nc_cap);
  } else if (id_bytes == 4) {
    loop_kernel<int32_t><<<G, pomfret::kThreads, shm, st>>>(
        static_cast<const int32_t*>(ids), h, sc, hi, c, sm, ho, so, R, S, D,
        nc_cap);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pomfret_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
