// One greedy iteration of every lane: one block of kStepThreads threads a lane.
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
// and the range, then NC candidate rows over the range (24 KB of int8 ids
// at NC=16), and writes one row of increments: about 15 MB per launch at
// G=256, 4.6 us at the HBM rate. It is gather-and-divide work with no
// matrix product, so tensor cores and wgmma do not apply; a lane's steps
// are serial (table -> sums and range -> scores -> pick -> commit), so a
// launch is bound by the latency of that chain unless the chain's loads
// are few and in flight together.
//
// What the design does about it:
//  - one bulk copy (cp.async.bulk on an mbarrier, in 4 KB pieces) brings
//    the lane's table into dynamic shared memory; the sums are built there
//    from it, and every lookup of the scoring reads shared memory. Where
//    the table (or the sums, or the slots' sums) does not fit, it stays in
//    global memory on the same code path (step_layout, pomfret_step_plan).
//    At the bench shape a block takes 61 KB, so two share an SM and all
//    256 lanes are resident at once;
//  - the range takes one block barrier: each warp reduces its sites'
//    partials with shuffles, and every thread reads the sixteen warps';
//  - candidate ids are loaded 16 bytes at once (common.cuh score_pairs),
//    the next chunk in flight while the current one is scored; a read
//    holds a mer at 10-17% of the sites, so the present ids of a tile are
//    dealt out to the warp's lanes 32 at a time by shuffles, and the table
//    and sums are read, and the ratios taken, in full warps (scored site
//    by site, a warp would run the divide for nearly every site: some lane
//    nearly always holds a mer there);
//  - the (slot, tile) pairs are split evenly over the sixteen warps (a
//    block of 512 threads: the scoring is a chain of dependent shuffles
//    and lookups, and an SM holds only ~2 lanes, so it needs the warps to
//    hide their latency), each warp's exact f64 partials added into the
//    slots' sums with atomics;
//  - every warp takes the pick itself with shuffles (ties to the highest
//    slot), so no barrier follows it; the commit writes only the winner's
//    increments into the global table, with the same 16-byte id loads.
// Three block barriers: after the barrier's init and the zeroed slot sums,
// after the sums and range partials, after the scoring.
//
// Numerics (common.cuh): f32 IEEE ratios (__fdiv_rn, no fast math), each
// score summed exactly in f64 and rounded once to f32, the score_l double
// count, the diff<3 / l_total<3 gate: equal to score_commit_plain bit for
// bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace pomfret;

// bytes of the table one bulk copy brings
constexpr uint32_t kPiece = 4096;

// scal (G,8) int32 = [min0, max0, cov, n_sites, active, 0, 0, 0];
// cmeta (G,4,NC) int32 = [cand_read, cand_valid, has_mmr_c, 0];
// cids (G,NC,S) int8|int32, -1 = absent; cnt (G,2D,S) f32, updated in
// place; hp (G,R) int32, updated in place; flags (G,8) int32; sums_g
// (G,2,S) f32 and slots_g (G, slot_sums_bytes(NC)) bytes of scratch where
// those buffers are not shared.
struct CommitArgs {
  const int32_t* scal;
  const int32_t* cmeta;
  const void* cids;
  float* cnt;
  int32_t* hp;
  int32_t* flags;
  float* sums_g;
  unsigned char* slots_g;
  int NC, S, D, R, place;
  StepLayout L;
};

template <typename IdT>
__global__ void __launch_bounds__(kStepThreads, 2)
score_commit_kernel(const CommitArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StepLayout& L = a.L;
  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NC = a.NC, S = a.S, D = a.D;
  const int32_t* sc = a.scal + static_cast<size_t>(g) * 8;
  int32_t* fl = a.flags + static_cast<size_t>(g) * 8;
  if (sc[4] <= 0) {  // inactive: the whole block leaves
    if (tid < 8) fl[tid] = 0;
    return;
  }
  const int min0 = sc[0], max0 = sc[1], n_sites = sc[3];
  const float covf = static_cast<float>(sc[2]);
  const IdT* rows =
      static_cast<const IdT*>(a.cids) + static_cast<size_t>(g) * NC * S;
  const int32_t* cm = a.cmeta + static_cast<size_t>(g) * 4 * NC;
  float* cnt_g = a.cnt + static_cast<size_t>(g) * 2 * D * S;
  const bool staged = (a.place & kTableShared) != 0;
  const float* cnt =
      staged ? reinterpret_cast<const float*>(smem + L.table) : cnt_g;
  float* sum0 = (a.place & kSumsShared)
                    ? reinterpret_cast<float*>(smem + L.sums)
                    : a.sums_g + static_cast<size_t>(g) * 2 * S;
  float* sum1 = sum0 + S;
  const SlotSums acc = slot_sums_at(
      (a.place & kSlotsShared)
          ? smem + L.slots
          : a.slots_g + static_cast<size_t>(g) * slot_sums_bytes(NC),
      NC);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  int* red = reinterpret_cast<int*>(smem + L.red);

  // --- the table into shared memory (warp 0 issues the pieces), the
  //     slots' sums zeroed ---
  if (staged && warp == 0) {
    const uint32_t bytes = 2u * D * S * 4;
    if (lane == 0) {
      mbar_init(bar);
      fence_proxy_async();
      mbar_arrive_expect_tx(bar, bytes);
    }
    __syncwarp();
    for (uint32_t o = lane * kPiece; o < bytes; o += 32 * kPiece)
      bulk_g2s(smem + L.table + o,
               reinterpret_cast<const unsigned char*>(cnt_g) + o,
               min(kPiece, bytes - o), bar);
  }
  for (int k = tid; k < NC; k += kStepThreads) {
    acc.a0[k] = acc.a1[k] = 0.0;
    acc.f0[k] = acc.f1[k] = acc.nz0[k] = acc.nz1[k] = 0;
  }
  __syncthreads();  // the barrier is initialised before any thread waits
  if (staged) mbar_wait(bar, 0);

  // --- per-haplotype sums and the range partials, from the table ---
  int fb = S, lnb = -1;
  for (int s = tid; s < S; s += kStepThreads) {
    float t0 = 0.f, t1 = 0.f;  // small integers: exact in any order
    for (int d = 0; d < D; ++d) {
      t0 += cnt[static_cast<size_t>(2 * d) * S + s];
      t1 += cnt[static_cast<size_t>(2 * d + 1) * S + s];
    }
    sum0[s] = t0;
    sum1[s] = t1;
    const bool ok = (t0 + t1 >= covf) && s < n_sites;
    if ((!ok && s >= max0) || s >= n_sites) fb = min(fb, s);
    if (!ok && s <= min0 && min0 >= 0) lnb = max(lnb, s);
  }
  fb = warp_min(fb);
  lnb = warp_max(lnb);
  if (lane == 0) {
    red[warp] = fb;
    red[kStepWarps + warp] = lnb;
  }
  __syncthreads();  // sums and partials visible to every warp
  for (int w = 0; w < kStepWarps; ++w) {
    fb = min(fb, red[w]);
    lnb = max(lnb, red[kStepWarps + w]);
  }
  // the closed form of the range (blockjoin.c:3669-3691)
  const int max_i = fb > max0 ? fb - 1 : max0;
  const int min_i =
      min0 < 0 ? min0 : (lnb == min0 ? min0 : (lnb >= 0 ? lnb + 1 : 0));
  const int lo = max(min_i, 0), hi = min(max_i, S);

  // --- scoring: the (slot, tile) pairs split evenly over the warps ---
  const int T = tiles_per_row<IdT>(lo, hi);
  const long long P = static_cast<long long>(NC) * T;
  score_pairs(rows, S, lo, hi, T, static_cast<int>(P * warp / kStepWarps),
              static_cast<int>(P * (warp + 1) / kStepWarps),
              TableView{cnt, sum0, sum1, S, 0, 0}, D, acc, nullptr);
  __syncthreads();  // every score is in; every read of cnt precedes the commit

  // --- decide (blockjoin.c:3645-3765), in every warp: the largest diff
  //     among the committable slots, ties to the highest slot ---
  float best = -1.f, b0 = 0.f, b1 = 0.f;
  int bk = -1;
  for (int k = lane; k < NC; k += 32) {
    const float s0 = __double2float_rn(acc.a0[k]);
    const float s1 = __double2float_rn(acc.a1[k]);
    const int n0 = acc.f0[k] + acc.nz0[k];  // l_found + l_nonzero (score_l)
    const int n1 = acc.f1[k] + acc.nz1[k];
    const float diff = fabsf(s0 - s1);
    const bool ok = !(diff < 3.f && (n0 < 3 || n1 < 3)) && cm[NC + k] > 0 &&
                    cm[2 * NC + k] > 0;
    if (ok && diff >= best) {
      best = diff;
      bk = k;
      b0 = s0;
      b1 = s1;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o);
    const int obk = __shfl_xor_sync(kFull, bk, o);
    const float o0 = __shfl_xor_sync(kFull, b0, o);
    const float o1 = __shfl_xor_sync(kFull, b1, o);
    if (ob > best || (ob == best && obk > bk)) {
      best = ob;
      bk = obk;
      b0 = o0;
      b1 = o1;
    }
  }
  if (tid < 8) fl[tid] = bk >= 0 ? 1 : 0;
  if (bk < 0) return;
  const int tag = !(b0 > b1) ? 1 : 0;
  if (tid == 0) a.hp[static_cast<size_t>(g) * a.R + cm[bk]] = tag;

  // --- commit the winner's mers into the global table ---
  const IdT* row = rows + static_cast<size_t>(bk) * S;
  const uintptr_t end = reinterpret_cast<uintptr_t>(row + S);
  // each site's cell is one thread's, so the adds need no atomicity:
  // atomicAdd with its result unused is a reduction the thread does not
  // wait for (the sums are small integers, exact)
  for (uintptr_t c = (reinterpret_cast<uintptr_t>(row) &
                      ~static_cast<uintptr_t>(15)) +
                     static_cast<uintptr_t>(tid) * kChunk;
       c < end; c += static_cast<uintptr_t>(kStepThreads) * kChunk) {
    const uint4 v = load_chunk(c);
    const int s0 = chunk_site0(c, row);
    for (uint32_t m = present_mask<IdT>(v); m; m &= m - 1) {
      const int j = __ffs(m) - 1, s = s0 + j;
      const int id = chunk_element<IdT>(v.x, v.y, v.z, v.w, j);
      if (id < D && s >= 0 && s < S)
        atomicAdd(cnt_g + static_cast<size_t>(2 * id + tag) * S + s, 1.f);
    }
  }
}

template <typename IdT>
int launch(const CommitArgs& a, int G, cudaStream_t st) {
  static std::atomic<unsigned long long> opted{0};  // devices, by bit
  const int rc = allow_optin(score_commit_kernel<IdT>, opted);
  if (rc != 0) return rc;
  score_commit_kernel<IdT><<<G, kStepThreads, a.L.total, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success). `place`
// is pomfret_step_plan's for this shape.
extern "C" int pomfret_score_commit_launch(int id_bytes, const void* scal,
                                           const void* cmeta,
                                           const void* cids, void* cnt,
                                           void* hp, void* flags, void* sums,
                                           void* slots, int G, int NC, int S,
                                           int D, int R, int place,
                                           void* stream) {
  if (G <= 0) return 0;
  const CommitArgs a{static_cast<const int32_t*>(scal),
                     static_cast<const int32_t*>(cmeta),
                     cids,
                     static_cast<float*>(cnt),
                     static_cast<int32_t*>(hp),
                     static_cast<int32_t*>(flags),
                     static_cast<float*>(sums),
                     static_cast<unsigned char*>(slots),
                     NC, S, D, R, place,
                     step_layout(NC, S, D, place)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (id_bytes == 1) return launch<int8_t>(a, G, st);
  if (id_bytes == 4) return launch<int32_t>(a, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
