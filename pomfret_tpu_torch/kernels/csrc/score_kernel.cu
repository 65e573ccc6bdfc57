// Scores of every candidate slot of every lane: one block per lane.
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
// the range (at most 6.3 MB of int8 ids at the bench shape G=256, NC=16,
// S=1536), each lane's table and sums over the range (at most 12.6 MB in
// all), and writes the (G, 8, NC) rows: 10 MB at the bench shape, 3 us at
// the HBM rate. It is gather-and-divide work with no matrix product, so
// tensor cores and wgmma do not apply; a lane's lookups depend on its ids,
// so a launch is bound by the latency of its loads unless they are few and
// in flight together.
//
// What the design does about it:
//  - one block per lane, so the lane's NC slots share one copy of the
//    table slice and the sums over [lo, hi) (lo aligned down to 16 bytes),
//    brought into dynamic shared memory by bulk copies (cp.async.bulk, one
//    per table or sums row, on an mbarrier); where they do not fit, or a
//    row is not 16-byte aligned, they stay in global memory on the same
//    code path (step_layout, pomfret_step_plan). At the bench shape a block
//    takes 61 KB, so two share an SM and all 256 lanes are resident;
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
//    slots' sums with atomics.
// Two block barriers: after the barrier's init and the zeroed slot sums,
// after the scoring.
//
// Numerics (common.cuh): f32 IEEE ratios (__fdiv_rn, no fast math), each
// score summed exactly in f64 and rounded once to f32: equal to
// score_plain bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace pomfret;

// cnt (G,2D,S) f32; sums (G,2,S) f32; cids (G,NC,S) int8|int32, -1 =
// absent; min_i, max_i (G,) int32; out (G,8,NC) f32; slots_g (G,
// slot_sums_bytes(NC)) bytes of scratch where the slots' sums are not
// shared.
struct ScoreArgs {
  const float* cnt;
  const float* sums;
  const void* cids;
  const int32_t* min_i;
  const int32_t* max_i;
  float* out;
  unsigned char* slots_g;
  int NC, S, D, place;
  StepLayout L;
};

template <typename IdT>
__global__ void __launch_bounds__(kStepThreads, 2)
    score_kernel(const ScoreArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StepLayout& L = a.L;
  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NC = a.NC, S = a.S, D = a.D;
  const int lo = max(a.min_i[g], 0), hi = min(a.max_i[g], S);
  const IdT* rows =
      static_cast<const IdT*>(a.cids) + static_cast<size_t>(g) * NC * S;
  const float* cnt_g = a.cnt + static_cast<size_t>(g) * 2 * D * S;
  const float* sums_g = a.sums + static_cast<size_t>(g) * 2 * S;
  const SlotSums acc = slot_sums_at(
      (a.place & kSlotsShared)
          ? smem + L.slots
          : a.slots_g + static_cast<size_t>(g) * slot_sums_bytes(NC),
      NC);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);

  // --- the table and sums over [lo_al, hi_al) into shared memory, rows of
  //     W sites (a multiple of 4: 16 bytes; S is one where they are shared)
  const int lo_al = lo & ~3, hi_al = min((hi + 3) & ~3, S);
  const int W = hi_al - lo_al;
  const bool tab_sh = (a.place & kTableShared) != 0;
  const bool sum_sh = (a.place & kSumsShared) != 0;
  const int n_copy = hi > lo ? (tab_sh ? 2 * D : 0) + (sum_sh ? 2 : 0) : 0;
  float* tab_s = reinterpret_cast<float*>(smem + L.table);
  float* sum_s = reinterpret_cast<float*>(smem + L.sums);
  if (n_copy && warp == 0) {
    if (lane == 0) {
      mbar_init(bar);
      fence_proxy_async();
      mbar_arrive_expect_tx(bar, static_cast<uint32_t>(n_copy) * W * 4);
    }
    __syncwarp();
    const int n_tab = tab_sh ? 2 * D : 0;
    for (int r = lane; r < n_copy; r += 32) {
      const bool t = r < n_tab;
      const int rr = t ? r : r - n_tab;
      bulk_g2s((t ? tab_s : sum_s) + static_cast<size_t>(rr) * W,
               (t ? cnt_g : sums_g) + static_cast<size_t>(rr) * S + lo_al,
               static_cast<uint32_t>(W) * 4, bar);
    }
  }
  for (int k = tid; k < NC; k += kStepThreads) {
    acc.a0[k] = acc.a1[k] = 0.0;
    acc.f0[k] = acc.f1[k] = acc.nz0[k] = acc.nz1[k] = 0;
  }
  __syncthreads();  // the barrier is initialised before any thread waits

  // --- scoring: the (slot, tile) pairs split evenly over the warps ---
  const TableView t{tab_sh ? tab_s : cnt_g,
                    sum_sh ? sum_s : sums_g,
                    sum_sh ? sum_s + W : sums_g + S,
                    tab_sh ? W : S,
                    tab_sh ? lo_al : 0,
                    sum_sh ? lo_al : 0};
  const int T = tiles_per_row<IdT>(lo, hi);
  const long long P = static_cast<long long>(NC) * T;
  score_pairs(rows, S, lo, hi, T, static_cast<int>(P * warp / kStepWarps),
              static_cast<int>(P * (warp + 1) / kStepWarps), t, D, acc,
              n_copy ? bar : nullptr);
  __syncthreads();  // every slot's sums are in

  float* o = a.out + static_cast<size_t>(g) * 8 * NC;
  for (int k = tid; k < NC; k += kStepThreads) {
    o[k] = __double2float_rn(acc.a0[k]);
    o[NC + k] = __double2float_rn(acc.a1[k]);
    o[2 * NC + k] = static_cast<float>(acc.f0[k]);
    o[3 * NC + k] = static_cast<float>(acc.f1[k]);
    o[4 * NC + k] = static_cast<float>(acc.nz0[k]);
    o[5 * NC + k] = static_cast<float>(acc.nz1[k]);
    o[6 * NC + k] = 0.f;
    o[7 * NC + k] = 0.f;
  }
}

template <typename IdT>
int launch(const ScoreArgs& a, int G, cudaStream_t st) {
  static std::atomic<unsigned long long> opted{0};  // devices, by bit
  const int rc = allow_optin(score_kernel<IdT>, opted);
  if (rc != 0) return rc;
  score_kernel<IdT><<<G, kStepThreads, a.L.total, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which buffers of a lane the per-iteration kernels (this one and
// score_commit_kernel.cu) keep in shared memory at this shape: of those in
// `allowed` (kSlotsShared | kSumsShared | kTableShared, as the caller's
// alignment permits), the slots' sums, then the site sums, then the count
// table, each while the block's total fits the opt-in maximum of the
// current device. Writes the placement bits, the block's dynamic shared
// memory and the bytes of one lane's slot sums; returns a CUDA error code.
extern "C" int pomfret_step_plan(int NC, int S, int D, int allowed,
                                 int* place, int* smem_bytes,
                                 int* slot_bytes) {
  int optin = 0;
  const int rc = optin_bytes(&optin);
  if (rc != 0) return rc;
  const int bits[3] = {kSlotsShared, kSumsShared, kTableShared};
  int p = 0;
  for (int b : bits)
    if ((allowed & b) && step_layout(NC, S, D, p | b).total <=
                             static_cast<unsigned>(optin))
      p |= b;
  *place = p;
  *smem_bytes = static_cast<int>(step_layout(NC, S, D, p).total);
  *slot_bytes = static_cast<int>(slot_sums_bytes(NC));
  return 0;
}

// Launches on `stream`; returns a CUDA error code (0 on success). `place`
// is pomfret_step_plan's for this shape.
extern "C" int pomfret_score_launch(int id_bytes, const void* cnt,
                                    const void* sums, const void* cids,
                                    const void* min_i, const void* max_i,
                                    void* out, void* slots, int G, int NC,
                                    int S, int D, int place, void* stream) {
  if (G <= 0 || NC <= 0) return 0;
  const ScoreArgs a{static_cast<const float*>(cnt),
                    static_cast<const float*>(sums),
                    cids,
                    static_cast<const int32_t*>(min_i),
                    static_cast<const int32_t*>(max_i),
                    static_cast<float*>(out),
                    static_cast<unsigned char*>(slots),
                    NC, S, D, place,
                    step_layout(NC, S, D, place)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (id_bytes == 1) return launch<int8_t>(a, G, st);
  if (id_bytes == 4) return launch<int32_t>(a, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
