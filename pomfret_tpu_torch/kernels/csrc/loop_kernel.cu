// Whole greedy haplotag loop of one (gap, direction) lane per thread block.
//
// Replaces pomfret_tpu/kernels/engine_fused3.py::_loop_kernel (the Pallas
// v3 kernel) and the seed table that the JAX package computes before it
// (engine_fused.py::_seed_count_table_b). Semantics are haplotag_region1's
// greedy loop (blockjoin.c:3958-4080) as run_direction_core /
// run_batch_fused_core batch it: the seed counts, then per iteration the
// valid-site range from the count table, the first n_cand untagged reads at
// or after q_last as candidates, per-candidate scores sum(cnt/max(sum,1))
// with the score_l double count, the diff<3 / l_total<3 gate, the best pick
// (ties to the highest read), the commit into count table and hp, and the
// failure bookkeeping (failed<=10, q_last += n_cand).
//
// What bounds it on an H100: each iteration depends on the one before (the
// commit changes the table the next scoring reads), so a lane is a serial
// chain of a few hundred short iterations, and an iteration's time is the
// latency of its steps and barriers, not bytes or operations: it reads a few
// thousand table cells and candidate ids, all on chip. The parallelism
// across lanes is G blocks against 132 SMs.
//
// What the design does about it:
//  - the prologue builds the seed table itself (one thread per site, a loop
//    over the seeded rows, sixteen rows' ids loaded at once; counts are
//    small integers, exact in f32), so the (G,R,S) temporaries of
//    _seed_count_table_b never reach device memory;
//  - the slot arrays (score partials, member lists, slot and fill lists:
//    244 bytes a row slot), the count table, the site sums and the
//    candidate rows live in dynamic shared memory where they fit (the
//    opt-in maximum; at the bench shape two blocks share an SM, so all 256
//    lanes are resident in one wave); a buffer that does not fit stays in a
//    per-lane global buffer, reached through the same generic pointer, so
//    one code path takes every shape and every nc_cap;
//  - the candidate set is kept incrementally, as in the Pallas kernel: a
//    commit frees the winner's slot, a failure drops the members below the
//    new q_last, and the next member (the first untagged read at or after
//    max(cursor, q_last), cursor = one past the last member taken) is known
//    when the iteration starts, so its row is prefetched by cp.async.bulk
//    into a free slot on an mbarrier while the block scores, and adopted
//    after the commit; a failure that moved q_last past the cursor (the
//    speculation miss) and any other shortfall is refilled in bulk rounds.
//    Rows whose bytes are not a multiple of 16 are copied with loads;
//  - scoring covers only the range [lo, hi), and of each member only the
//    span of sites where its row holds a mer (found once, when the row
//    enters the set; a read covers ~11% of the sites at the bench shape):
//    the (member, 64-site tile) pairs are split evenly over the eight
//    warps, a lane loading its two sites of a tile together, each warp's
//    f64 partials added into shared accumulators with atomics (the sums
//    are exact, so their order does not matter);
//  - every warp takes the argmax over the members itself with shuffles
//    (ties to the highest read index: slots are reused, so slot order is
//    not read order), so no barrier follows the decision; the commit's
//    threads recompute the range's partials for the sites they own, and
//    warp 0 keeps the candidate set. Two block barriers per iteration: one
//    between the scoring's last table read and the commit's first write,
//    one before the next scoring. Member lists and accumulators are
//    double-buffered by iteration parity so that nothing else needs one.
//
// Numerics, kept equal to loop_plain (engine_fused3.py) bit for bit:
//  - ratios are f32 IEEE divisions (__fdiv_rn; built without fast math);
//  - each score is accumulated in f64 and rounded once to f32. Every ratio
//    is an f32 multiple of 2^-(23+ceil(log2 sum)), so the f64 sum is exact
//    for any realistic (S, coverage) and hence independent of the order of
//    summation (common.cuh);
//  - counts and sums are small integers held in f32 (exact).
//
// stats[g] = [iterations of this lane, q_last, failed, commits, 0, 0, 0, 0].
// phase_cycles (G, 6) int64, or null: thread 0's clock cycles in each
// phase (common.cuh PhaseClock): prologue (seed table, sums, first fill),
// range (the partials after a commit, and the end barrier's wait),
// candidates (prefetch issue, set upkeep, refills), scoring, decide (with
// the wait of the barrier after scoring: a clock read that follows a
// barrier issues before the barrier releases, so a wait counts in the
// phase after it), commit. table_out (G, 2D, S) f32, or null: the final
// table.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace pomfret;

// sites a lane scores per step, from one tile of 32 * kUnroll sites
constexpr int kUnroll = 2, kTile = 32 * kUnroll;
// a member's fields in the lists: its row slot, read, has_mmr bit, and the
// span [first, end) of the sites where its row holds a mer
enum Field { kSlot, kRead, kHm, kFirst, kEnd, kFields };
// per-row flags, from hp_init, has_mmr and seed_ok: not tagged 0 or 1 (a
// candidate once q_last reaches it), has_mmr, a seed, a seed of hap 1
constexpr uint8_t kUntagged = 1, kHasMmr = 2, kSeed = 4, kHap1 = 8;
// seed rows whose ids a thread loads at once
constexpr int kSeedRows = 16;

// Byte offsets of the slot arrays of one lane, from the start of their
// region (in shared memory, or the lane's part of a global buffer). NS =
// nc_cap + 1 row slots: up to n_slots members and one row in flight.
struct SlotLayout {
  unsigned acc, lt, lists, busy, fill, total;
};

__host__ __device__ inline SlotLayout slot_layout(unsigned NS) {
  SlotLayout L;
  unsigned o = 0;
  L.acc = o;   o += kWarps * 2 * NS * 8;      // [warp][hap][member] f64
  L.lt = o;    o += kWarps * 2 * NS * 4;      // [warp][hap][member] l_total
  L.lists = o; o += 2 * kFields * NS * 4;     // [parity][field][member]
  L.busy = o;  o += NS * 4;                   // slot in use (warp 0)
  L.fill = o;  o += 2 * NS * 4;               // rows and slots found (warp 0)
  L.total = align_up(o, 16);
  return L;
}

// Byte offsets into the dynamic shared memory of one block; a buffer whose
// placement bit (kSlotsShared, kSumsShared, kTableShared, kRowsShared) is
// clear takes no room there.
struct Layout {
  unsigned bar, nv, red, rowf, slots, sums, table, rows, total;
  SlotLayout sl;
};

__host__ __device__ inline Layout loop_layout(int R, int S, int D,
                                             int nc_cap, int id_bytes,
                                             int place) {
  const unsigned NS = static_cast<unsigned>(nc_cap) + 1;
  Layout L;
  L.sl = slot_layout(NS);
  unsigned o = 0;
  L.bar = o;   o += 16;                       // the mbarrier
  L.nv = o;    o += 2 * 4;                    // [parity] member count
  L.red = o;   o += 2 * kWarps * 4;           // range partials per warp
  L.rowf = o;  o += align_up(R, 16);          // per-row flags (kUntagged...)
  o = align_up(o, 16);
  L.slots = o;
  if (place & kSlotsShared) o += L.sl.total;
  o = align_up(o, 128);
  L.sums = o;
  if (place & kSumsShared) o += 2u * S * 4;
  L.table = o;
  if (place & kTableShared) o += 2u * D * S * 4;
  o = align_up(o, 128);
  L.rows = o;
  if (place & kRowsShared) o += align_up(NS * S * id_bytes, 16);
  L.total = o;
  return L;
}

struct LoopArgs {
  const void* ids;          // (G, R, S) IdT, -1 = absent
  const uint8_t* hm;        // (G, R) has_mmr
  const uint8_t* seed_ok;   // (G, R)
  const int32_t* scal;      // (G, 8) [min0, max0, cov, n_sites, n_reads,
                            //         q_break, n_cand, max_iters]
  const int32_t* hp_init;   // (G, R)
  float* cnt_g;             // (G, 2D, S) when the table is not shared
  float* sums_g;            // (G, 2, S) when the sums are not shared
  unsigned char* slots_g;   // (G, L.sl.total) when the slots are not shared
  int32_t* hp_out;          // (G, R)
  int32_t* stats;           // (G, 8)
  float* table_out;         // (G, 2D, S) or null
  long long* phase_cycles;  // (G, 6) or null
  int R, S, D, nc_cap, place, bulk;
  Layout L;
};

// Warp-wide: the first `need` rows q in [from, n) for which pred(q) holds,
// into out[]; returns how many (the same in every lane).
template <typename Pred>
__device__ __forceinline__ int gather_rows(int from, int n, int need,
                                           int* out, Pred pred) {
  const int lane = threadIdx.x & 31;
  int found = 0;
  for (int base = from; base < n && found < need; base += 32) {
    const int q = base + lane;
    const bool e = q < n && pred(q);
    const unsigned bal = __ballot_sync(kFull, e);
    const int rank = found + __popc(bal & ((1u << lane) - 1u));
    if (e && rank < need) out[rank] = q;
    found += __popc(bal);
  }
  __syncwarp();
  return min(found, need);
}

// Warp-wide: the first `need` free slots of busy[0, NS) into out[], marked
// busy (there are always enough: NS exceeds the members by one).
__device__ __forceinline__ void take_slots(int* busy, int NS, int need,
                                           int* out) {
  const int lane = threadIdx.x & 31;
  int found = 0;
  for (int base = 0; base < NS && found < need; base += 32) {
    const int k = base + lane;
    const bool e = k < NS && !busy[k];
    const unsigned bal = __ballot_sync(kFull, e);
    const int rank = found + __popc(bal & ((1u << lane) - 1u));
    if (e && rank < need) out[rank] = k;
    found += __popc(bal);
  }
  __syncwarp();
  for (int i = lane; i < need; i += 32) busy[out[i]] = 1;
  __syncwarp();
}

// Warp-wide: the span [first, end) of the sites of `row` that hold a mer
// (end <= first when none does).
template <typename IdT>
__device__ __forceinline__ int2 row_span(const IdT* row, int S) {
  int f = S, l = -1;
#pragma unroll 4
  for (int s = threadIdx.x & 31; s < S; s += 32) {  // no branch: pipelined
    const bool v = row[s] >= 0;
    f = v && f == S ? s : f;
    l = v ? s : l;
  }
  return make_int2(warp_min(f), warp_max(l) + 1);
}

template <typename IdT>
__global__ void __launch_bounds__(kThreads, 2) loop_kernel(const LoopArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout& L = a.L;
  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.R, S = a.S, D = a.D, NS = a.nc_cap + 1;
  const int32_t* sc = a.scal + static_cast<size_t>(g) * 8;
  const int min0 = sc[0], max0 = sc[1], cov = sc[2], n_sites = sc[3];
  const int n_reads = sc[4], q_break = sc[5], n_cand = sc[6];
  const int max_iters = sc[7];
  const int n_slots = min(n_cand, a.nc_cap);
  const float covf = static_cast<float>(cov);

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  unsigned char* sb = (a.place & kSlotsShared)
                          ? smem + L.slots
                          : a.slots_g + static_cast<size_t>(g) * L.sl.total;
  double* acc = reinterpret_cast<double*>(sb + L.sl.acc);  // score partials
  int* lt = reinterpret_cast<int*>(sb + L.sl.lt);
  double* acc_w = acc + warp * 2 * NS;  // this warp's
  int* lt_w = lt + warp * 2 * NS;
  int* lists = reinterpret_cast<int*>(sb + L.sl.lists);
  int* nvs = reinterpret_cast<int*>(smem + L.nv);
  int* fbw = reinterpret_cast<int*>(smem + L.red);
  int* lnbw = fbw + kWarps;
  int* busy = reinterpret_cast<int*>(sb + L.sl.busy);
  int* fill_rows = reinterpret_cast<int*>(sb + L.sl.fill);
  int* fill_slots = fill_rows + NS;
  uint8_t* rowf = smem + L.rowf;
  float* sum0 = (a.place & kSumsShared)
                    ? reinterpret_cast<float*>(smem + L.sums)
                    : a.sums_g + static_cast<size_t>(g) * 2 * S;
  float* sum1 = sum0 + S;
  float* cnt = (a.place & kTableShared)
                   ? reinterpret_cast<float*>(smem + L.table)
                   : a.cnt_g + static_cast<size_t>(g) * 2 * D * S;
  IdT* rowbuf = (a.place & kRowsShared) ? reinterpret_cast<IdT*>(smem + L.rows)
                                        : nullptr;
  const bool bulk = rowbuf != nullptr && a.bulk;
  const uint32_t row_bytes = static_cast<uint32_t>(S * sizeof(IdT));
  const IdT* lane_ids = static_cast<const IdT*>(a.ids) +
                        static_cast<size_t>(g) * R * S;
  const uint8_t* hm = a.hm + static_cast<size_t>(g) * R;
  const uint8_t* sok = a.seed_ok + static_cast<size_t>(g) * R;
  const int32_t* hp0 = a.hp_init + static_cast<size_t>(g) * R;
  int32_t* hp = a.hp_out + static_cast<size_t>(g) * R;
  PhaseClock clk(tid == 0 && a.phase_cycles ? a.phase_cycles + g * kPhases
                                            : nullptr);

  // rows at or after the cursor were never members, so their tags are
  // still hp_init's
  auto untagged = [&](int q) { return (rowf[q] & kUntagged) != 0; };
  // a member's row: its shared slot, or its ids row in global memory
  auto row_of = [&](int slot, int read) -> const IdT* {
    return rowbuf ? rowbuf + static_cast<size_t>(slot) * S
                  : lane_ids + static_cast<size_t>(read) * S;
  };
  // writes member `at` of a list (one thread)
  auto put = [&](int* list, int at, int slot, int read, int2 span) {
    list[kSlot * NS + at] = slot;
    list[kRead * NS + at] = read;
    list[kHm * NS + at] = (rowf[read] & kHasMmr) != 0;
    list[kFirst * NS + at] = span.x;
    list[kEnd * NS + at] = span.y;
  };

  // --- prologue: hp, the seed table (insert_ref_reads_methmer_counts,
  //     blockjoin.c:3776-3810), the sums and the first range partials ---
  for (int r = tid; r < R; r += kThreads) {
    const int h = hp0[r];
    hp[r] = h;
    const bool tagged = h == 0 || h == 1;
    rowf[r] = (tagged ? 0 : kUntagged) | (hm[r] ? kHasMmr : 0) |
              (tagged && hm[r] && sok[r] ? kSeed : 0) | (h == 1 ? kHap1 : 0);
  }
  for (int s = tid; s < S; s += kThreads)
    for (int d = 0; d < 2 * D; ++d) cnt[static_cast<size_t>(d) * S + s] = 0.f;
  for (int k = tid; k < NS; k += kThreads) busy[k] = 0;
  if (tid == 0) mbar_init(bar);
  uint32_t phase = 0;  // of the mbarrier, the same in every thread
  __syncthreads();
  if (bulk) {
    // the seeded rows, NS at a time, staged in the row slots by bulk
    // copies, then counted from shared memory
    auto seeded = [&](int q) { return (rowf[q] & kSeed) != 0; };
    int from = 0;  // warp 0's
    for (;;) {
      if (warp == 0) {
        const int k = gather_rows(from, R, NS, fill_rows, seeded);
        for (int i = lane; i < k; i += 32)
          fill_slots[i] = (rowf[fill_rows[i]] & kHap1) != 0;
        if (k > 0) {
          from = fill_rows[k - 1] + 1;
          if (lane == 0) {
            fence_proxy_async();
            mbar_arrive_expect_tx(bar, row_bytes * k);
          }
          __syncwarp();
          for (int i = lane; i < k; i += 32)
            bulk_g2s(rowbuf + static_cast<size_t>(i) * S,
                     lane_ids + static_cast<size_t>(fill_rows[i]) * S,
                     row_bytes, bar);
        }
        if (lane == 0) nvs[1] = k;
      }
      __syncthreads();
      const int k = nvs[1];
      if (k == 0) break;
      mbar_wait(bar, phase);
      phase ^= 1;
      for (int s = tid; s < S; s += kThreads)
        for (int i = 0; i < k; ++i) {
          const int id =
              static_cast<int>(rowbuf[static_cast<size_t>(i) * S + s]);
          if (id >= 0 && id < D)
            cnt[static_cast<size_t>(2 * id + fill_slots[i]) * S + s] += 1.f;
        }
      __syncthreads();  // the slots and the row lists are staged anew
    }
  } else {
    // kSeedRows rows at a time, so that their id loads are in flight
    // together before the table's updates
    for (int r0 = 0; r0 < R; r0 += kSeedRows) {
      int h[kSeedRows];
#pragma unroll
      for (int k = 0; k < kSeedRows; ++k) {
        const int f = r0 + k < R ? rowf[r0 + k] : 0;
        h[k] = f & kSeed ? (f & kHap1 ? 1 : 0) : -1;
      }
      for (int s = tid; s < S; s += kThreads) {
        int id[kSeedRows];
#pragma unroll
        for (int k = 0; k < kSeedRows; ++k)
          id[k] = h[k] >= 0
                      ? static_cast<int>(__ldg(
                            lane_ids + static_cast<size_t>(r0 + k) * S + s))
                      : -1;
#pragma unroll
        for (int k = 0; k < kSeedRows; ++k)
          if (id[k] >= 0 && id[k] < D)
            cnt[static_cast<size_t>(2 * id[k] + h[k]) * S + s] += 1.f;
      }
    }
  }
  int fb = S, lnb = -1;  // first blocked site right, last blocked left
  auto range_site = [&](int s, float t0, float t1) {
    const bool ok = (t0 + t1 >= covf) && s < n_sites;
    if ((!ok && s >= max0) || s >= n_sites) fb = min(fb, s);
    if (!ok && s <= min0 && min0 >= 0) lnb = max(lnb, s);
  };
  for (int s = tid; s < S; s += kThreads) {
    float t0 = 0.f, t1 = 0.f;
    for (int d = 0; d < D; ++d) {
      t0 += cnt[static_cast<size_t>(2 * d) * S + s];
      t1 += cnt[static_cast<size_t>(2 * d + 1) * S + s];
    }
    sum0[s] = t0;
    sum1[s] = t1;
    range_site(s, t0, t1);
  }
  fb = warp_min(fb);
  lnb = warp_max(lnb);
  if (lane == 0) {
    fbw[warp] = fb;
    lnbw[warp] = lnb;
  }
  __syncthreads();

  int q_last = 0, failed = 0, it = 0, ncom = 0;
  bool active = q_last < q_break && failed <= 10 && it < max_iters;
  // warp 0's candidate-set state (the same in each of its lanes)
  int cursor = 0, pending = -1;

  // Warp 0: tops list[] (nv members) up to n_slots with the next untagged
  // rows at or after max(cursor, q_last), copied into free slots.
  auto refill = [&](int* list, int nv) -> int {
    const int need = n_slots - nv;
    if (need <= 0) return nv;
    const int k = gather_rows(max(cursor, q_last), n_reads, need, fill_rows,
                              untagged);
    if (k == 0) return nv;
    if (rowbuf) take_slots(busy, NS, k, fill_slots);
    if (bulk) {
      if (lane == 0) {
        fence_proxy_async();
        mbar_arrive_expect_tx(bar, row_bytes * k);
      }
      __syncwarp();
      for (int i = lane; i < k; i += 32)
        bulk_g2s(rowbuf + static_cast<size_t>(fill_slots[i]) * S,
                 lane_ids + static_cast<size_t>(fill_rows[i]) * S, row_bytes,
                 bar);
      mbar_wait(bar, phase);
      phase ^= 1;
    } else if (rowbuf) {
      for (int i = 0; i < k; ++i) {
        IdT* dst = rowbuf + static_cast<size_t>(fill_slots[i]) * S;
        const IdT* src = lane_ids + static_cast<size_t>(fill_rows[i]) * S;
        for (int s = lane; s < S; s += 32) dst[s] = src[s];
      }
    }
    for (int i = 0; i < k; ++i) {
      const int q = fill_rows[i], slot = rowbuf ? fill_slots[i] : -1;
      const int2 sp = row_span(row_of(slot, q), S);
      if (lane == 0) put(list, nv + i, slot, q, sp);
    }
    cursor = fill_rows[k - 1] + 1;
    __syncwarp();
    return nv + k;
  };

  if (warp == 0) {
    const int nv = active ? refill(lists, 0) : 0;
    if (lane == 0) nvs[0] = nv;
  }
  __syncthreads();
  int lo, hi;
  auto read_range = [&]() {
    int f = fbw[0], l = lnbw[0];
    for (int w = 1; w < kWarps; ++w) {
      f = min(f, fbw[w]);
      l = max(l, lnbw[w]);
    }
    const int max_i = f > max0 ? f - 1 : max0;
    const int min_i =
        min0 < 0 ? min0 : (l == min0 ? min0 : (l >= 0 ? l + 1 : 0));
    lo = max(min_i, 0);
    hi = min(max_i, S);
  };
  read_range();
  clk.lap(kPrologue);

  while (active) {
    const int par = it & 1;
    const int nv = nvs[par];
    const int* l_slot = lists + par * kFields * NS;
    const int* l_read = l_slot + kRead * NS;
    const int* l_hm = l_slot + kHm * NS;
    const int* l_first = l_slot + kFirst * NS;
    const int* l_end = l_slot + kEnd * NS;

    // --- candidates (warp 0): free the last winner's slot, whose row the
    //     last commit read, and prefetch the next member's row ---
    int spec = -1, spec_slot = -1;
    if (warp == 0) {
      if (pending >= 0) {
        if (lane == 0) busy[pending] = 0;
        __syncwarp();
        pending = -1;
      }
      if (bulk &&
          gather_rows(max(cursor, q_last), n_reads, 1, fill_rows, untagged)) {
        spec = fill_rows[0];
        take_slots(busy, NS, 1, fill_slots);
        spec_slot = fill_slots[0];
        if (lane == 0) {
          fence_proxy_async();
          bulk_copy_g2s(rowbuf + static_cast<size_t>(spec_slot) * S,
                        lane_ids + static_cast<size_t>(spec) * S, row_bytes,
                        bar);
        }
      }
    }
    clk.lap(kCandidates);

    // --- scoring: the (member, kTile-site tile) pairs of each member's
    //     span within [lo, hi), split evenly over the warps; a lane's
    //     kUnroll sites of a tile are loaded together ---
    // member m's sites [from, end) and tiles, for lane m % 32 of a chunk
    auto span_of = [&](int m, int* from, int* end) {
      *from = m < nv ? max(lo, l_first[m]) : 0;
      *end = m < nv ? min(hi, l_end[m]) : 0;
      return *end > *from ? (*end - *from + kTile - 1) / kTile : 0;
    };
    int T = 0;  // all tiles, 32 members at a time
    for (int base = 0; base < nv; base += 32) {
      int f, e;
      T += warp_sum(span_of(base + lane, &f, &e));
    }
    const int t0 = static_cast<int>(static_cast<long long>(T) * warp / kWarps);
    const int t1 =
        static_cast<int>(static_cast<long long>(T) * (warp + 1) / kWarps);
    for (int j = lane; j < 2 * nv; j += 32) {  // members this warp skips
      acc_w[(j & 1) * NS + (j >> 1)] = 0.0;
      lt_w[(j & 1) * NS + (j >> 1)] = 0;
    }
    __syncwarp();
    for (int base = 0, cum = 0; base < nv && cum < t1; base += 32) {
      int from, end;
      const int nt = span_of(base + lane, &from, &end);
      int inc = nt;  // tiles of this chunk's members up to this lane's
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += v;
      }
      const int first = cum + inc - nt;  // this lane's member's first tile
      unsigned mine =
          __ballot_sync(kFull, nt > 0 && first < t1 && first + nt > t0);
      cum += __shfl_sync(kFull, inc, 31);
      while (mine) {  // the members whose tiles this warp scores
        const int k = __ffs(mine) - 1;
        mine &= mine - 1;
        const int m = base + k;
        const int mf = __shfl_sync(kFull, from, k);
        const int me = __shfl_sync(kFull, end, k);
        const int mfirst = __shfl_sync(kFull, first, k);
        const int mnt = __shfl_sync(kFull, nt, k);
        const int ta = max(t0 - mfirst, 0), tb = min(mnt, t1 - mfirst);
        const IdT* row = row_of(l_slot[m], l_read[m]);
        Score r{0.0, 0.0, 0, 0, 0, 0};
        for (int tile = ta; tile < tb; ++tile) {
          const int b = mf + tile * kTile + lane;
          int id[kUnroll];
          float c0[kUnroll], c1[kUnroll], u0[kUnroll], u1[kUnroll];
#pragma unroll
          for (int q = 0; q < kUnroll; ++q) {
            const int s = b + 32 * q;
            id[q] = s < me ? static_cast<int>(row[s]) : -1;
          }
#pragma unroll
          for (int q = 0; q < kUnroll; ++q) {
            const int s = b + 32 * q;
            const bool v = id[q] >= 0 && id[q] < D;
            const size_t o = static_cast<size_t>(2 * (v ? id[q] : 0)) * S +
                             (v ? s : 0);
            c0[q] = v ? cnt[o] : 0.f;
            c1[q] = v ? cnt[o + S] : 0.f;
            u0[q] = v ? sum0[s] : 0.f;
            u1[q] = v ? sum1[s] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < kUnroll; ++q)
            score_cells(r, c0[q], c1[q], u0[q], u1[q]);
        }
        const double a0 = warp_sum(r.a0), a1 = warp_sum(r.a1);
        const int n0 = warp_sum(r.f0 + r.nz0);
        const int n1 = warp_sum(r.f1 + r.nz1);
        if (lane == 0) {  // a warp scores one run of tiles of a member
          acc_w[m] = a0;
          acc_w[NS + m] = a1;
          lt_w[m] = n0;
          lt_w[NS + m] = n1;
        }
      }
    }
    __syncthreads();
    clk.lap(kScoring);

    // --- decide (blockjoin.c:3645-3765), in every warp: the committable
    //     member of largest diff, ties to the highest read ---
    // each member's scores: its warps' exact partials, added in any order
    auto score_of = [&](int j, float* s0, float* s1, int* n0, int* n1) {
      double a0 = 0.0, a1 = 0.0;
      int c0 = 0, c1 = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        a0 += acc[w * 2 * NS + j];
        a1 += acc[w * 2 * NS + NS + j];
        c0 += lt[w * 2 * NS + j];
        c1 += lt[w * 2 * NS + NS + j];
      }
      *s0 = __double2float_rn(a0);
      *s1 = __double2float_rn(a1);
      *n0 = c0;
      *n1 = c1;
    };
    float best = -1.f, best_s0 = 0.f, best_s1 = 0.f;
    int best_read = -1, bj = -1;
    for (int j = lane; j < nv; j += 32) {
      float s0, s1;
      int n0, n1;
      score_of(j, &s0, &s1, &n0, &n1);
      const float diff = fabsf(s0 - s1);
      const bool ok = !(diff < 3.f && (n0 < 3 || n1 < 3)) && l_hm[j];
      const int rd = l_read[j];
      if (ok && (diff > best || (diff == best && rd > best_read))) {
        best = diff;
        best_read = rd;
        bj = j;
        best_s0 = s0;
        best_s1 = s1;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, o);
      const int orr = __shfl_xor_sync(kFull, best_read, o);
      const int oj = __shfl_xor_sync(kFull, bj, o);
      const float o0 = __shfl_xor_sync(kFull, best_s0, o);
      const float o1 = __shfl_xor_sync(kFull, best_s1, o);
      if (ob > best || (ob == best && orr > best_read)) {
        best = ob;
        best_read = orr;
        bj = oj;
        best_s0 = o0;
        best_s1 = o1;
      }
    }
    const bool commit = best >= 0.f;
    const int tag = commit && !(best_s0 > best_s1) ? 1 : 0;
    clk.lap(kDecide);

    // --- commit the winner's mers into the table; each thread then has the
    //     range partials of the sites it owns ---
    if (commit) {
      const IdT* row = row_of(l_slot[bj], best_read);
      float* st = tag ? sum1 : sum0;
      fb = S;
      lnb = -1;
      for (int s = tid; s < S; s += kThreads) {
        const int id = static_cast<int>(row[s]);
        if (id >= 0 && id < D) {
          cnt[static_cast<size_t>(2 * id + tag) * S + s] += 1.f;
          st[s] += 1.f;
        }
        range_site(s, sum0[s], sum1[s]);
      }
      clk.lap(kCommit);
      fb = warp_min(fb);
      lnb = warp_max(lnb);
      if (lane == 0) {
        fbw[warp] = fb;
        lnbw[warp] = lnb;
      }
      clk.lap(kRange);
    }
    // --- failure bookkeeping (blockjoin.c:4046-4070), in every thread ---
    if (commit) {
      failed = 0;
      ++ncom;
    } else {
      ++failed;
      q_last += n_cand;
    }
    ++it;
    active = q_last < q_break && failed <= 10 && it < max_iters;

    // --- warp 0: the next iteration's candidate set ---
    if (warp == 0) {
      if (commit && lane == 0) hp[best_read] = tag;
      int* next = lists + (par ^ 1) * kFields * NS;
      // the members that stay: all but the winner, or those >= q_last
      int nvn = 0;
      for (int base = 0; base < nv; base += 32) {
        const int j = base + lane;
        bool keep = false;
        if (j < nv) {
          keep = commit ? j != bj : l_read[j] >= q_last;
          if (!keep && !commit && rowbuf) busy[l_slot[j]] = 0;
        }
        const unsigned bal = __ballot_sync(kFull, keep);
        const int at = nvn + __popc(bal & ((1u << lane) - 1u));
        if (keep)
          for (int f = 0; f < kFields; ++f)
            next[f * NS + at] = l_slot[f * NS + j];
        nvn += __popc(bal);
      }
      if (commit && rowbuf) pending = l_slot[bj];  // freed next iteration
      __syncwarp();
      if (spec_slot >= 0) {  // adopt the prefetched row if it is still next
        mbar_wait(bar, phase);
        phase ^= 1;
        const int nxt = gather_rows(max(cursor, q_last), n_reads, 1,
                                    fill_rows, untagged)
                            ? fill_rows[0]
                            : -1;
        if (active && nvn < n_slots && nxt == spec) {
          const int2 sp = row_span(row_of(spec_slot, spec), S);
          if (lane == 0) put(next, nvn, spec_slot, spec, sp);
          ++nvn;
          cursor = spec + 1;
        } else if (lane == 0) {
          busy[spec_slot] = 0;
        }
        __syncwarp();
      }
      if (active) nvn = refill(next, nvn);  // what the speculation missed
      if (lane == 0) nvs[par ^ 1] = nvn;
    }
    clk.lap(kCandidates);
    __syncthreads();
    if (commit) read_range();
    clk.lap(kRange);
  }

  if (tid == 0) {
    int32_t* o = a.stats + static_cast<size_t>(g) * 8;
    o[0] = it;
    o[1] = q_last;
    o[2] = failed;
    o[3] = ncom;
    o[4] = o[5] = o[6] = o[7] = 0;
  }
  if (a.table_out) {
    float* out = a.table_out + static_cast<size_t>(g) * 2 * D * S;
    for (int i = tid; i < 2 * D * S; i += kThreads) out[i] = cnt[i];
  }
  clk.store();
}

template <typename IdT>
int launch(const LoopArgs& a, int G, cudaStream_t st) {
  static std::atomic<unsigned long long> opted{0};  // devices, by bit
  const int rc = allow_optin(loop_kernel<IdT>, opted);
  if (rc != 0) return rc;
  loop_kernel<IdT><<<G, kThreads, a.L.total, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which buffers of a lane go to shared memory at this shape: the slot
// arrays (score partials, member lists, slot and fill lists), then the
// sums, then the count table, then the candidate rows, each while the
// block's total fits the opt-in maximum of the current device. Writes the
// kSlotsShared | kSumsShared | kTableShared | kRowsShared bits, the block's
// dynamic shared memory and the bytes of one lane's slot arrays; returns a
// CUDA error code (0 on success).
extern "C" int pomfret_loop_plan(int id_bytes, int R, int S, int D,
                                 int nc_cap, int* place, int* smem_bytes,
                                 int* slot_bytes) {
  int optin = 0;
  const int rc = optin_bytes(&optin);
  if (rc != 0) return rc;
  const int bits[4] = {kSlotsShared, kSumsShared, kTableShared, kRowsShared};
  int p = 0;
  for (int b : bits)
    if (loop_layout(R, S, D, nc_cap, id_bytes, p | b).total <=
        static_cast<unsigned>(optin))
      p |= b;
  const Layout L = loop_layout(R, S, D, nc_cap, id_bytes, p);
  if (L.total > static_cast<unsigned>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  *place = p;
  *smem_bytes = static_cast<int>(L.total);
  *slot_bytes = static_cast<int>(L.sl.total);
  return 0;
}

// Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int pomfret_loop_launch(int id_bytes, const void* ids,
                                   const void* hm, const void* seed_ok,
                                   const void* scal, const void* hp_init,
                                   void* cnt, void* sums, void* slots,
                                   void* hp_out, void* stats,
                                   void* table_out, void* phase_cycles,
                                   int G, int R, int S, int D, int nc_cap,
                                   int place, int bulk, void* stream) {
  if (G <= 0) return 0;
  const LoopArgs a{ids,
                   static_cast<const uint8_t*>(hm),
                   static_cast<const uint8_t*>(seed_ok),
                   static_cast<const int32_t*>(scal),
                   static_cast<const int32_t*>(hp_init),
                   static_cast<float*>(cnt),
                   static_cast<float*>(sums),
                   static_cast<unsigned char*>(slots),
                   static_cast<int32_t*>(hp_out),
                   static_cast<int32_t*>(stats),
                   static_cast<float*>(table_out),
                   static_cast<long long*>(phase_cycles),
                   R, S, D, nc_cap, place, bulk,
                   loop_layout(R, S, D, nc_cap, id_bytes, place)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (id_bytes == 1) return launch<int8_t>(a, G, st);
  if (id_bytes == 4) return launch<int32_t>(a, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pomfret_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
