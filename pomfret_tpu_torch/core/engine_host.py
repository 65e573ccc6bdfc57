"""Host (numpy) oracle for the iterative meth-phasing engine.

Implements blockjoin.c:3453-3810 + 3958-4214 with exact float32 semantics:
per-read haplotype scores are float32 sums of count ratios accumulated in
methmer order, matching the C accumulation order bit-for-bit. The device
engine (kernels/engine_torch.py) is validated against this oracle.

Score quirk preserved: score_l counts found-with-nonzero-sum entries ONCE and
then nonzero ratios a SECOND time (blockjoin.c:3619-3636).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .fisher import kt_fisher_exact
from .methmer import Methmers, store_mmr_of_reads, wipe_mmr_of_reads
from .readset import ReadSet, UINT32_MAX

HARD_COV_THRESHOLD = 15          # blockjoin.c:20
HARD_CONTAMINATE_THRESHOLD = 5   # blockjoin.c:21
EVAL_P_THRE = 0.001              # blockjoin.c:24

F32 = np.float32


class Drand48:
    """Bit-exact replica of glibc drand48() (POSIX 48-bit LCG).

    The reference's permutation path shuffles with ks_shuffle (ksort.h:260-268)
    which draws from the process-global drand48 stream; srand48 is never
    called. POSIX documents the unseeded state as X0 = 0x1234ABCD330E, but
    glibc's __drand48_iterate only initializes the multiplier/addend and
    leaves the zero-initialized static X untouched, so on Linux the stream
    the reference actually sees starts from X0 = 0 (first draw = 0xB/2^48 =
    3.907985e-14; verified against libc).
    """

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, x0: int = 0):
        self.x = x0 & self.MASK

    @classmethod
    def from_srand48(cls, seed: int) -> "Drand48":
        """glibc srand48 semantics: X = seed<<16 | 0x330E. Used to give each
        gap an independent, distribution-invariant permutation stream (the
        process-global stream's position would depend on which host scored
        which earlier gaps — see PARITY.md X7)."""
        return cls(((seed & 0xFFFFFFFF) << 16) | 0x330E)

    def next(self) -> float:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x / float(1 << 48)


_drand48 = Drand48()


def reset_drand48() -> None:
    """Reset the module-global stream to process start (test hook)."""
    global _drand48
    _drand48 = Drand48()


def ks_shuffle(a: List[int], rng: Drand48 = None) -> None:
    """Fisher-Yates exactly as ks_shuffle (ksort.h:260-268): j is drawn as
    (int)(drand48()*i) and swapped with a[i-1], i from n down to 2."""
    if rng is None:
        rng = _drand48
    for i in range(len(a), 1, -1):
        j = int(rng.next() * i)
        a[j], a[i - 1] = a[i - 1], a[j]


def permute_haplotags(rs: ReadSet, ids: List[int], n: int,
                      rng: Drand48 = None) -> int:
    """Swap up to n reads per haplotype between hap0<->hap1
    (permute_haplotags, blockjoin.c:3812-3854). Returns 0 if anything could
    be attempted, 1 if the ID list was empty. buf entries are indices into
    `ids`, and hap0's shuffle consumes the drand48 stream before hap1's."""
    buf_hap = ([], [])
    n = min(n, len(ids))
    if n == 0:
        return 1
    for i, rid in enumerate(ids):
        hp = rs.reads[rid].hp
        if hp == 0:
            buf_hap[0].append(i)
        elif hp == 1:
            buf_hap[1].append(i)
    ks_shuffle(buf_hap[0], rng)
    ks_shuffle(buf_hap[1], rng)
    for i in range(min(len(buf_hap[0]), n)):
        rs.reads[ids[buf_hap[0][i]]].hp = 1
    for i in range(min(len(buf_hap[1]), n)):
        rs.reads[ids[buf_hap[1][i]]].hp = 0
    return 0


class CountTable:
    """Per-site methmer -> per-hap counts (mmr_t, blockjoin.c:3106-3110)."""

    def __init__(self, n_sites: int):
        self.maps: List[dict] = [dict() for _ in range(n_sites)]
        self.sums = np.zeros((n_sites, 2), dtype=np.int64)

    def wipe(self) -> None:
        for m in self.maps:
            m.clear()
        self.sums[:] = 0

    def insert(self, mmr, n_mmr: int, start_i: int, hap: int) -> None:
        for i0 in range(n_mmr):
            i = start_i + i0
            key = int(mmr[i0])
            cnts = self.maps[i].get(key)
            if cnts is None:
                cnts = [0, 0]
                self.maps[i][key] = cnts
            cnts[hap] += 1
            self.sums[i, hap] += 1

    def query_ratios(self, mmr, n_mmr: int, start_i: int, hap: int,
                     min_i: int, max_i: int) -> List[np.float32]:
        out = []
        for i0 in range(n_mmr):
            i = start_i + i0
            if i < min_i or i >= max_i:
                continue
            cnts = self.maps[i].get(int(mmr[i0]))
            if cnts is None:
                continue
            s = self.sums[i, hap]
            if s == 0:
                continue
            out.append(F32(F32(cnts[hap]) / F32(s)))
        return out


def predict_tag_for_one_read(read, table: CountTable, ms: Methmers,
                             score_diff_min: float, score_l_min: int
                             ) -> Tuple[int, np.float32]:
    """use_mmr_count_predict_tag_for_one_read (blockjoin.c:3594-3656).
    Returns (tag, score_diff); tag -1 when untagged."""
    scores = []
    lens = []
    for hap in (0, 1):
        ratios = table.query_ratios(read.mmr, read.mmr_n, read.mmr_start_i,
                                    hap, ms.mmr_min_i, ms.mmr_max_i)
        s = F32(0)
        l = len(ratios)
        for r in ratios:
            if r > 0:
                s = F32(s + r)
                l += 1
        scores.append(s)
        lens.append(l)
    score0, score1 = scores
    diff = F32(score0 - score1) if score0 > score1 else F32(score1 - score0)
    if diff < score_diff_min and (lens[0] < score_l_min or lens[1] < score_l_min):
        return -1, F32(0)
    return (0 if score0 > score1 else 1), diff


def update_available_methmer_range(table: CountTable, ms: Methmers,
                                   cov: int) -> int:
    """blockjoin.c:3669-3691 — extend [mmr_min_i, mmr_max_i] while total
    inserted coverage >= cov. Note max_i update keeps the LAST satisfying
    index (which the exclusive query bound then excludes)."""
    updated = 0
    i = ms.mmr_min_i
    while i >= 0:
        if table.sums[i, 0] + table.sums[i, 1] >= cov:
            ms.mmr_min_i = i
            updated += 1
            i -= 1
        else:
            break
    i = ms.mmr_max_i
    while i < ms.n:
        if table.sums[i, 0] + table.sums[i, 1] >= cov:
            ms.mmr_max_i = i
            updated += 1
            i += 1
        else:
            break
    return updated


def insert_ref_reads_methmer_counts(rs: ReadSet, table: CountTable,
                                    ms: Methmers, ref_ids, cov: int) -> None:
    # blockjoin.c:3776-3810
    table.wipe()
    for rid in ref_ids:
        r = rs.reads[rid]
        if r.hp in (0, 1) and r.mmr_start_i != UINT32_MAX:
            table.insert(r.mmr, r.mmr_n, r.mmr_start_i, r.hp)
    update_available_methmer_range(table, ms, cov)


def predict_tags_of_reads(rs: ReadSet, table: CountTable, ms: Methmers,
                          read_ids: List[int], insert_best_n: int,
                          cov: int, score_diff_min: float, score_l_min: int
                          ) -> int:
    """blockjoin.c:3693-3774: score candidates, stable-sort by score, commit
    the best insert_best_n reads (ties -> latest in candidate order)."""
    scored = []
    for idx, rid in enumerate(read_ids):
        tag, s = predict_tag_for_one_read(rs.reads[rid], table, ms,
                                          score_diff_min, score_l_min)
        scored.append((s, tag, rid, idx))
    # ks_mergesort is stable ascending by score only
    order = sorted(range(len(scored)), key=lambda i: scored[i][0])
    n = 0
    for oi in range(len(order) - 1, -1, -1):
        s, tag, rid, _ = scored[order[oi]]
        r = rs.reads[rid]
        if tag in (0, 1) and r.mmr_start_i != UINT32_MAX:
            r.hp = tag
            table.insert(r.mmr, r.mmr_n, r.mmr_start_i, tag)
            n += 1
            if n == insert_best_n:
                break
    if n > 0:
        update_available_methmer_range(table, ms, cov)
    return n


def haplotag_region1(rs: ReadSet, table: CountTable, ms: Methmers,
                     n_candidates_per_iter: int, min_mmr_recruit_cov: int,
                     direction: int) -> None:
    """The greedy one-read-per-iteration extension loop
    (blockjoin.c:3958-4080)."""
    n = rs.n
    if direction == 0:
        ms.mmr_min_i = 0
        ms.mmr_max_i = 0
        ref_ids = rs.ids_left
        # extend max over sites at/left of the gap start
        for i in range(ms.mmr_max_i, ms.n):
            if ms.sites_real_poss[i] <= rs.ref_start:
                ms.mmr_max_i += 1
            else:
                break
    else:
        ms.mmr_min_i = ms.n - 1
        ms.mmr_max_i = ms.n - 1
        ref_ids = rs.ids_right
        for i in range(ms.mmr_min_i, -1, -1):
            if ms.sites_real_poss[i] > rs.ref_end:
                ms.mmr_min_i -= 1
            else:
                break

    insert_ref_reads_methmer_counts(rs, table, ms, ref_ids, min_mmr_recruit_cov)

    # step 1.5: wipe everything except ref-side reads; note hp&3 truncation
    # (HAPTAG_UNPHASED=254 -> 2), blockjoin.c:4013-4024
    saved = [(rid, rs.reads[rid].hp & 3) for rid in ref_ids]
    rs.set_all_as_unphased()
    for rid, hp in saved:
        rs.reads[rid].hp = hp

    i_last_untagged = 0 if direction == 0 else n - 1
    increment = 1 if direction == 0 else -1
    failed = 0
    while True:
        if (direction == 0 and i_last_untagged >= n) or (direction != 0 and i_last_untagged <= 0):
            break
        cand: List[int] = []
        i0 = i_last_untagged
        while (i0 < n) if direction == 0 else (i0 >= 0):
            rid = i0 if direction == 0 else rs.rev_order[i0]
            if rs.reads[rid].hp not in (0, 1):
                cand.append(rid)
                if len(cand) >= n_candidates_per_iter:
                    break
            i0 += increment
        if not cand:
            failed += 1
            if failed > 10:
                break
            i_last_untagged += n_candidates_per_iter * increment
            continue
        inserted = predict_tags_of_reads(rs, table, ms, cand, 1,
                                         min_mmr_recruit_cov, 3, 3)
        if inserted == 0:
            failed += 1
            if failed > 10:
                break
            i_last_untagged += n_candidates_per_iter * increment
            continue
        failed = 0


def evaluate_ref_sanity(rs: ReadSet, which_side: int) -> Tuple[float, int]:
    """Boundary haplotype balance ratio (blockjoin.c:3868-3880). Computed and
    logged by the reference but NOT gating (the `if (1)` at blockjoin.c:4291).
    Returns (ratio, valid)."""
    ids = rs.ids_left if which_side == 0 else rs.ids_right
    cnt = [0.0, 0.0]
    for rid in ids:
        hp = rs.reads[rid].hp
        if hp == 0:
            cnt[0] += 1
        elif hp == 1:
            cnt[1] += 1
    lo = min(cnt)
    r = float("inf") if lo == 0 else max(cnt) / lo
    return r, 0 if r > 1.2 else 1


def evaluate_separation1(ref: np.ndarray, query: np.ndarray
                         ) -> Tuple[float, int]:
    """2x2 contingency + ratio gates + Fisher (blockjoin.c:3881-3938).
    Returns (score, join_dir); join_dir -9 on failure."""
    buf = np.zeros((2, 2), dtype=np.int64)
    for a, b in zip(ref, query):
        if a in (0, 1) and b in (0, 1):
            buf[a, b] += 1
    hard_cov_fail = (min(buf[0, 0], buf[0, 1]) > HARD_COV_THRESHOLD
                     or min(buf[1, 0], buf[1, 1]) > HARD_COV_THRESHOLD)
    which_way = 0
    scores = [0.0, 0.0]
    for i in (0, 1):
        if buf[i, 0] > buf[i, 1]:
            lo, hi = buf[i, 1], buf[i, 0]
            which_way += 1 if i == 0 else -1
        else:
            lo, hi = buf[i, 0], buf[i, 1]
            which_way += -1 if i == 0 else 1
        if (min(buf[0, 0], buf[0, 1]) > HARD_CONTAMINATE_THRESHOLD
                or min(buf[1, 0], buf[1, 1]) > HARD_CONTAMINATE_THRESHOLD):
            return 1.0, -9
        if hi == 0:
            return 1.0, -9
        lo = 1 if lo == 0 else lo
        if hi / lo < 3:
            return 1.0, -9
        scores[i] = float(F32(F32(hi) / F32(lo)))
    _, _, two = kt_fisher_exact(int(buf[0, 0]), int(buf[0, 1]),
                                int(buf[1, 0]), int(buf[1, 1]))
    if two < EVAL_P_THRE and not hard_cov_fail:
        return min(scores), which_way
    return 1.0, -9


def evaluate_separation(rs: ReadSet, raw_tags: np.ndarray, which_side: int
                        ) -> Tuple[float, int]:
    # blockjoin.c:3940-3956 — strict boundary reads on `which_side`
    ids = rs.ids_left_strict if which_side == 0 else rs.ids_right_strict
    ref = np.array([raw_tags[rid] for rid in ids], dtype=np.uint8)
    query = np.array([rs.reads[rid].hp & 0xFF for rid in ids], dtype=np.uint8)
    return evaluate_separation1(ref, query)


def vote_permutations(n_permutations: int,
                      evals: List[Tuple[float, int]]) -> Tuple[int, int]:
    """The summarize step of haplotag_region2 (blockjoin.c:4145-4206).

    evals holds (score, which_way) per permutation run. Returns
    (ret in {0 cis, 1 trans, -1 no-join}, index of the winning run or -1).
    With n_permutations>5 the majority rule applies; otherwise best-score
    with cis preferred."""
    threshold = n_permutations // 2
    threshold_blank = n_permutations // 3
    dir_cnt = [0, 0, 0]
    best_score = [1.0, 1.0]
    best_i = [-1, -1]
    for i, (score, which_way) in enumerate(evals):
        if score >= 2 and which_way not in (-9, 0):
            way = 0 if which_way > 0 else 1
            dir_cnt[1 + way] += 1
            if score > best_score[way]:
                best_score[way] = score
                best_i[way] = i
        else:
            dir_cnt[0] += 1
    if n_permutations > 5:
        if (dir_cnt[1] >= threshold and dir_cnt[2] <= 3
                and dir_cnt[0] < threshold_blank and best_i[0] >= 0):
            return 0, best_i[0]
        if (dir_cnt[2] >= threshold and dir_cnt[1] <= 3
                and dir_cnt[0] < threshold_blank and best_i[1] >= 0):
            return 1, best_i[1]
        return -1, -1
    if best_i[0] >= 0:
        return 0, best_i[0]
    if best_i[1] >= 0:
        return 1, best_i[1]
    return -1, -1


def make_permutation_seeds(rs: ReadSet, ext_direction: int,
                           n_permutations: int, rng: Drand48 = None
                           ) -> Tuple[List[np.ndarray], bool]:
    """Seed-tag vectors for the permutation runs of haplotag_region2: run 0
    uses the initial tags; each later run permutes up to 5 boundary reads
    per haplotype starting from the restored initial state
    (blockjoin.c:4115-4134). Consumes the (glibc-exact) drand48 stream in
    the same order the reference would. Returns (seeds, err_permutation)."""
    initial = rs.store_haplotags()
    seeds = [initial.copy()]
    err = False
    for _ in range(1, n_permutations):
        ids = rs.ids_left if ext_direction == 0 else rs.ids_right
        if permute_haplotags(rs, ids, 5, rng):
            err = True
            break
        seeds.append(rs.store_haplotags())
        rs.restore_haplotags(initial)
    rs.restore_haplotags(initial)
    return seeds, err


def haplotag_region2(rs: ReadSet, table: CountTable, ms: Methmers,
                     ext_direction: int, n_candidates_per_iter: int,
                     min_mmr_recruit_cov: int, n_permutations: int,
                     do_reset: bool, rng: Drand48 = None) -> int:
    """Wrapper with permutation voting (haplotag_region2,
    blockjoin.c:4088-4214). Returns 0 cis / 1 trans / -1 no-join.

    The reference main path passes n_permutation=1 (blockjoin.c:4675), which
    makes the loop a single deterministic run; with n_permutations>1, each
    extra run first swaps up to 5 boundary reads per haplotype from the
    restored initial state, and the summary takes the majority
    (blockjoin.c:4164-4186) when n_permutations>5, else best-score-wins with
    cis preferred (blockjoin.c:4188-4206)."""
    initial_state = rs.store_haplotags()
    # a failed permute (empty boundary list) breaks the C loop after the
    # already-completed runs; those runs' results are then discarded by the
    # err path below, exactly like blockjoin.c:4117-4163
    seeds, err_permutation = make_permutation_seeds(rs, ext_direction,
                                                    n_permutations, rng)
    bufs: List[np.ndarray] = []
    evals: List[Tuple[float, int]] = []
    for seed in seeds:
        rs.restore_haplotags(seed)
        haplotag_region1(rs, table, ms, n_candidates_per_iter,
                         min_mmr_recruit_cov, ext_direction)
        bufs.append(rs.store_haplotags())
        evals.append(evaluate_separation(
            rs, initial_state, 1 if ext_direction == 0 else 0))
        rs.restore_haplotags(initial_state)

    if err_permutation:
        # blockjoin.c:4160-4163: bail, tags stay at the initial state
        if do_reset:
            rs.restore_haplotags(initial_state)
        return -1

    ret, chosen = vote_permutations(n_permutations, evals)
    if ret >= 0:
        rs.restore_haplotags(bufs[chosen])
    else:
        rs.restore_haplotags(initial_state)
        rs.set_all_as_unphased()
    if do_reset:
        rs.restore_haplotags(initial_state)
    return ret


def haplotag_region(rs: ReadSet, ms_fwd: Methmers, ms_bwd: Methmers,
                    n_candidates_per_iter: int, cov_for_runtime: int,
                    n_permutations: int = 1, rng: Drand48 = None) -> int:
    """Both directions + agreement gate (haplotag_region_given_bam core,
    blockjoin.c:4288-4320). The caller loads reads/methmers; on agreement the
    read set retains the forward tagging. `rng` (when permuting) is shared
    bwd-then-fwd, matching the C's global-stream consumption order within a
    gap; the pipeline passes a per-gap srand48 stream (PARITY.md X7)."""
    store_mmr_of_reads(rs, ms_bwd)
    table_bwd = CountTable(ms_bwd.n)
    join2 = haplotag_region2(rs, table_bwd, ms_bwd, 1, n_candidates_per_iter,
                             cov_for_runtime, n_permutations, True, rng)
    wipe_mmr_of_reads(rs)
    store_mmr_of_reads(rs, ms_fwd)
    table_fwd = CountTable(ms_fwd.n)
    join1 = haplotag_region2(rs, table_fwd, ms_fwd, 0, n_candidates_per_iter,
                             cov_for_runtime, n_permutations, False, rng)
    if join1 != join2 or (join1 == -1 and join2 == -1):
        rs.set_all_as_unphased()
        return -1
    return join1
