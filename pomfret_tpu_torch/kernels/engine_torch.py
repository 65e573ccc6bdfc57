"""Host-side packing and orchestration of the batched device engine.

Counterpart of pomfret_tpu/kernels/engine_jax.py. The packing code there is
numpy only, but that module imports jax at the top, so it is copied here:
GapDeviceData, _grid_from_arrays, _scan_perm, build_gap_device_data,
_bucket_dim, _bucket_lanes, _reseeded and pack_group produce arrays equal
to engine_jax's (tests/test_torch_pack.py). run_jobs_batched,
run_gaps_batched and _drain_group drive the port's dispatch
(parallel/batch.py) with the same plan, prefetch producer, pipe depth and
first-wins merge order as engine_jax's, and hold less while they do
(ROADMAP.md, queue 3): the previous chromosome's source goes before the
next one's decode, the producer holds no loaded group beyond its
prefetch depth, and a dispatched group keeps only what its decision
reads. run_gap is run_gap_jax, one gap at a time
(tests/test_torch_run_gap.py).

Unlike engine_jax, a failed device group is not recomputed on the host
oracle: it raises (see ROADMAP.md, queue 3).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..core.engine_host import evaluate_separation
from ..core.methmer import (Methmers, get_methmer_sites_and_ranges,
                            store_mmr_of_reads, wipe_mmr_of_reads)
from ..core.readset import (READBACK, MmrConfig, ReadSet,
                            load_reads_given_interval)

INVALID_ID = -1


# ---------------------------------------------------------------------------
# host-side packing (engine_jax.py:64-300)
# ---------------------------------------------------------------------------

@dataclass
class GapDeviceData:
    """Per-(gap, direction) arrays for the device loop.

    Reads are stored PERMUTED into candidate-scan order (fwd: BAM order;
    bwd: descending end-position order); `perm` maps device row -> original
    read id. The mer-id grid ships dense (`ids` (R, S), -1 = absent) or as
    128-site runs (`blk` (R, CB) uint8 of id+1 over blocks [b0, b0+CB/128),
    `ids` None), which the device densifies (parallel/batch.densify_runs).
    """
    ids: Optional[np.ndarray]  # (R, S) int8/int32, -1 = absent; or None
    has_mmr: np.ndarray    # (R,) bool
    hp_init: np.ndarray    # (R,) int32 — post-wipe tags (step 1.5)
    seed_ok: np.ndarray    # (R,) bool — RAW haptag was 0/1 (may seed counts)
    perm: np.ndarray       # (R,) int32 — device row -> original read id
    n_reads: int
    n_sites: int
    max_d: int             # dense dictionary capacity actually used
    q_break: int
    min0: int
    max0: int
    R: int = 0             # padded row count (== ids.shape[0] when dense)
    S: int = 0             # padded site count (== ids.shape[1] when dense)
    blk: Optional[np.ndarray] = None   # (R, CB) uint8, id+1, 0 = absent
    b0: Optional[np.ndarray] = None    # (R,) int32 first block, -1 = none

    def __post_init__(self):
        if self.ids is not None and not self.R:
            self.R, self.S = self.ids.shape

    def dense_ids(self) -> np.ndarray:
        """Dense (R, S) grid from either layout (host-side)."""
        if self.ids is not None:
            return self.ids
        # the runs layout holds ids up to 254 (id+1 in uint8)
        dt = np.int8 if self.max_d <= 127 else np.int16
        ids = np.full((self.R, self.S), -1, dtype=dt)
        cb = self.blk.shape[1]
        for r in np.flatnonzero(self.b0 >= 0):
            s0 = int(self.b0[r]) * 128
            hi = min(s0 + cb, self.S)
            if hi > s0:
                ids[r, s0:hi] = (self.blk[r, : hi - s0].astype(np.int16)
                                 - 1).astype(dt)
        return ids


def _grid_from_arrays(read_rows: np.ndarray, lens: np.ndarray,
                      start_is: np.ndarray, keys: np.ndarray,
                      inv_perm: np.ndarray, R: int, SP: int):
    """Dense per-site mer-id grid from per-read methmer arrays.

    read_rows/lens/start_is: one entry per read WITH methmers (original
    read ids, run lengths, first site indices); keys: their methmers
    concatenated in read order. Returns (ids, has_mmr, max_d)."""
    has_mmr = np.zeros(R, dtype=bool)
    if len(read_rows) == 0:
        return np.full((R, SP), INVALID_ID, dtype=np.int8), has_mmr, 1
    total = int(lens.sum())
    run_start = np.repeat(np.cumsum(lens) - lens, lens)
    rrow = np.repeat(read_rows, lens)
    scol = (np.repeat(start_is, lens)
            + np.arange(total, dtype=np.int64) - run_start)
    keys = keys.astype(np.int64)
    seq = np.arange(len(keys), dtype=np.int64)
    # a (site, key) pair's dense id is its first-appearance rank within the
    # site, matching the insertion order of the reference's per-site linear
    # dictionaries (mmr_t insert, blockjoin.c:3453-3486)
    order = np.lexsort((seq, keys, scol))
    ss, ks, qs = scol[order], keys[order], seq[order]
    new = np.empty(len(ss), dtype=bool)
    new[0] = True
    new[1:] = (ss[1:] != ss[:-1]) | (ks[1:] != ks[:-1])
    pair_of_triple = np.cumsum(new) - 1
    first_seq = qs[new]
    pair_site = ss[new]
    o2 = np.lexsort((first_seq, pair_site))
    m_pairs = len(o2)
    site_change = np.empty(m_pairs, dtype=bool)
    site_change[0] = True
    ps_sorted = pair_site[o2]
    site_change[1:] = ps_sorted[1:] != ps_sorted[:-1]
    grp_start = np.maximum.accumulate(
        np.where(site_change, np.arange(m_pairs), 0))
    rank_sorted = np.arange(m_pairs) - grp_start
    dense_of_pair = np.empty(m_pairs, dtype=np.int64)
    dense_of_pair[o2] = rank_sorted
    dense = np.empty(len(keys), dtype=np.int64)
    dense[order] = dense_of_pair[pair_of_triple]
    max_d = int(rank_sorted.max()) + 1
    dt = np.int8 if max_d <= 127 else np.int32
    ids = np.full((R, SP), INVALID_ID, dtype=dt)
    ids[inv_perm[rrow], scol] = dense.astype(dt)
    has_mmr[inv_perm[read_rows]] = True
    return ids, has_mmr, max_d


def _scan_perm(rs: ReadSet, direction: int, R: int):
    """(perm, inv_perm, q_break) for one direction's candidate-scan order."""
    n = rs.n
    if direction == 0:
        scan_list = list(range(n))
        q_break = n
    else:
        scan_list = [rs.rev_order[n - 1 - q] for q in range(n)]
        q_break = n - 1
    perm = np.full(R, -1, dtype=np.int32)
    perm[:n] = scan_list
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm[:n]] = np.arange(n)
    return perm, inv_perm, q_break


def build_gap_device_data(rs: ReadSet, ms: Methmers, direction: int,
                          pad_r: Optional[int] = None,
                          pad_s: Optional[int] = None,
                          mmr_arrays=None,
                          want_runs: bool = False,
                          pre=None) -> GapDeviceData:
    """Pack one direction of one gap (engine_jax.build_gap_device_data).
    Either store_mmr_of_reads(rs, ms) ran, or `mmr_arrays` carries the
    native batch-extraction result (core.methmer.extract_mmr_arrays).

    want_runs: prefer the compact runs layout; falls back to dense when the
    native lib is absent or a site needs >254 dictionary ids.

    pre: pack_group's batched pre-pass results for this lane —
    (perm, inv_perm, q_break, blk, b0, has_mmr, max_d); max_d < 0 means the
    runs fill failed for this lane and the dense path runs, reusing the
    perm triple."""
    n = rs.n
    S = ms.n
    R = pad_r or max(n, 1)
    SP = pad_s or max(S, 1)
    if pre is not None:
        perm, inv_perm, q_break = pre[0], pre[1], pre[2]
    else:
        perm, inv_perm, q_break = _scan_perm(rs, direction, R)

    blk = b0 = ids = None
    if pre is not None and pre[6] > 0 and want_runs:
        blk, b0, has_mmr, max_d = pre[3], pre[4], pre[5], int(pre[6])
    elif mmr_arrays is not None:
        sel = np.flatnonzero(mmr_arrays["n"] > 0)
        lens = mmr_arrays["n"][sel].astype(np.int64)
        offs = mmr_arrays["off"][sel].astype(np.int64)
        starts = mmr_arrays["start_i"][sel].astype(np.int64)
        from ..io import native as _native
        res = None
        if want_runs:
            cb = 128
            if len(sel):
                cb = int(_round_up(int(((starts & 127) + lens).max()), 128))
            rr = _native.mer_runs_fill(sel.astype(np.int64), lens, starts,
                                       offs, mmr_arrays["mers"], inv_perm,
                                       R, SP, cb)
            if rr is not None:
                blk, b0, has_mmr, max_d = rr
        if blk is None:
            res = _native.mer_grid_fill(sel.astype(np.int64), lens, starts,
                                        offs, mmr_arrays["mers"], inv_perm,
                                        R, SP)
        if blk is not None:
            pass
        elif res is not None:
            ids, has_mmr, max_d = res
        else:
            # numpy oracle (also the >127-ids-per-site int32 path)
            total = int(lens.sum())
            gidx = (np.repeat(offs, lens)
                    + np.arange(total, dtype=np.int64)
                    - np.repeat(np.cumsum(lens) - lens, lens))
            ids, has_mmr, max_d = _grid_from_arrays(
                sel.astype(np.int64), lens, starts,
                mmr_arrays["mers"][gidx], inv_perm, R, SP)
    else:
        reads_with = [r for r in rs.reads if r.mmr_n]
        ids, has_mmr, max_d = _grid_from_arrays(
            np.array([r.i for r in reads_with], dtype=np.int64),
            np.array([r.mmr_n for r in reads_with], dtype=np.int64),
            np.array([r.mmr_start_i for r in reads_with], dtype=np.int64),
            np.concatenate([r.mmr for r in reads_with])
            if reads_with else np.zeros(0, dtype=np.int64),
            inv_perm, R, SP)

    # step 1 seeds (blockjoin.c:3976-4004)
    if direction == 0:
        ref_ids = rs.ids_left
        min0 = 0
        max0 = int(np.searchsorted(ms.sites_real_poss, rs.ref_start,
                                   side="right"))
    else:
        ref_ids = rs.ids_right
        max0 = S - 1
        min0 = S - 1
        for i in range(S - 1, -1, -1):
            if ms.sites_real_poss[i] > rs.ref_end:
                min0 -= 1
            else:
                break
    # step 1.5: wipe to unphased except ref side, with the hp&3 truncation
    # quirk (blockjoin.c:4013-4024); seeding eligibility is tested on the
    # RAW haptag (blockjoin.c:3796) before truncation
    hp_p = np.full(R, 2, dtype=np.int32)
    seed_p = np.zeros(R, dtype=bool)
    for rid in ref_ids:
        hp_p[inv_perm[rid]] = rs.reads[rid].hp & 3
        seed_p[inv_perm[rid]] = rs.reads[rid].hp in (0, 1)

    return GapDeviceData(ids=ids, has_mmr=has_mmr, hp_init=hp_p,
                         seed_ok=seed_p, perm=perm,
                         n_reads=n, n_sites=S, max_d=max_d, q_break=q_break,
                         min0=min0, max0=max0, R=R, S=SP, blk=blk, b0=b0)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket_dim(n: int) -> int:
    """Pad a read/site dimension to a coarse shape bucket: multiples of 256
    up to 2048, then 1.25x steps rounded to 256 (engine_jax._bucket_dim).
    The packed arrays, and so the tests' parity with the JAX package,
    depend on these exact buckets."""
    b = _round_up(max(n, 1), 256)
    if b <= 2048:
        return b
    v = 2048
    while v < b:
        v = _round_up(int(v * 1.25), 256)
    return v


def _bucket_lanes(n: int) -> int:
    """Pad the lane count to a power-of-two multiple of 32 (dead lanes are
    inactive from iteration 0)."""
    v = 32
    while v < n:
        v *= 2
    return v


def _reseeded(dd: GapDeviceData, rs: ReadSet, direction: int,
              seed_tags: np.ndarray) -> GapDeviceData:
    """Clone a packed lane with hp_init/seed_ok derived from a permutation
    seed-tag vector (engine_jax._reseeded): the N permutation lanes of one
    (gap, direction) share the ids grid, has_mmr and perm."""
    import dataclasses
    n = rs.n
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[dd.perm[:n]] = np.arange(n)
    ref_ids = rs.ids_left if direction == 0 else rs.ids_right
    hp_p = np.full(dd.R, 2, dtype=np.int32)
    seed_p = np.zeros(dd.R, dtype=bool)
    for rid in ref_ids:
        t = int(seed_tags[rid])
        hp_p[inv_perm[rid]] = t & 3
        seed_p[inv_perm[rid]] = t in (0, 1)
    return dataclasses.replace(dd, hp_init=hp_p, seed_ok=seed_p)


def pack_group(loaded, cfg: MmrConfig, n_cand: int, lane_multiple: int = 1,
               n_permutations: int = 1, rngs=None):
    """Pack one group of loaded (i, rs, ms_fwd, ms_bwd) windows into device
    batches (engine_jax.pack_group): lanes [0:n) bwd, [n:2n) fwd; with
    permutation voting each (gap, direction) contributes n_permutations
    consecutive lanes. R and S pad to the _bucket_dim ladder.

    lane_multiple: pad each batch's lane count to a multiple of this (the
    mesh's device count), so the lane axis splits evenly. Power-of-two
    counts up to 32 divide every bucket already; other counts pad the
    lanes to a multiple of lcm(32, lane_multiple).

    rngs: per-gap Drand48 streams (required when n_permutations > 1).

    Returns (per-lane datas, parts, errs): parts is a list of
    (lane_indices, GapBatch), one entry for a layout-homogeneous group and
    two when the group mixes runs-eligible and dense-only lanes; errs is
    the set of (gap_index_in_loaded, direction) whose permute failed."""
    from ..core.engine_host import make_permutation_seeds
    from ..parallel.batch import pack_gap_batch

    if n_permutations > 1:
        assert rngs is not None and len(rngs) == len(loaded), \
            "per-gap rng streams are required for batched permutation voting"
    pad_r = _bucket_dim(max(rs.n for _, rs, _, _ in loaded))
    pad_s = _bucket_dim(max(max(t[2].n, t[3].n) for t in loaded))
    datas = []
    errs = set()
    # every (gap, direction) methmer extraction of the group in ONE native
    # call (mmr_extract_multi); the per-lane path runs when it is absent
    from ..io import native as _native
    multi = None
    if _native.native_available():
        tasks = []
        for direction in (1, 0):
            for _, rs, ms_fwd, ms_bwd in loaded:
                ms = ms_fwd if direction == 0 else ms_bwd
                calls, quals, call_off, call_n = rs.concat_calls()
                tasks.append((ms.sites_starts, ms.mmr_lens, calls,
                              quals, call_off, call_n))
        multi = _native.mmr_extract_multi(tasks)
    # every lane's runs-layout fill in ONE native call (mer_runs_multi);
    # lanes whose fill fails (>254 ids) keep pre[6] < 0 and go dense
    pres = None
    if multi is not None:
        z64 = np.zeros(0, dtype=np.int64)
        fill_tasks, metas = [], []
        cb_need = 128
        for k, res in enumerate(multi):
            direction = 1 if k < len(loaded) else 0
            _, rs, _, _ = loaded[k % len(loaded)]
            if res is None:
                metas.append(None)
                fill_tasks.append((z64, z64, z64, z64,
                                   np.zeros(0, dtype=np.uint32), z64))
                continue
            perm, inv_perm, q_break = _scan_perm(rs, direction, pad_r)
            sel = np.flatnonzero(res["n"] > 0).astype(np.int64)
            lens = res["n"][sel].astype(np.int64)
            offs = res["off"][sel].astype(np.int64)
            starts = res["start_i"][sel].astype(np.int64)
            if len(sel):
                cb_need = max(cb_need, int(((starts & 127) + lens).max()))
            metas.append((perm, inv_perm, q_break))
            fill_tasks.append((sel, lens, starts, offs, res["mers"],
                               inv_perm))
        rr = _native.mer_runs_multi(fill_tasks, pad_r, pad_s,
                                    _round_up(cb_need, 128))
        if rr is not None:
            blk_all, b0_all, has_all, maxd = rr
            pres = [None if metas[k] is None else
                    metas[k] + (blk_all[k], b0_all[k], has_all[k],
                                int(maxd[k]))
                    for k in range(len(multi))]
    for direction in (1, 0):
        for j, (i, rs, ms_fwd, ms_bwd) in enumerate(loaded):
            ms = ms_fwd if direction == 0 else ms_bwd
            k = (0 if direction == 1 else len(loaded)) + j
            if multi is not None:
                res = multi[k]
            else:
                from ..core.methmer import extract_mmr_arrays
                res = extract_mmr_arrays(rs, ms)
            if res is not None:
                dd = build_gap_device_data(rs, ms, direction, pad_r, pad_s,
                                           mmr_arrays=res, want_runs=True,
                                           pre=pres[k] if pres is not None
                                           else None)
            else:
                store_mmr_of_reads(rs, ms)
                dd = build_gap_device_data(rs, ms, direction, pad_r, pad_s)
                wipe_mmr_of_reads(rs)
            if n_permutations == 1:
                datas.append(dd)
                continue
            seeds, err = make_permutation_seeds(rs, direction,
                                                n_permutations, rngs[j])
            if err:
                errs.add((j, direction))
            while len(seeds) < n_permutations:
                # failed permute: keep the lane grid rectangular with dead
                # copies of run 0 (their results are discarded via errs)
                seeds.append(seeds[0])
            datas.append(dd)  # run 0 = the initial tags
            for seed in seeds[1:]:
                datas.append(_reseeded(dd, rs, direction, seed))

    def _pad_lanes(n: int) -> int:
        p = _bucket_lanes(n)
        if p % lane_multiple:
            p = _round_up(p, math.lcm(32, lane_multiple))
        return p

    eligible = [d.blk is not None for d in datas]
    if all(eligible) or not any(eligible):
        lanes = [np.arange(len(datas))]
    else:  # mixed layouts: one sub-batch per layout
        lanes = [np.flatnonzero(eligible),
                 np.flatnonzero([not e for e in eligible])]
    parts = []
    for idx in lanes:
        sub = [datas[i] for i in idx]
        parts.append((idx, pack_gap_batch(
            sub, [cfg.cov_for_runtime] * len(sub), n_cand,
            pad_g=_pad_lanes(len(sub)))))
    return datas, parts, errs


# ---------------------------------------------------------------------------
# one gap (engine_jax.py:489-552)
# ---------------------------------------------------------------------------

def run_gap(rs: ReadSet, ms_fwd: Methmers, ms_bwd: Methmers, n_cand: int,
            cov_runtime: int, n_permutations: int = 1, rng=None, *,
            engine: str = "cuda", device=None) -> int:
    """Device-engine version of core.engine_host.haplotag_region
    (blockjoin.c:4288-4320), step for step engine_jax.run_gap_jax: bwd then
    fwd, the agreement gate; returns 0 cis / 1 trans / -1 no join, and on a
    join leaves the forward tags in `rs`.

    Permutation voting draws every seed-tag vector from the same drand48
    stream in the same order as the host engine (all bwd permutes before
    fwd). A direction's seeds run as the lanes of one batch
    (parallel/batch.pack_gap_batch, run_gap_batch): one loop-kernel launch
    per direction for engine "cuda", the plain loop for "torch" on
    `device` (default: the CPU). Lanes are independent, so each seed's tags
    equal run_gap_jax's, which dispatches the seeds one by one. The
    iteration cap is run_gap_jax's, 2 * pad_r + 64. `run_gap.dispatched`
    counts the directions whose batch was dispatched (a direction skipped
    by err_permutation is not)."""
    from .. import resolve_device
    from ..core.engine_host import make_permutation_seeds, vote_permutations
    from ..parallel.batch import pack_gap_batch, run_gap_batch

    if engine not in ("torch", "cuda"):
        raise ValueError(f"run_gap: engine {engine!r} is not torch or cuda")
    engine, dev = resolve_device(engine, device)
    if rs.n == 0 or ms_fwd.n == 0 or ms_bwd.n == 0:
        return -1
    initial = rs.store_haplotags()

    results = {}
    for direction, ms in ((1, ms_bwd), (0, ms_fwd)):
        store_mmr_of_reads(rs, ms)
        seeds, err_permutation = make_permutation_seeds(rs, direction,
                                                        n_permutations, rng)
        if err_permutation:
            # blockjoin.c:4160-4163: treat the direction as unphased
            results[direction] = (-1, None)
            rs.restore_haplotags(initial)
            wipe_mmr_of_reads(rs)
            continue
        pad_r = _round_up(max(rs.n, 8), 128)
        pad_s = _round_up(max(ms.n, 8), 128)
        datas = []
        for seed in seeds:
            rs.restore_haplotags(seed)
            datas.append(build_gap_device_data(rs, ms, direction, pad_r,
                                               pad_s))
        hps = run_gap_batch(pack_gap_batch(datas, [cov_runtime] * len(datas),
                                           n_cand),
                            max_iters=2 * pad_r + 64, engine=engine,
                            device=dev)
        run_gap.dispatched += 1
        evals, bufs = [], []
        for dd, hp in zip(datas, hps):
            # un-permute: device rows are in scan order
            hp_orig = np.full(rs.n, 2, dtype=np.int32)
            hp_orig[dd.perm[: rs.n]] = hp[: rs.n]
            rs.restore_haplotags(hp_orig)
            evals.append(evaluate_separation(rs, initial,
                                             1 if direction == 0 else 0))
            bufs.append(hp_orig)
        join, chosen = vote_permutations(n_permutations, evals)
        results[direction] = (join, bufs[chosen] if join >= 0 else None)
        rs.restore_haplotags(initial)
        wipe_mmr_of_reads(rs)

    join2, _ = results[1]
    join1, tags_fwd = results[0]
    if join1 != join2 or (join1 == -1 and join2 == -1):
        rs.set_all_as_unphased()
        return -1
    rs.restore_haplotags(tags_fwd)
    return join1


run_gap.dispatched = 0


# ---------------------------------------------------------------------------
# orchestration (engine_jax.py:555-841, 1087-1142)
# ---------------------------------------------------------------------------

def run_gaps_batched(st, bam, ref_name: str, rg, cfg: MmrConfig, n_cand: int,
                     indices=None, group: int = 0, n_permutations: int = 1,
                     perm_key_base: int = 0, *, engine: str, device):
    """Run gaps of one chromosome (all, or the subset in `indices`) through
    the batched device engine, `group` gaps (= 2*group lanes) per dispatch.
    Returns (decisions, per-gap {qname: hp}) aligned with `indices`."""
    idxs = list(indices if indices is not None else range(len(rg.starts)))
    job = dict(ref_name=ref_name, rg=rg, cfg=cfg, n_cand=n_cand,
               indices=idxs, perm_key_base=perm_key_base)
    (decisions, tag_maps), = run_jobs_batched(
        st, bam, [job], group=group, n_permutations=n_permutations,
        engine=engine, device=device)
    return [decisions[i] for i in idxs], [tag_maps[i] for i in idxs]


def _pick_load_threads(bam) -> int:
    """Window-load thread pool size (engine_jax._pick_load_threads): only
    the columnar native path pools, and only with cores to spare beyond one
    bam_window_load call's own workers. POMFRET_LOAD_THREADS overrides."""
    if getattr(bam, "fetch_window_columnar", None) is None:
        return 1
    from ..io import native as _native
    if not _native.native_available():
        return 1
    return int(os.environ.get(
        "POMFRET_LOAD_THREADS",
        max(1, min(4, (os.cpu_count() or 2) // 8))))


def chrom_source(bam, job):
    """The window-union columnar source of one job's chromosome
    (core.readset.ChromReadSource), or None where the native loader is
    absent: it decodes the union of the job's ±READBACK halos once, or the
    whole chromosome where that union covers 98% of it."""
    tid = bam.ref_id(job["ref_name"]) if hasattr(bam, "ref_id") else -1
    if tid < 0:
        return None
    ref_len = bam.ref_lens[tid]
    rg = job["rg"]
    # -1: the per-window fetch queries [start-READBACK-1, end+READBACK)
    halos = sorted(
        (max(rg.starts[i] - READBACK - 1, 0),
         min(rg.ends[i] + READBACK, ref_len))
        for i in job["indices"])
    regions = []
    for lo, hi in halos:
        if regions and lo <= regions[-1][1]:
            regions[-1][1] = max(regions[-1][1], hi)
        else:
            regions.append([lo, hi])
    if sum(hi - lo for lo, hi in regions) >= 0.98 * ref_len:
        regions = None  # effectively the whole chromosome
    from ..core.readset import ChromReadSource
    src = ChromReadSource(bam, job["ref_name"], job["cfg"], regions=regions)
    return src if src.ok else None


def run_jobs_batched(st, bam, jobs, group: int = 0, n_permutations: int = 1,
                     *, engine: str, device, mesh=None):
    """Run many chromosomes' gap jobs through ONE device pipeline.

    jobs: list of dicts {ref_name, rg, cfg, n_cand, indices, perm_key_base}.
    engine: "cuda" (the kernel) or "torch" (the plain loop) on `device`.
    mesh: the devices each batch's lanes split over (parallel/batch.
    make_gap_mesh); by default production_mesh(device), None for one
    device. The group holds POMFRET_GAP_GROUP gaps per device, and its
    lanes pad to a multiple of the device count.
    Returns a list of (decisions, tag_maps) dicts aligned with jobs.

    Up to POMFRET_PIPE_DEPTH groups are dispatched and not yet decided: the
    device runs group k while the host loads and packs group k+1, across
    chromosome boundaries. A thread loads up to POMFRET_PREFETCH groups
    ahead of the one being packed, so at most prefetch + pipe depth + 1
    groups are alive at once, each from the start of its load to the end
    of its decision (DISPATCH_STATS groups_in_flight, groups_in_flight_max);
    a dispatched group keeps only what the decision reads (its windows'
    tags, names and boundary reads, and its lanes' row orders)."""
    import threading as _threading
    from ..parallel import batch as _batch
    from ..parallel.batch import DISPATCH_STATS, run_gap_batch_group_async
    from ..utils.stats import group as _group, new_id, stage
    if mesh is None:
        mesh = _batch.production_mesh(device)
    n_dev = 1 if mesh is None else len(mesh)
    group = group or max(1, int(os.environ.get("POMFRET_GAP_GROUP", "128"))
                         * n_dev // max(1, n_permutations))
    n_load_threads = _pick_load_threads(bam)
    results = [({}, {}) for _ in jobs]  # (decisions, tag_maps) per job

    # the ordered plan of (job index, gap-index chunk) groups
    plan = []
    for ji, job in enumerate(jobs):
        idxs = job["indices"]
        for c0 in range(0, len(idxs), group):
            plan.append((ji, idxs[c0 : c0 + group]))
    # each group's id, which the spans of its load, pack, dispatch and
    # decision carry (utils.stats)
    gids = [new_id() for _ in plan]

    src_state = {"ji": None, "src": None}  # producer-local, one job at a time

    def _chrom_source(ji):
        if src_state["ji"] != ji:
            # let the previous chromosome's source go before this one's
            # decode starts
            src_state["ji"], src_state["src"] = ji, None
            src_state["src"] = chrom_source(bam, jobs[ji])
        return src_state["src"]

    inflight_lock = _threading.Lock()

    def _inflight(d):
        with inflight_lock:
            n = DISPATCH_STATS["groups_in_flight"] + d
            DISPATCH_STATS["groups_in_flight"] = n
            DISPATCH_STATS["groups_in_flight_max"] = max(
                n, DISPATCH_STATS["groups_in_flight_max"])

    def _load_chunk(k):
        _inflight(1)
        ji, chunk = plan[k]
        job = jobs[ji]
        ref_name, rg, cfg = job["ref_name"], job["rg"], job["cfg"]

        def _load_one(i, src=None):
            with _group(gids[k]):  # also on the load pool's threads
                with stage("wl_materialize", ref_name):
                    if src is not None:
                        rs = src.window(rg.starts[i], rg.ends[i], READBACK,
                                        st.qname2haptag_raw
                                        if st.stores_raw_tag else None)
                    else:
                        rs = load_reads_given_interval(
                            bam, ref_name, rg.starts[i], rg.ends[i],
                            READBACK, cfg, st.qname2haptag_raw
                            if st.stores_raw_tag else None)
                with stage("wl_sites", ref_name):
                    ms_fwd = get_methmer_sites_and_ranges(rs, cfg, 0)
                    ms_bwd = get_methmer_sites_and_ranges(rs, cfg, 1)
            return i, rs, ms_fwd, ms_bwd

        with _group(gids[k]), stage("window_load", ref_name):
            with stage("wl_source", ref_name):
                src = _chrom_source(ji)
            if src is not None:
                with stage("wl_window", ref_name):
                    return [_load_one(i, src) for i in chunk]
            if n_load_threads > 1 and len(chunk) > 1:
                import concurrent.futures as _fut
                with _fut.ThreadPoolExecutor(n_load_threads) as ex:
                    return list(ex.map(_load_one, chunk))
            return [_load_one(i) for i in chunk]

    # a background producer thread loads group k+1..k+depth while the main
    # thread packs/dispatches/decides group k; POMFRET_PREFETCH=0 restores
    # the serial order (identical results either way). Default off below 4
    # host cores, where the producer only time-slices against pack/decide.
    default_depth = "2" if (os.cpu_count() or 2) >= 4 else "0"
    depth = int(os.environ.get("POMFRET_PREFETCH", default_depth))
    if depth > 0 and len(plan) > 1:
        import queue as _queue
        q: "_queue.Queue" = _queue.Queue()
        # a slot a group, from the start of its load until the consumer
        # takes it: at most `depth` groups loaded or loading ahead
        slots = _threading.Semaphore(depth)

        def _producer():
            try:
                for k in range(len(plan)):
                    with _group(gids[k]), stage("slot_wait"):
                        slots.acquire()
                    q.put((_load_chunk(k), None))
            except BaseException as e:  # surface in the consumer
                q.put((None, e))

        t = _threading.Thread(target=_producer, name="pomfret-loader",
                              daemon=True)
        t.start()

        # group_wait: the main thread waiting for its next loaded group
        def _iter_groups():
            for k in range(len(plan)):
                with _group(gids[k]), stage("group_wait"):
                    loads, err = q.get()
                slots.release()
                if err is not None:
                    raise err
                yield k, loads
                loads = None  # the consumer holds what it still needs
            t.join()
    else:
        def _iter_groups():
            for k in range(len(plan)):
                with _group(gids[k]), stage("group_wait"):
                    loads = _load_chunk(k)
                yield k, loads

    pipe_depth = max(1, int(os.environ.get("POMFRET_PIPE_DEPTH", "2")))
    pending = []

    def _drain_oldest():
        k, kept, perms, errs, fut = pending.pop(0)
        ji = plan[k][0]
        with _group(gids[k]):
            _drain_group((kept, perms, errs, fut), *results[ji],
                         n_permutations, jobs[ji]["ref_name"])
        _inflight(-1)

    for k, loads in _iter_groups():
        ji = plan[k][0]
        job = jobs[ji]
        ref_name = job["ref_name"]
        decisions, tag_maps = results[ji]
        loaded = []
        for i, rs, ms_fwd, ms_bwd in loads:
            DISPATCH_STATS["window_reads"] += int(rs.n)
            if rs.n == 0 or ms_fwd.n == 0 or ms_bwd.n == 0:
                decisions[i] = -1
                tag_maps[i] = {}
                continue
            loaded.append((i, rs, ms_fwd, ms_bwd))
        del loads
        if not loaded:
            _inflight(-1)
            continue
        rngs = None
        if n_permutations > 1:
            from ..core.engine_host import Drand48
            rngs = [Drand48.from_srand48(job["perm_key_base"] + i)
                    for i, *_ in loaded]
        with _group(gids[k]):
            with stage("pack", ref_name):
                datas, parts, errs = pack_group(
                    loaded, job["cfg"], job["n_cand"], lane_multiple=n_dev,
                    n_permutations=n_permutations, rngs=rngs)
            with stage("dispatch", ref_name):
                fut = run_gap_batch_group_async(parts, n_lanes=len(datas),
                                                engine=engine, device=device,
                                                mesh=mesh)
        # a dispatched group keeps what the decision reads: each window's
        # reads without their calls (views of the chromosome source's
        # slabs), its boundary reads, and each lane's row order
        kept = [(i, rs) for i, rs, _, _ in loaded]
        for _, rs in kept:
            rs._calls_concat = None
            rs._site_sel_cache = None
            for r in rs.reads:
                r.calls = r.quals = r.mmr = None
        perms = [d.perm for d in datas]
        del loaded, datas, parts
        pending.append((k, kept, perms, errs, fut))
        if len(pending) > pipe_depth:
            _drain_oldest()
    while pending:
        _drain_oldest()
    return results


def _drain_group(entry, decisions, tag_maps, n_permutations: int = 1,
                 tag: Optional[str] = None) -> None:
    """Download one finished group and run the host-side decision step:
    per (gap, direction) evaluate each permutation lane's separation, vote,
    then apply the fwd/bwd agreement gate (blockjoin.c:4288-4320).
    entry: (the group's (gap index, ReadSet) pairs, each lane's row order
    (GapDeviceData.perm), the failed permutes, the pending result); tag:
    the stages' tag (the chromosome)."""
    from ..utils.stats import stage
    from ..parallel.batch import DISPATCH_STATS

    loaded, perms, errs, fut = entry
    with stage("device_wait", tag):
        out = np.asarray(fut)  # blocks until the device batch finishes
    DISPATCH_STATS["gaps_decided"] += len(loaded)
    with stage("decide", tag):
        _decide(loaded, perms, errs, out, decisions, tag_maps, n_permutations)


def _decide(loaded, perms, errs, out, decisions, tag_maps,
            n_permutations: int) -> None:
    """_drain_group's decision step on the group's (G, R) tags `out`."""
    from ..core.engine_host import vote_permutations
    n_loaded = len(loaded)
    N = n_permutations
    for j, (i, rs) in enumerate(loaded):
        initial = rs.store_haplotags()
        results: Dict[int, tuple] = {}
        for k, direction in enumerate((1, 0)):
            if (j, direction) in errs:
                results[direction] = (-1, None)
                continue
            evals, bufs = [], []
            for p in range(N):
                lane = (k * n_loaded + j) * N + p
                hp = out[lane]
                hp_orig = np.full(rs.n, 2, dtype=np.int32)
                hp_orig[perms[lane][: rs.n]] = hp[: rs.n]
                rs.restore_haplotags(hp_orig)
                evals.append(evaluate_separation(
                    rs, initial, 1 if direction == 0 else 0))
                bufs.append(hp_orig)
                rs.restore_haplotags(initial)
            join, chosen = vote_permutations(N, evals)
            results[direction] = (join, bufs[chosen] if join >= 0 else None)
        join2, _ = results[1]
        join1, tags_fwd = results[0]
        if join1 != join2 or (join1 == -1 and join2 == -1):
            rs.set_all_as_unphased()
            d = -1
        else:
            rs.restore_haplotags(tags_fwd)
            d = join1
        decisions[i] = d
        tag_maps[i] = {r.qname: r.hp for r in rs.reads} if d >= 0 else {}
