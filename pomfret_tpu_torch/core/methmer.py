"""Methmer engine: site selection, directional windows, per-read extraction.

Reimplements blockjoin.c:3106-3567:
- get_methmer_sites_and_ranges (3202): count meth/unmeth calls per reference
  CpG position, keep sites with >= cov_for_selection of BOTH, build
  variable-length directional windows (up to k sites within k_span bp);
- get_mmr_of_read (3357): align a read's calls to the site grid and emit one
  packed u32 methmer per in-range site ('-' for sites the read lacks);
- count tables are NOT kept as mutable dicts here: in the TPU-native design
  counts are a pure function of the current tag vector (see kernels/).

Quirks preserved:
- the duplicate-site skip when building the per-read sort buffer uses `i>1`
  (an index-1 duplicate is NOT skipped), blockjoin.c:3391;
- a methmer needing the final sort-buffer entry is dropped (inner scan stops
  at n-1), blockjoin.c:3420;
- the site exactly at the read's last call is excluded from methmer starts
  (exclusive x_i_right on exact match), blockjoin.c:3379-3384;
- for backward windows the per-read site grid is sites_starts (window start
  positions), not the real site positions.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .readset import MmrConfig, Read, ReadSet, UINT32_MAX

MER_METH = 0
MER_UNMETH = 1
MER_MISSING = 2


@dataclass
class Methmers:
    config: MmrConfig
    n: int
    sites_real_poss: np.ndarray      # uint32, ascending
    sites_starts: np.ndarray         # uint32 (per-read extraction grid)
    mmr_lens: np.ndarray             # uint8
    # runtime valid range [mmr_min_i, mmr_max_i) — may be -1 / n-1 seeds
    mmr_min_i: int = 0
    mmr_max_i: int = 0


def methmer_to_u32(symbols) -> int:
    v = 0
    for s in symbols:
        v = ((v << 2) | int(s)) & 0xFFFFFFFF
    return v


def u32_to_methmer(v: int, k: int) -> str:
    return "".join("mu-"[(v >> ((k - 1 - i) * 2)) & 3] for i in range(k))


def get_methmer_sites_and_ranges(
    rs: ReadSet,
    config: MmrConfig,
    direction: int,
    masked_positions=None,
) -> Methmers:
    # --- per-position meth/unmeth counting (hash in C, np.unique here) ---
    # The selection depends only on (reads' calls/quals, cov_for_selection),
    # which never change after load — both directions of a gap share one
    # counting pass via a per-ReadSet memo.
    cache = getattr(rs, "_site_sel_cache", None)
    if cache is not None and cache[0] == config.cov_for_selection:
        cand = cache[1]
    else:
        all_pos, all_q, _, _ = rs.concat_calls()
        cand = np.zeros(0, dtype=np.uint64)
        if all_pos.size:
            cand = None
            if not os.environ.get("POMFRET_NO_NATIVE_SITES"):
                from ..io import native
                if native.native_available():
                    # one C++ sort+run-walk instead of two np.uniques —
                    # site selection was ~7% of the warm e2e wall
                    res = native.site_select(all_pos, all_q,
                                             config.cov_for_selection)
                    if res is not None:
                        cand = res.astype(np.uint64)
            if cand is None:
                key = all_pos.astype(np.uint64) * 4 + all_q
                uniq, cnts = np.unique(key, return_counts=True)
                pos_u = (uniq // 4).astype(np.uint64)
                cls_u = (uniq % 4).astype(np.uint8)
                # per position: counts of class 0 (meth) and 1 (unmeth)
                positions, inv = np.unique(pos_u, return_inverse=True)
                cmat = np.zeros((len(positions), 3), dtype=np.int64)
                np.add.at(cmat,
                          (inv, np.minimum(cls_u, 2).astype(np.int64)),
                          cnts)
                sel = ((cmat[:, 0] >= config.cov_for_selection)
                       & (cmat[:, 1] >= config.cov_for_selection))
                cand = positions[sel]
        rs._site_sel_cache = (config.cov_for_selection, cand)
    if masked_positions:
        cand = np.array([p for p in cand if int(p) not in masked_positions],
                        dtype=np.uint64)
    sites = np.sort(cand.astype(np.uint32))
    n = len(sites)

    ms = Methmers(
        config=config, n=n,
        sites_real_poss=sites.copy(),
        sites_starts=np.zeros(n, dtype=np.uint32),
        mmr_lens=np.zeros(n, dtype=np.uint8),
    )
    if n == 0:
        return ms

    # Directional variable-length windows (blockjoin.c:3307-3338): each
    # site's methmer spans up to k following (fwd) / preceding (bwd) sites
    # within k_span bp. The reference's decrement-while-out-of-span walk is
    # equivalent to j = min(i + k, n-1, last index within span) because the
    # site array is sorted — vectorized with searchsorted (the per-site
    # Python loop was a measured hot spot at 200-gap scale).
    idx = np.arange(n, dtype=np.int64)
    if direction == 0:
        s = sites.astype(np.int64)
        j = np.minimum(np.minimum(idx + config.k, n - 1),
                       np.searchsorted(s, s + config.k_span, side="right") - 1)
        ms.mmr_lens = np.maximum(j - idx, 1).astype(np.uint8)
        ms.sites_starts = sites.copy()
    elif direction == 1:
        s = sites[::-1].astype(np.int64)  # descending
        t = -s                            # ascending
        j = np.minimum(np.minimum(idx + config.k, n - 1),
                       np.searchsorted(t, t + config.k_span, side="right") - 1)
        ms.mmr_lens = np.maximum(j - idx, 1).astype(np.uint8)[::-1].copy()
        ms.sites_starts = s[j].astype(np.uint32)[::-1].copy()
    else:
        raise NotImplementedError("symmetric methmers (direction=2) unreachable in reference")
    return ms


def get_mmr_of_read(read: Read, ms: Methmers) -> Tuple[List[int], int]:
    """Vectorized methmer extraction (numpy), exactly equivalent to the
    reference walk (asserted by fuzzing in tests/test_methmer_fast.py).

    Falls back to the literal reimplementation for the one case whose
    semantics depend on the buf-entry interleaving: a duplicated start
    position at storage index 1 reachable by the read (the `i>1` dedup quirk,
    blockjoin.c:3391, which then double-emits storage index 1's methmer).
    """
    sites = ms.sites_starts
    sites_n = ms.n
    calls = read.calls
    if calls.size == 0 or sites_n == 0:
        return [], UINT32_MAX
    first_call = int(calls[0])
    last_call = int(calls[-1])
    if first_call > int(sites[-1]):
        return [], UINT32_MAX
    lo = int(np.searchsorted(sites, first_call, side="left"))
    if first_call < int(sites[0]):
        x_i_left = 0
    elif lo < sites_n and int(sites[lo]) == first_call:
        x_i_left = lo
    else:
        x_i_left = lo - 1 if lo > 0 else 0
    if last_call < int(sites[0]):
        return [], UINT32_MAX
    hi = int(np.searchsorted(sites, last_call, side="left"))
    x_i_right = sites_n if last_call > int(sites[-1]) else hi

    if x_i_left == 0 and sites_n >= 2 and sites[1] == sites[0]:
        # storage 0 and 1 share a position and both enter the buf (the `i>1`
        # exemption): spurious '-' char + double emission — use the walk
        return _get_mmr_of_read_walk(read, ms)
    if x_i_right <= x_i_left:
        return [], UINT32_MAX

    s64 = sites.astype(np.int64)
    # run heads over the full (non-decreasing) starts array
    bnd = np.empty(sites_n, dtype=bool)
    bnd[0] = True
    bnd[1:] = s64[1:] != s64[:-1]
    head = np.maximum.accumulate(np.where(bnd, np.arange(sites_n), 0))

    # a run contributes anchors iff its first in-range member is kept in the
    # buf: true when the run head is in range, or via the i<=1 exemption
    idx_seg = np.arange(x_i_left, x_i_right)
    anch_seg = (head[idx_seg] >= x_i_left) | (x_i_left <= 1)
    if not anch_seg.any():
        return [], UINT32_MAX
    grid_pos = np.unique(s64[idx_seg][anch_seg])
    m = len(grid_pos)

    # per-grid-entry char: the read's call state at that position, else '-'
    ci = np.searchsorted(calls, grid_pos)
    cic = np.minimum(ci, len(calls) - 1)
    has = (ci < len(calls)) & (calls[cic] == grid_pos)
    chars = np.where(has, read.quals[cic], MER_MISSING).astype(np.int64)

    # anchors: in-range members of anchored runs, plus the duplicate tail of
    # the final in-range run (the inner loop runs to the end of the group)
    j_max = x_i_right
    last_pos = int(s64[x_i_right - 1])
    while j_max < sites_n and int(s64[j_max]) == last_pos:
        j_max += 1
    idx_all = np.arange(x_i_left, j_max)
    anch = (head[idx_all] >= x_i_left) | (x_i_left <= 1)
    anchors = idx_all[anch]
    if len(anchors) == 0:
        return [], UINT32_MAX
    gb = np.searchsorted(grid_pos, s64[anchors])
    lens = ms.mmr_lens[anchors].astype(np.int64)
    complete = gb + lens <= m
    if not complete.any():
        return [], UINT32_MAX
    out = np.zeros(len(anchors), dtype=np.uint32)
    for L in np.unique(lens[complete]):
        L = int(L)
        msk = complete & (lens == L)
        win = np.lib.stride_tricks.sliding_window_view(chars, L)
        pw = (4 ** np.arange(L - 1, -1, -1)).astype(np.int64)
        out[msk] = (win[gb[msk]] @ pw).astype(np.uint32)
    first = int(anchors[np.argmax(complete)])
    return out[complete].tolist(), first


def _get_mmr_of_read_walk(read: Read, ms: Methmers) -> Tuple[List[int], int]:
    """Literal reimplementation of the reference's buf walk
    (blockjoin.c:3357-3451) — fuzz oracle + quirk-case fallback."""
    sites = ms.sites_starts
    sites_n = ms.n
    calls = read.calls
    if calls.size == 0 or sites_n == 0:
        return [], UINT32_MAX

    # binary search boundaries (search_arr semantics, leftmost duplicate)
    first_call = int(calls[0])
    last_call = int(calls[-1])
    lo = int(np.searchsorted(sites, first_call, side="left"))
    if first_call > int(sites[-1]):
        return [], UINT32_MAX  # stat -2: no overlap to the right
    if first_call < int(sites[0]):
        x_i_left = 0           # stat -1 -> UINT32_MAX -> clamped to 0
    elif lo < sites_n and int(sites[lo]) == first_call:
        x_i_left = lo          # exact hit (leftmost dup)
    else:
        x_i_left = lo - 1 if lo > 0 else 0  # between sites: step one left

    if last_call < int(sites[0]):
        return [], UINT32_MAX  # stat -1 for the right bound: no overlap
    hi = int(np.searchsorted(sites, last_call, side="left"))
    if last_call > int(sites[-1]):
        x_i_right = sites_n    # stat -2 -> clamped to n
    else:
        x_i_right = hi         # exact: exclusive (quirk); between: larger idx

    # piggyback buffer: (pos, is_call, tiebreak) ascending
    buf: List[Tuple[int, int, int]] = []
    for i in range(x_i_left, x_i_right):
        if i > 1 and sites[i] == sites[i - 1]:
            continue  # note: i>1, NOT i>=1 (reference quirk)
        buf.append((int(sites[i]), 0, i))
    for c, q in zip(calls.tolist(), read.quals.tolist()):
        buf.append((int(c), 1, int(q)))
    buf.sort()

    out: List[int] = []
    start_pos_i = UINT32_MAX
    nbuf = len(buf)
    for bi in range(nbuf):
        if buf[bi][1] != 0:
            continue
        pos_i = buf[bi][2]
        for sj in range(pos_i, sites_n):
            if sites[sj] != sites[pos_i]:
                break
            mmr_len = int(ms.mmr_lens[sj])
            mer: List[int] = []
            j = bi
            while j < nbuf - 1:
                if buf[j][1] != 0:
                    j += 1
                    continue
                if buf[j][0] == buf[j + 1][0] and buf[j + 1][1] != 0:
                    mer.append(buf[j + 1][2])  # qual class -> m/u/-
                    j += 2
                else:
                    mer.append(MER_MISSING)
                    j += 1
                if len(mer) >= mmr_len:
                    break
            if len(mer) != mmr_len:
                continue  # truncated at read end: drop
            if start_pos_i == UINT32_MAX:
                start_pos_i = sj
            out.append(methmer_to_u32(mer))
    if not out:
        return [], UINT32_MAX
    return out, start_pos_i


def extract_mmr_arrays(rs: ReadSet, ms: Methmers):
    """Native batch methmer extraction WITHOUT storing onto the Read
    objects: {mers, off, n, start_i} columnar arrays, or None (native lib
    unavailable / POMFRET_NO_NATIVE_MMR=1). The device packers consume the
    arrays directly (build_gap_device_data mmr_arrays=), skipping the
    store -> per-read concat -> wipe round-trip of the object path."""
    if rs.n == 0 or os.environ.get("POMFRET_NO_NATIVE_MMR"):
        return None
    from ..io import native
    if not native.native_available():
        return None
    calls, quals, call_off, call_n = rs.concat_calls()
    return native.mmr_extract_reads(ms.sites_starts, ms.mmr_lens,
                                    calls, quals, call_off, call_n)


def store_mmr_of_reads(rs: ReadSet, ms: Methmers) -> None:
    if rs.has_mmr:
        raise RuntimeError("storing methmers when read set already has them")
    if rs.n and not os.environ.get("POMFRET_NO_NATIVE_MMR"):
        from ..io import native
        if native.native_available():
            # batch C++ walk over all reads (mmr_extract_reads); the Python
            # path below stays as the parity oracle (POMFRET_NO_NATIVE_MMR=1)
            calls, quals, call_off, call_n = rs.concat_calls()
            res = native.mmr_extract_reads(ms.sites_starts, ms.mmr_lens,
                                           calls, quals, call_off, call_n)
            if res is not None:
                for j, r in enumerate(rs.reads):
                    nm = int(res["n"][j])
                    if nm > 0:
                        o = int(res["off"][j])
                        r.mmr = res["mers"][o : o + nm].copy()
                        r.mmr_n = nm
                        r.mmr_start_i = int(res["start_i"][j])
                        rs.has_mmr = True
                    else:
                        r.mmr = None
                        r.mmr_n = 0
                        r.mmr_start_i = 0
                return
    for r in rs.reads:
        mers, start_i = get_mmr_of_read(r, ms)
        if start_i != UINT32_MAX and start_i + len(mers) > ms.n:
            # the i>1 dedup quirk (blockjoin.c:3391) can double-emit the
            # duplicated index-1 anchor, overflowing the per-site storage —
            # the C writes out of bounds (UB) here; we clamp instead
            mers = mers[: ms.n - start_i]
            if not mers:
                start_i = UINT32_MAX
        if start_i != UINT32_MAX:
            r.mmr = np.asarray(mers, dtype=np.uint32)
            r.mmr_n = len(mers)
            r.mmr_start_i = start_i
            rs.has_mmr = True
        else:
            # reference stores 0 (not UINT32_MAX) for the no-methmer case
            # (store_mmr_of_one_read, blockjoin.c:3518-3523); validity is
            # thereafter governed by mmr_n > 0
            r.mmr = None
            r.mmr_n = 0
            r.mmr_start_i = 0


def wipe_mmr_of_reads(rs: ReadSet) -> None:
    for r in rs.reads:
        r.mmr = None
        r.mmr_n = 0
        r.mmr_start_i = 0
    rs.has_mmr = False
