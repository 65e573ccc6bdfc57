"""Phase-gap interval bookkeeping.

Mirrors ranges_t / storage_t and the decision-lifting machinery of the
reference (blockjoin.c:1178-1296, 2178-2361, 2365-2473)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

UINT32_MAX = 0xFFFFFFFF


@dataclass
class Ranges:
    """Per-chromosome gap set (ranges_t, blockjoin.c:1178-1189).

    All coordinates are the raw values parsed from the inputs (1-based VCF
    positions / GTF coords), exactly as in the reference.
    """
    abs_start: int = 0
    abs_end: int = 0
    starts: List[int] = field(default_factory=list)   # merged gap starts
    ends: List[int] = field(default_factory=list)     # merged gap ends
    decisions: List[int] = field(default_factory=list)
    # C-memory stale tails beyond the compacted length (merge_close_intervals
    # truncates n without clearing memory; lift_decisions reads past n — the
    # stale values are behavior-defining, see blockjoin.c:2215-2217, 2257-2269)
    ends_stale: List[int] = field(default_factory=list)
    dropped: List[Tuple[int, int]] = field(default_factory=list)
    rawunphasedblocks: List[List[int]] = field(default_factory=list)
    decisions_onraw: List[int] = field(default_factory=list)
    flips_onraw: List[int] = field(default_factory=list)
    phaseblocks: List[Tuple[int, int]] = field(default_factory=list)


@dataclass
class Storage:
    """Global run state (storage_t, blockjoin.c:1223-1234)."""
    ref_names: List[str] = field(default_factory=list)
    ranges: List[Ranges] = field(default_factory=list)
    qname2haptag: Dict[str, int] = field(default_factory=dict)
    qname2haptag_raw: Dict[str, int] = field(default_factory=dict)
    stores_raw_tag: bool = False
    varphase_in_dropped: Optional[List[Dict[int, int]]] = None

    def ref_index(self, name: str) -> int:
        try:
            return self.ref_names.index(name)
        except ValueError:
            return -1


def store_raw_intervals(rg: Ranges) -> None:
    # blockjoin.c:2178-2188
    rg.rawunphasedblocks = [[s, e] for s, e in zip(rg.starts, rg.ends)]


def merge_close_intervals(rg: Ranges, threshold: int) -> None:
    """Merge gaps closer than `threshold`, recording the swallowed phased
    slivers in `dropped` (blockjoin.c:2190-2218). Note the reference retains
    the PRE-merge length in decisions (quirk, behavior-defining for lifting).
    """
    if len(rg.starts) <= 1:
        rg.decisions = [-1] * len(rg.starts)
        rg.ends_stale = list(rg.ends)
        return
    n_pre = len(rg.starts)
    j = 0
    for i in range(1, len(rg.starts)):
        if rg.starts[i] - rg.ends[j] < threshold:
            rg.dropped.append((rg.ends[j], rg.starts[i]))
            rg.ends[j] = rg.ends[i]
        else:
            j += 1
            rg.starts[j] = rg.starts[i]
            rg.ends[j] = rg.ends[i]
    rg.decisions = [-1] * n_pre  # pre-merge length, as in the reference
    rg.ends_stale = list(rg.ends)  # full C memory incl. stale suffix
    del rg.starts[j + 1:]
    del rg.ends[j + 1:]


def lift_decisions(st: Storage) -> None:
    """Map per-merged-gap decisions back onto raw gaps, collapsing joined
    runs (blockjoin.c:2250-2310). Mutates rawunphasedblocks in place."""
    for rr in st.ranges:
        rr.phaseblocks = []
        rr.decisions_onraw = []
        raw = rr.rawunphasedblocks
        ends_mem = rr.ends_stale if rr.ends_stale else list(rr.ends)
        j = 0
        for i in range(len(rr.decisions)):
            de = rr.decisions[i]
            end_i = rr.ends[i] if i < len(rr.ends) else ends_mem[i]
            if de < 0:
                while j < len(raw) and raw[j][1] <= end_i:
                    rr.decisions_onraw.append(de)
                    j += 1
            else:
                if raw[j][1] < end_i:
                    j2 = j
                    found = False
                    while j2 < len(raw):
                        if raw[j2][1] == end_i:
                            found = True
                            break
                        j2 += 1
                    assert found
                    raw[j][1] = end_i
                    del raw[j + 1 : j2 + 1]
                rr.decisions_onraw.append(de)
                j += 1


def make_decisions_flippings_onraw(st: Storage) -> None:
    """Cumulative XOR of join decisions: no-join resets flip to 0, cis keeps,
    trans toggles (blockjoin.c:2312-2324)."""
    for rr in st.ranges:
        flip = 0
        rr.flips_onraw = []
        for de in rr.decisions_onraw:
            if de < 0:
                flip = 0
            else:
                flip ^= de
            rr.flips_onraw.append(flip)


def generate_new_phase_blocks(st: Storage, use_raw: bool = True) -> None:
    """Walk non-joined gap boundaries from abs_start to abs_end
    (blockjoin.c:2326-2361)."""
    for rr in st.ranges:
        start = rr.abs_start
        end = UINT32_MAX
        if use_raw:
            N = len(rr.decisions_onraw)
            de = rr.decisions_onraw
        else:
            N = len(rr.decisions)
            de = rr.decisions
        rr.phaseblocks = []
        for i in range(N):
            if de[i] >= 0:
                continue
            end = rr.rawunphasedblocks[i][0] if use_raw else rr.starts[i]
            rr.phaseblocks.append((start, end))
            start = rr.rawunphasedblocks[i][1] if use_raw else rr.ends[i]
        if N > 0 and end != rr.abs_end:
            end = rr.abs_start if end == UINT32_MAX else end
            rr.phaseblocks.append((end, rr.abs_end))


# ---- lookups used by the writers (blockjoin.c:2365-2473) ----

def get_new_phaseblock_id(rr: Ranges, pos: int) -> int:
    """Return the new PS (block start) whose [s, e] contains pos, skipping
    placeholder blocks (blockjoin.c:2365-2381); -1 if none.

    NOTE: the bundled golden (example/output.mp.vcf) shows the variant at
    pos == abs_end rewritten, implying an inclusive upper bound — but that
    golden was produced by an OLDER binary (its GTF also lacks a tab the
    current source prints, blockjoin.c:2744). We follow the v0.1-r14 source:
    strict `pos < e` (blockjoin.c:2373)."""
    for s, e in rr.phaseblocks:
        if s == UINT32_MAX or e == 0 or e == UINT32_MAX:
            continue
        if s <= pos < e:
            return s
    return -1


def check_if_in_dropped_intervals(rr: Ranges, pos: int) -> bool:
    # blockjoin.c:2392-2404 (inclusive on both ends)
    for s, e in rr.dropped:
        if s <= pos <= e:
            return True
    return False


class FlipLookup:
    """Stateful flip-status lookup mirroring get_flip_status
    (blockjoin.c:2438-2473) including its prev_idx caching."""

    def __init__(self):
        self.prev_idx = 0

    def reset(self):
        self.prev_idx = 0

    def get(self, rr: Ranges, pos: int) -> int:
        raw = rr.rawunphasedblocks
        flips = rr.flips_onraw
        j = self.prev_idx
        while j < len(raw):
            if raw[j][0] >= pos:
                self.prev_idx = 0 if j == 0 else j - 1
                stat = flips[self.prev_idx] if flips else -1
                if raw and pos <= raw[0][0]:
                    stat = 0
                return stat
            j += 1
        self.prev_idx = j - 1
        if not flips:
            return -1
        return flips[0 if len(raw) == 0 else len(raw) - 1]


class UnphasedLookup:
    """check_if_in_phased_intervals (blockjoin.c:2406-2426): whether pos sits
    in the inter-gap region [ends[j-1], starts[j]] for some j>=1, with
    prev_idx caching; reports when the containing region index advanced."""

    def __init__(self):
        self.prev_idx = 1

    def reset(self):
        self.prev_idx = 1

    def check(self, rr: Ranges, pos: int):
        prev = self.prev_idx
        for j in range(self.prev_idx, len(rr.starts)):
            if rr.ends[j - 1] <= pos <= rr.starts[j]:
                updated = j != prev
                if updated:
                    self.prev_idx = j
                return True, updated
        return False, False


def get_flip_status_by_idx(rr: Ranges, idx: int) -> int:
    # blockjoin.c:2428-2436
    if 0 <= idx < len(rr.flips_onraw):
        return rr.flips_onraw[idx]
    return -1
