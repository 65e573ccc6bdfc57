"""The plain reference: what a methphase run must decide, tag and write on
one of the benchmark's sets, worked out with numpy from the semantics of
pomfret v0.1-r14's blockjoin.c (the behaviours that PARITY.md catalogues,
cited by their entries there) and from the benchmark's own inputs: the
maker's record of every read as it was made (maker.save_truth) and the
VCF's text. It reads no BAM and imports nothing of the port.

What it covers, in the order a run does it:

- the gaps between the VCF's phase sets (P1-P3);
- each chromosome's coverage estimate and the parameters a run with no
  -c derives from it (5 kb bins; cov / 10 + 1 of each call class to
  select a site, twice that to recruit, cov / 4 + 1 candidates);
- a gap's window: the reads within READBACK of it that pass the read
  filters, their 5mC calls at CpG sites as the decoder gives them
  (D2, D7), the boundary reads and the left-coverage gate;
- the methmer sites and both directions' methmers (M1-M7);
- the greedy extension with its count table, each direction, the
  contingency gates and Fisher's test, the vote of one run and the
  agreement of the two directions (E1-E7, E9-E11);
- the .mp.gtf and .mp.vcf written from the decisions (P2, O2-O6).

Two things of blockjoin.c that these sets never reach are not modelled
and are refused where they would be needed: phased stretches shorter than
READBACK between gaps (their merging, O1, and the recovery of dropped
intervals, O9-O10), and a FORMAT with PS ahead of GT (O5).
"""
from __future__ import annotations

import gzip
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

READBACK = 50_000            # blockjoin.c:19, a window's reach each side
K, K_SPAN = 3, 5_000         # methmer sites and their span (cli.c)
QUAL_LO, QUAL_HI = 100, 156  # ML below lo: unmethylated; from hi: methylated
MIN_MAPQ, MIN_LEN, MAX_DE = 10, 15_000, 0.1
COV_MIN_MAPQ, COV_BIN = 5, 5_000
LEFT_COV = 15                # reads of each haplotype left of a gap
CONTAMINATE, HARD_COV, P_MAX = 5, 15, 0.001
UNPHASED = 254
NO_BLOCK = 0xFFFFFFFF

# what the maker writes on every read (pbench/maker.py make_read)
READ_MAPQ, READ_DE = 60, 0.01

METH, UNMETH, NOCALL = 0, 1, 2


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), held in
    float32."""
    b = np.atleast_1d(np.asarray(x, dtype=np.float32)).view(np.uint32)
    b = (b.astype(np.uint64) + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


class Arith:
    """float32, or (the control) float32 with every ratio, partial sum and
    difference rounded to bfloat16."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(precision)
        self.bf16 = precision == "bfloat16"

    def r(self, x):
        return _bf16(x) if self.bf16 else np.atleast_1d(
            np.asarray(x, dtype=np.float32))

    def score(self, ratios: np.ndarray) -> np.float32:
        """The sum of the positive ratios, one at a time in methmer order
        (E1)."""
        pos = ratios[ratios > 0]
        if not len(pos):
            return np.float32(0)
        if not self.bf16:
            return np.cumsum(pos, dtype=np.float32)[-1]
        s = np.float32(0)
        for v in pos:
            s = self.r(s + v)[0]
        return s


# ---- the VCF: gaps and phase sets (P1-P3) ----

@dataclass
class Chrom:
    name: str
    abs_start: int
    abs_end: int
    gaps: List[Tuple[int, int]]   # (last position of a set, next set's PS)


def read_vcf(path: str) -> Tuple[List[str], List[Chrom]]:
    """The VCF's lines (without their newlines) and each chromosome's gaps,
    in the order the VCF names them."""
    with gzip.open(path, "rt") as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    chroms: List[Chrom] = []
    prev_ps = None         # P2: kept across chromosomes
    first = True
    for line in lines:
        if not line or line[0] == "#":
            continue
        col = line.split("\t")
        if not chroms or chroms[-1].name != col[0]:
            chroms.append(Chrom(col[0], 0, 0, []))
            prev_pos = None
        ch = chroms[-1]
        fmt = col[8].split(":")
        if "PS" not in fmt:
            continue
        sample = col[9].split(":")
        i_ps = fmt.index("PS")
        if i_ps >= len(sample) or sample[i_ps] == ".":   # P3
            continue
        pos, ps = int(col[1]), int(sample[i_ps])
        if first:
            ch.abs_start, prev_ps, first = pos, ps, False
        if ps != prev_ps and prev_pos is not None:
            ch.gaps.append((prev_pos, ps))                 # P1
        prev_ps = ps
        prev_pos = ch.abs_end = pos
    for ch in chroms:
        for (s0, e0), (s1, _) in zip(ch.gaps, ch.gaps[1:]):
            if s1 - e0 < READBACK:
                raise ValueError(
                    f"{ch.name}: a phased stretch of {s1 - e0} bp between "
                    f"gaps; the reference holds sets without merges (O1)")
    return lines, chroms


def windows(vcf_path: str) -> List[Tuple[str, int, int]]:
    """Every gap a methphase pass decides, in order: (chromosome, start,
    end)."""
    return [(ch.name, s, e) for ch in read_vcf(vcf_path)[1]
            for s, e in ch.gaps]


# ---- the reads ----

class Reads:
    """One chromosome's reads as the maker made them, in the BAM's order."""

    def __init__(self, name: str, t: dict):
        self.name = name
        self.pos, self.end, self.hap = t["pos"], t["end"], t["hap"]
        self.reverse = t["strand"].astype(bool)
        self.draw, self.sites = t["draw"], t["sites"]
        self.call_n, self.ml = t["call_n"], t["ml"]
        self.call_off = np.concatenate(([0], np.cumsum(self.call_n)))
        self.lo_site = np.searchsorted(self.sites, self.pos)

    def qname(self, i: int) -> str:
        ci = int(self.name[3:]) - 1
        return f"c{ci}_read_{int(self.hap[i])}_{int(self.draw[i])}"

    def passes(self, i: int, min_mapq: int) -> bool:
        """The read filters: mapq, length and divergence (every read made
        here is primary and mapped)."""
        return (READ_MAPQ >= min_mapq and self.end[i] - self.pos[i] >= MIN_LEN
                and not READ_DE > MAX_DE)

    def calls(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """The read's calls as the decoder gives them: at each CpG C it
        covers, the class of its ML value (D7); none at the read's first
        or last base (D2), which a reverse read's G takes for a site at its
        end - 2."""
        n = int(self.call_n[i])
        lo = int(self.lo_site[i])
        sites = self.sites[lo:lo + n]
        if len(sites) != n or (n and sites[-1] + 1 >= self.end[i]):
            raise ValueError(f"read {i} of {self.name}: its record and the "
                             "chromosome's sites disagree")
        ml = self.ml[self.call_off[i]:self.call_off[i] + n].astype(np.int64)
        edge = (self.end[i] - 2) if self.reverse[i] else self.pos[i]
        keep = sites != edge
        cls = np.where(ml < QUAL_LO, UNMETH,
                       np.where(ml >= QUAL_HI, METH, NOCALL))
        return sites[keep].astype(np.int64), cls[keep].astype(np.int64)


def coverage(reads: Reads, ref_len: int) -> int:
    """The integer mean of 5 kb bins, each read adding one to the bin of
    every 5 kb step from its start to its end."""
    n_bins = ref_len // COV_BIN
    if n_bins <= 0:
        return 0
    ok = np.array([reads.passes(i, COV_MIN_MAPQ)
                   for i in range(len(reads.pos))], dtype=bool)
    first = reads.pos[ok] // COV_BIN
    steps = -(-(reads.end[ok] - reads.pos[ok]) // COV_BIN)
    total = int(np.minimum(first + steps, n_bins).sum()
                - np.minimum(first, n_bins).sum())
    return total // n_bins


def params(cov: int) -> Tuple[int, int, int]:
    """(calls of each class to select a site, coverage to recruit,
    candidates an iteration) from a chromosome's coverage."""
    sel = max(cov // 10 + 1, 1)
    return sel, 2 * sel, max(cov // 4 + 1, 2)


@dataclass
class Window:
    s: int
    e: int
    idx: np.ndarray            # rows of the chromosome's reads, in order
    calls: List[Tuple[np.ndarray, np.ndarray]]
    hp0: np.ndarray            # each read's haplotype tag as loaded
    pos: np.ndarray
    end: np.ndarray
    left: np.ndarray           # boundary reads, by row in the window
    left_strict: np.ndarray
    right: np.ndarray
    right_strict: np.ndarray


def overlapping(pos: np.ndarray, end: np.ndarray, s: int, e: int,
                readback: int = READBACK) -> np.ndarray:
    """Rows of the reads in the region from max(s - readback, 0) to
    e + readback, 1-based: those that end after max(s - readback, 0) - 1
    and start before e + readback."""
    lo1 = max(s - readback, 0)
    return np.flatnonzero((pos < e + readback) & (end > max(0, lo1 - 1)))


def pass_reads(wins: List[Tuple[str, int, int]],
               rows: Dict[str, np.ndarray]) -> int:
    """A pass's window reads: each gap's overlapping reads, none where the
    left-coverage gate empties it. rows: each chromosome's (pos, end,
    haplotype) rows. Every read the maker makes passes the filters and
    carries calls, so the reads overlapping a gap are its window's."""
    n = 0
    for c, s, e in wins:
        r = rows[c]
        i = overlapping(r[:, 0], r[:, 1], s, e)
        left = r[i, 2][r[i, 0] <= s]
        if min(np.count_nonzero(left == h) for h in (0, 1)) >= LEFT_COV:
            n += len(i)
    return n


def load_window(reads: Reads, s: int, e: int,
                readback: int = READBACK) -> Window:
    """The overlapping reads that pass the filters and carry a call; empty
    where fewer than LEFT_COV of either haplotype start at or before s."""
    rows, calls = [], []
    for i in overlapping(reads.pos, reads.end, s, e, readback):
        if not reads.passes(i, MIN_MAPQ):
            continue
        c = reads.calls(i)
        if len(c[0]):
            rows.append(i)
            calls.append(c)
    idx = np.array(rows, dtype=np.int64)
    pos, end = reads.pos[idx], reads.end[idx]
    hp0 = reads.hap[idx].astype(np.int64)   # HP = haplotype + 1 on every read
    is_left = pos <= s
    is_right = ~is_left & (end >= e)
    w = Window(s, e, idx, calls, hp0, pos, end,
               np.flatnonzero(is_left), np.flatnonzero(is_left & (end > s)),
               np.flatnonzero(is_right),
               np.flatnonzero(is_right & (pos < e)))
    lc = [np.count_nonzero(hp0[w.left] == h) for h in (0, 1)]
    if min(lc) < LEFT_COV:
        none = idx[:0]
        return Window(s, e, none, [], none, none, none, none, none, none,
                      none)
    return w


# ---- methmers (M1-M7) ----

def select_sites(w: Window, sel: int) -> np.ndarray:
    """Positions with at least `sel` methylated and `sel` unmethylated
    calls among the window's reads (M1)."""
    if not w.calls:
        return np.zeros(0, dtype=np.int64)
    pos = np.concatenate([c[0] for c in w.calls])
    cls = np.concatenate([c[1] for c in w.calls])
    u, inv = np.unique(pos, return_inverse=True)
    m = np.bincount(inv[cls == METH], minlength=len(u))
    un = np.bincount(inv[cls == UNMETH], minlength=len(u))
    return u[(m >= sel) & (un >= sel)]


def layout(sites: np.ndarray, direction: int) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """(grid, lengths): each site's methmer starts at grid[i] and takes
    lengths[i] grid positions. Forward, site i's methmer runs to the site
    before min(i + K, n - 1, the last site within K_SPAN of it); backward
    the same with the sites taken from the right, its grid the leftmost
    site of the span (M2)."""
    n = len(sites)
    i = np.arange(n)
    if direction == 0:
        last = np.searchsorted(sites, sites + K_SPAN, side="right") - 1
        j = np.minimum(np.minimum(i + K, n - 1), last)
        return sites.copy(), np.maximum(j - i, 1)
    d = sites[::-1]
    last = np.searchsorted(-d, -d + K_SPAN, side="right") - 1
    j = np.minimum(np.minimum(i + K, n - 1), last)
    return d[j][::-1].copy(), np.maximum(j - i, 1)[::-1].copy()


def methmers(calls: Tuple[np.ndarray, np.ndarray], grid: np.ndarray,
             lens: np.ndarray) -> Tuple[int, np.ndarray]:
    """(first site index, keys) of one read on a layout. The read's grid
    entries are those of indices [left, right): left the first at its
    first call, or the last before it; right the first at or after its
    last call (M5). Of these an entry stands where it differs from the one
    stored before it, or sits at index 0 or 1 (M3, M4). Each entry gives
    a methmer for every index of its run from its own, built from the
    next lengths[index] entries: a call's class where the read has one
    and the entry is the last at its position, else missing (2). Those
    that run out of entries are dropped (M6); the rest are stored from
    the first one's index on, as far as the sites go."""
    pos, cls = calls
    n = len(grid)
    if n == 0 or not len(pos):
        return 0, np.zeros(0, dtype=np.int64)
    first, last = int(pos[0]), int(pos[-1])
    if first > grid[-1] or last < grid[0]:
        return 0, np.zeros(0, dtype=np.int64)
    if first < grid[0]:
        left = 0
    else:
        lo = int(np.searchsorted(grid, first))
        left = lo if lo < n and grid[lo] == first else lo - 1
    right = n if last > grid[-1] else int(np.searchsorted(grid, last))
    if right <= left:
        return 0, np.zeros(0, dtype=np.int64)
    ii = np.arange(left, right)
    stand = (ii <= 1) | (grid[ii] != grid[np.maximum(ii - 1, 0)])
    ent = ii[stand]
    m = len(ent)
    if m == 0:
        return 0, np.zeros(0, dtype=np.int64)
    ep = grid[ent]
    k = np.searchsorted(pos, ep)
    kc = np.minimum(k, len(pos) - 1)
    hit = (k < len(pos)) & (pos[kc] == ep)
    hit &= np.append(ep[1:] != ep[:-1], True)   # only the last at a position
    chars = np.where(hit, cls[kc], NOCALL)
    first_i, keys = None, []
    for r, p in enumerate(ent):
        q = int(p)
        while q < n and grid[q] == grid[p]:
            L = int(lens[q])
            if r + L <= m:
                if first_i is None:
                    first_i = q
                v = 0
                for c in chars[r:r + L]:
                    v = v * 4 + int(c)
                keys.append(v)
            q += 1
    if first_i is None:
        return 0, np.zeros(0, dtype=np.int64)
    keys = keys[:n - first_i]
    return first_i, np.array(keys, dtype=np.int64)


# ---- the greedy extension (E1-E7) ----

class Table:
    """Counts of each methmer key at each site by haplotype, and their sums."""

    def __init__(self, n: int):
        self.cnt = np.zeros((n, 4 ** K, 2), dtype=np.int64)
        self.sums = np.zeros((n, 2), dtype=np.int64)
        self.n = n

    def add(self, start: int, keys: np.ndarray, hap: int) -> None:
        at = np.arange(start, start + len(keys))
        self.cnt[at, keys, hap] += 1
        self.sums[at, hap] += 1

    def grow(self, lo: int, hi: int, cov: int) -> Tuple[int, int]:
        """E6: from lo down and from hi up, each moves to the last site
        whose sums reach cov."""
        tot = self.sums.sum(1)
        i = lo
        while i >= 0 and tot[i] >= cov:
            lo, i = i, i - 1
        i = hi
        while i < self.n and tot[i] >= cov:
            hi, i = i, i + 1
        return lo, hi


def score_read(t: Table, start: int, keys: np.ndarray, lo: int, hi: int,
               ar: Arith) -> Tuple[int, np.float32]:
    """(tag, score): each haplotype's score is the sum of the read's ratios
    count / sum at the sites of [lo, hi) where its key was counted and the
    haplotype's sum is not 0, its length those ratios and again the
    positive ones (E1). Untagged (-1, 0) where the scores differ by less
    than 3 and either length is under 3; else the larger score's
    haplotype, 1 on a tie (E2), and the difference."""
    at = np.arange(start, start + len(keys))
    inr = (at >= lo) & (at < hi)
    at, ky = at[inr], keys[inr]
    c = t.cnt[at, ky]
    found = c.sum(1) > 0
    sc, ln = [], []
    for h in (0, 1):
        s = t.sums[at, h]
        ok = found & (s != 0)
        ratios = ar.r(c[ok, h].astype(np.float32) / s[ok].astype(np.float32))
        sc.append(ar.score(ratios))
        ln.append(len(ratios) + int(np.count_nonzero(ratios > 0)))
    s0, s1 = sc
    diff = ar.r(s0 - s1 if s0 > s1 else s1 - s0)[0]
    if diff < 3 and (ln[0] < 3 or ln[1] < 3):
        return -1, np.float32(0)
    return (0 if s0 > s1 else 1), diff


def extend(w: Window, sites: np.ndarray, mm: List[Tuple[int, np.ndarray]],
           hp: np.ndarray, direction: int, n_cand: int, cov: int,
           ar: Arith) -> np.ndarray:
    """One direction's greedy run from the tags `hp`: the boundary reads
    of its side (left forward, right backward) seed the table; each
    iteration scores the first n_cand untagged reads from the last place
    that failed (forward in the window's order, backward by end) and
    commits the best one; ten failures in a row end it (E3-E5, E7).
    Returns the tags it leaves."""
    n, ns = len(hp), len(sites)
    if direction == 0:
        lo, hi = 0, int(np.count_nonzero(sites <= w.s))
        seed = w.left
        order = np.arange(n)
    else:
        lo = int(np.count_nonzero(sites <= w.e)) - 1
        hi = ns - 1
        seed = w.right
        order = np.lexsort((np.arange(n), w.end))
    t = Table(ns)
    for r in seed:
        st, keys = mm[r]
        if hp[r] in (0, 1) and len(keys):
            t.add(st, keys, int(hp[r]))
    lo, hi = t.grow(lo, hi, cov)
    tags = np.full(n, 2, dtype=np.int64)
    tags[seed] = hp[seed] & 3
    step = 1 if direction == 0 else -1
    at = 0 if direction == 0 else n - 1
    fails = 0
    while (at < n) if direction == 0 else (at > 0):
        cand, i0 = [], at
        while 0 <= i0 < n:
            r = int(order[i0])
            if tags[r] not in (0, 1):
                cand.append(r)
                if len(cand) >= n_cand:
                    break
            i0 += step
        best = None
        for j, r in enumerate(cand):
            tag, sc = score_read(t, mm[r][0], mm[r][1], lo, hi, ar)
            if tag >= 0 and (best is None or sc >= best[0]):
                best = (sc, r, tag)
        if best is None:
            fails += 1
            if fails > 10:
                break
            at += n_cand * step
            continue
        _, r, tag = best
        tags[r] = tag
        if len(mm[r][1]):
            t.add(mm[r][0], mm[r][1], tag)
        lo, hi = t.grow(lo, hi, cov)
        fails = 0
    return tags


def fisher_two_sided(a: int, b: int, c: int, d: int) -> float:
    """Fisher's exact test as htslib's kt_fisher_exact sums it: each tail
    walked in from its end while a table is less likely than the observed
    one (1e-8 relative), the table where it stops taken if as likely."""
    r1, c1, n = a + b, a + c, a + b + c + d
    lo, hi = max(0, r1 + c1 - n), min(r1, c1)
    if lo == hi:
        return 1.0

    def lb(x, y):
        return math.lgamma(x + 1) - math.lgamma(y + 1) - math.lgamma(x - y + 1)

    def p(k):
        return math.exp(lb(r1, k) + lb(n - r1, c1 - k) - lb(n, c1))

    q = p(a)
    total = 0.0
    for ks in (range(lo, hi + 1), range(hi, lo - 1, -1)):
        for k in ks:
            pk = p(k)
            if pk < 0.99999999 * q:
                total += pk
                continue
            if pk < 1.00000001 * q:
                total += pk
            break
    return min(total, 1.0)


def separation(ref: np.ndarray, got: np.ndarray, ar: Arith
               ) -> Tuple[float, int]:
    """(score, way) of the boundary reads' tags as loaded against as the
    run left them: way +2 where the 2x2 table's diagonal dominates (cis),
    -2 where the other does (trans); (1, -9) where a row is mixed by more
    than CONTAMINATE in its smaller cell, a row is empty or under 3 to 1,
    or Fisher's p is not under P_MAX, or a row's smaller cell is over
    HARD_COV (E11)."""
    ok = np.isin(ref, (0, 1)) & np.isin(got, (0, 1))
    t = np.zeros((2, 2), dtype=np.int64)
    np.add.at(t, (ref[ok], got[ok]), 1)
    if t[0].min() > CONTAMINATE or t[1].min() > CONTAMINATE:
        return 1.0, -9
    way, scores = 0, []
    for i in (0, 1):
        hi, lo = int(t[i].max()), int(t[i].min())
        way += (1 if t[i, 0] > t[i, 1] else -1) * (1 if i == 0 else -1)
        if hi == 0:
            return 1.0, -9
        lo = max(lo, 1)
        if hi / lo < 3:
            return 1.0, -9
        scores.append(float(ar.r(np.float32(hi) / np.float32(lo))[0]))
    hard = t[0].min() > HARD_COV or t[1].min() > HARD_COV
    if fisher_two_sided(int(t[0, 0]), int(t[0, 1]), int(t[1, 0]),
                        int(t[1, 1])) < P_MAX and not hard:
        return min(scores), way
    return 1.0, -9


def vote(score: float, way: int) -> int:
    """One run (the main path's n_permutation = 1, E9): it joins, cis for a
    positive way and trans for a negative one, where its score is 2 or
    more."""
    if score >= 2 and way not in (-9, 0) and score > 1.0:
        return 0 if way > 0 else 1
    return -1


def decide(reads: Reads, s: int, e: int, cov: int,
           precision: str = "float32", readback: int = READBACK) -> dict:
    """One gap: its decision (0 cis, 1 trans, -1 none), and where it joins
    every window read's tag as the forward run left it (E10)."""
    ar = Arith(precision)
    sel, runtime, n_cand = params(cov)
    w = load_window(reads, s, e, readback)
    sites = select_sites(w, sel)
    if len(sites) == 0:
        return dict(decision=-1, tags={}, reads=len(w.idx))
    raw = np.where(np.isin(w.hp0, (0, 1)), w.hp0, UNPHASED)
    out = []
    for direction in (1, 0):
        grid, lens = layout(sites, direction)
        mm = [methmers(c, grid, lens) for c in w.calls]
        tags = extend(w, sites, mm, raw.copy(), direction, n_cand, runtime,
                      ar)
        side = w.right_strict if direction == 0 else w.left_strict
        d = vote(*separation(raw[side], tags[side], ar))
        out.append((d, tags))
    (d_bwd, _), (d_fwd, tags) = out
    if d_fwd != d_bwd or d_fwd < 0:
        return dict(decision=-1, tags={}, reads=len(w.idx))
    return dict(decision=int(d_fwd),
                tags={reads.qname(int(i)): int(h)
                      for i, h in zip(w.idx, tags)},
                reads=len(w.idx))


# ---- the outputs (P2, O2-O6) ----

def phase_blocks(ch: Chrom, decisions: List[int]) -> List[Tuple[int, int]]:
    """The new blocks: from abs_start to each unjoined gap's start, on
    from its end; the last from the last unjoined gap's START to abs_end
    (O2), or from abs_start where every gap joined."""
    out, start, end = [], ch.abs_start, NO_BLOCK
    for (gs, ge), d in zip(ch.gaps, decisions):
        if d >= 0:
            continue
        end = gs
        out.append((start, end))
        start = ge
    if ch.gaps and end != ch.abs_end:
        out.append((ch.abs_start if end == NO_BLOCK else end, ch.abs_end))
    return out


def flips(decisions: List[int]) -> List[int]:
    """Each gap's flip: a trans join toggles it, a cis join keeps it, no
    join resets it to 0."""
    out, f = [], 0
    for d in decisions:
        f = 0 if d < 0 else f ^ d
        out.append(f)
    return out


def gtf_lines(chroms: List[Chrom], decisions: Dict[str, List[int]]
              ) -> List[str]:
    """.mp.gtf: a line a block, blocks that start or end at 0 left out
    (P2)."""
    out = []
    for ch in chroms:
        for s, e in phase_blocks(ch, decisions[ch.name]):
            if s and e:
                out.append(f'{ch.name}\tPhasing\texon\t{s}\t{e}\t.\t+\t.\t'
                           f'gene_id "{s}"; transcript_id "{s}.1"')
    return out


def vcf_lines(lines: List[str], chroms: List[Chrom],
              decisions: Dict[str, List[int]]) -> List[str]:
    """.mp.vcf: every line of the input; a phased 0/1 genotype inside a new
    block takes the block's start as its PS (strictly before its end,
    O3) and is flipped where the last gap that starts before it carries a
    flip (O4, O6: looked up with blockjoin.c's cursor, which only a
    position lower than the line before it resets)."""
    by = {ch.name: ch for ch in chroms}
    blocks = {n: phase_blocks(ch, decisions[n]) for n, ch in by.items()}
    fl = {n: flips(decisions[n]) for n in by}
    out, prev_pos, cur = [], -1, 0
    for line in lines:
        if line.startswith("#"):
            out.append(line)
            continue
        col = line.split("\t")
        if col[0] not in by:
            out.append(line)
            continue
        pos = int(col[1])
        if pos < prev_pos:
            cur = 0
        prev_pos = pos
        fmt = col[8].split(":")
        if "PS" not in fmt or len(col) < 10:
            out.append(line)
            continue
        i_ps = fmt.index("PS")
        i_gt = fmt.index("GT") if "GT" in fmt else -1
        sample = col[9].split(":")
        gt = sample[i_gt] if 0 <= i_gt < len(sample) else ""
        if (i_ps >= len(sample) or sample[i_ps] == "." or len(gt) < 3
                or gt[1] != "|" or gt[0] not in "01" or gt[2] not in "01"):
            out.append(line)
            continue
        if i_gt > i_ps:
            raise ValueError("FORMAT with PS ahead of GT (O5) is not modelled")
        ch = by[col[0]]
        gid = next((s for s, e in blocks[ch.name]
                    if s != NO_BLOCK and e not in (0, NO_BLOCK)
                    and s <= pos < e), -1)
        starts = [g[0] for g in ch.gaps]
        f = fl[ch.name]
        j = cur
        while j < len(starts) and starts[j] < pos:
            j += 1
        if not starts:
            flip = -1
        elif j < len(starts):
            cur = max(j - 1, 0)
            flip = 0 if pos <= starts[0] else (f[cur] if f else -1)
        else:
            cur = j - 1
            flip = f[-1] if f else -1
        if gid < 0:
            out.append(line)
            continue
        sample[i_ps] = str(gid)
        if flip:
            g0 = "1" if gt[0] == "0" else "0"
            sample[i_gt] = g0 + "|" + ("1" if g0 == "0" else "0") + gt[3:]
        col[9] = ":".join(sample)
        out.append("\t".join(col[:9] + [col[9]] + col[10:]))
    return out
