"""Per-gap read window loading (load_reads_given_interval,
blockjoin.c:1043-1173).

Loads reads overlapping [itvl_s - readback, itvl_e + readback], decodes their
5mC calls, classifies boundary ("ref") reads on both sides of the gap, and
prepares the end-sorted ordering used by backward extension.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..io.bam import BamReader, bam_endpos
from ..io.basemod import read_meth_calls
from ..utils.log import log_warn
from ..utils.stats import count
from .variants import HAPTAG_UNPHASED

READBACK = 50000      # blockjoin.c:19
MIN_ALN_DE = 0.1      # blockjoin.c:23
UINT32_MAX = 0xFFFFFFFF


@dataclass
class MmrConfig:
    """mmr_config_t (blockjoin.h:7-16). Defaults mirror cli.c:48-74."""
    k: int = 3
    k_span: int = 5000
    lo: int = 100
    hi: int = 156
    cov_known: int = -1
    cov_for_selection: int = -1
    cov_for_runtime: int = -2
    readlen_threshold: int = 15000
    min_mapq: int = 10


@dataclass(slots=True)
class Read:
    i: int
    qname: str
    hp: int
    strand: int
    length: int
    start_pos: int
    end_pos: int
    calls: np.ndarray          # uint32 ref positions (ascending by emit order)
    quals: np.ndarray          # uint8 classes 0=meth 1=unmeth 2=nocall
    # methmer storage (filled by store_mmr_of_reads)
    mmr: Optional[np.ndarray] = None
    mmr_n: int = 0
    mmr_start_i: int = UINT32_MAX


@dataclass
class ReadSet:
    ref_start: int
    ref_end: int
    reads: List[Read] = field(default_factory=list)
    ids_left: List[int] = field(default_factory=list)
    ids_left_strict: List[int] = field(default_factory=list)
    ids_right: List[int] = field(default_factory=list)
    ids_right_strict: List[int] = field(default_factory=list)
    rev_order: List[int] = field(default_factory=list)  # read IDs sorted by (end, id)
    has_mmr: bool = False
    # memoized derived arrays (reads' calls/quals never change after load):
    # concat_calls() result, and the per-cov methmer site selection
    _calls_concat: Optional[tuple] = field(default=None, repr=False)
    _site_sel_cache: Optional[tuple] = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return len(self.reads)

    def concat_calls(self) -> tuple:
        """(calls, quals, call_off, call_n) concatenated over all reads,
        computed once per window (both methmer directions and the site
        selection consume the identical concatenation)."""
        if self._calls_concat is None:
            calls = np.concatenate([r.calls for r in self.reads]) if self.reads \
                else np.zeros(0, dtype=np.uint32)
            quals = np.concatenate([r.quals for r in self.reads]) if self.reads \
                else np.zeros(0, dtype=np.uint8)
            call_n = np.asarray([len(r.calls) for r in self.reads],
                                dtype=np.int32)
            call_off = np.zeros(self.n, dtype=np.int64)
            if self.n:
                np.cumsum(call_n[:-1], out=call_off[1:])
            self._calls_concat = (calls, quals, call_off, call_n)
        return self._calls_concat

    def store_haplotags(self) -> np.ndarray:
        # uint8 snapshot (store_haplotags, blockjoin.c:518-526)
        return np.array([r.hp & 0xFF for r in self.reads], dtype=np.uint8)

    def restore_haplotags(self, tags: np.ndarray) -> None:
        for r, t in zip(self.reads, tags):
            r.hp = int(t)

    def set_all_as_unphased(self) -> None:
        for r in self.reads:
            r.hp = 2


_HP_ABSENT = -(2 ** 31)  # native bam_window_load's "no HP tag" sentinel


class _WindowBuilder:
    """Shared per-window ReadSet assembly: dup check, HP semantics
    (get_hp_from_aln, blockjoin.c:910-923), raw-tag override, boundary
    classification, end-sorted ordering and the left-coverage gate
    (blockjoin.c:1127-1163). Used by both the per-window loader and the
    whole-chromosome columnar source so their semantics cannot drift."""

    def __init__(self, itvl_s: int, itvl_e: int,
                 qname2haptag_raw: Optional[Dict[str, int]]):
        self.rs = ReadSet(ref_start=max(itvl_s, 0), ref_end=itvl_e)
        self.itvl_s = itvl_s
        self.itvl_e = itvl_e
        self.q2h = qname2haptag_raw
        self.left_cov = [0, 0]
        self.seen = set()

    def add_read(self, qname, hp_tag, start_pos, strand, length, end_pos,
                 calls, quals) -> None:
        if qname in self.seen:
            raise ValueError(f"duplicated read name seen from reading bam: {qname}")
        self.seen.add(qname)
        if hp_tag is None:
            hp = HAPTAG_UNPHASED
        elif hp_tag == 0:
            log_warn("get_hp_from_aln", f"irregular HP tag? qn={qname} qs={start_pos}")
            hp = HAPTAG_UNPHASED
        else:
            hp = hp_tag - 1
        if self.q2h is not None:
            hp = self.q2h.get(qname, HAPTAG_UNPHASED)
        rs = self.rs
        rid = rs.n
        rs.reads.append(Read(
            i=rid, qname=qname, hp=hp, strand=strand,
            length=length, start_pos=start_pos, end_pos=end_pos,
            calls=calls, quals=quals,
        ))
        if start_pos <= self.itvl_s:
            rs.ids_left.append(rid)
            if end_pos > self.itvl_s:
                rs.ids_left_strict.append(rid)
            if hp in (0, 1):
                self.left_cov[hp] += 1
        elif end_pos >= self.itvl_e:
            rs.ids_right.append(rid)
            if start_pos < self.itvl_e:
                rs.ids_right_strict.append(rid)

    def finish(self) -> ReadSet:
        rs = self.rs
        rs.rev_order = sorted(range(rs.n),
                              key=lambda i: (rs.reads[i].end_pos, i))
        # left-side haplotype coverage gate (blockjoin.c:1161-1163)
        if self.left_cov[0] < 15 or self.left_cov[1] < 15:
            rs.reads = []
            rs.ids_left = []
            rs.ids_left_strict = []
            rs.ids_right = []
            rs.ids_right_strict = []
            rs.rev_order = []
        return rs


def load_reads_given_interval(
    bam: BamReader,
    chrom: str,
    itvl_s: int,
    itvl_e: int,
    readback: int,
    config: MmrConfig,
    qname2haptag_raw: Optional[Dict[str, int]] = None,
) -> ReadSet:
    wb = _WindowBuilder(itvl_s, itvl_e, qname2haptag_raw)
    rs = wb.rs
    lo1 = itvl_s - readback if itvl_s - readback > 0 else 0
    add_read = wb.add_read

    cols = buf = None
    fwc = getattr(bam, "fetch_window_columnar", None)
    if fwc is not None and not os.environ.get("POMFRET_NO_NATIVE_WINDOW"):
        cols, buf = fwc(chrom, max(0, lo1 - 1), itvl_e + readback,
                        config.min_mapq, config.readlen_threshold,
                        MIN_ALN_DE, config.lo, config.hi)
    if cols is not None:
        # native fast path: one C++ call decoded the window; only reads the
        # single-'C+m' decoder can't handle come back for the Python oracle
        if cols["has_implicit"]:
            from ..utils.log import set_data_has_implicit
            set_data_has_implicit()
        from ..io.bam import decode_record
        call_off = cols["call_off"] if cols["n"] else None
        for j in range(cols["n"]):
            if cols["fallback"][j]:
                # fallback reads are rare: slice just this record's bytes
                # (4-byte block_size prefix + body) instead of copying the
                # whole multi-MB window buffer per window
                off = int(cols["rec_off"][j])
                if isinstance(buf, bytes):
                    bs = int.from_bytes(buf[off : off + 4], "little")
                    rec_bytes = buf[off : off + 4 + bs]
                else:
                    bs = int.from_bytes(buf[off : off + 4].tobytes(), "little")
                    rec_bytes = buf[off : off + 4 + bs].tobytes()
                rec, _ = decode_record(rec_bytes, 0)
                calls_l, quals_l, has_implicit = read_meth_calls(
                    rec, config.lo, config.hi)
                if has_implicit:
                    from ..utils.log import set_data_has_implicit
                    set_data_has_implicit()
                if not calls_l:
                    continue
                calls = np.asarray(calls_l, dtype=np.uint32)
                quals = np.asarray(quals_l, dtype=np.uint8)
            else:
                o = int(call_off[j])
                cn = int(cols["call_n"][j])
                calls = cols["calls"][o : o + cn].copy()
                quals = cols["quals"][o : o + cn].copy()
            hp_raw = int(cols["hp"][j])
            add_read(cols["qnames"][j],
                     None if hp_raw == _HP_ABSENT else hp_raw,
                     int(cols["pos"][j]), int(cols["strand"][j]),
                     int(cols["l_seq"][j]), int(cols["endpos"][j]),
                     calls, quals)
    else:
        for rec in bam.fetch_region_1based(chrom, lo1, itvl_e + readback):
            if rec.flag & (4 | 256 | 2048):
                continue
            if rec.mapq < config.min_mapq:
                continue
            if rec.l_seq < 2 or rec.l_seq < config.readlen_threshold:
                continue
            de = rec.get_tag("de")
            if de is not None and de > MIN_ALN_DE:
                continue
            calls, quals, has_implicit = read_meth_calls(rec, config.lo, config.hi)
            if has_implicit:
                from ..utils.log import set_data_has_implicit
                set_data_has_implicit()
            if not calls:
                continue
            add_read(rec.qname, rec.get_tag("HP"), rec.pos,
                     1 if rec.is_reverse else 0, rec.l_seq, bam_endpos(rec),
                     np.asarray(calls, dtype=np.uint32),
                     np.asarray(quals, dtype=np.uint8))

    return wb.finish()



class ChromReadSource:
    """Columnar read store for one chromosome, sliced into gap windows.

    The per-window loader re-decodes every read that falls in more than one
    ±READBACK halo (~1.4x the records on a WGS-like gap spacing) and pays a
    native-call + allocation round trip per window. This source decodes each
    record ONCE into columnar slabs (pos/endpos/strand/hp/l_seq/qname plus
    ONE concatenated calls/quals slab with per-read offsets), then
    materializes any window by binary search. Filters, overlap predicate
    (pos < end and endpos > beg, bam_window_load), HP semantics and boundary
    classification match load_reads_given_interval exactly (asserted
    read-for-read by tests/test_window_native.py).

    regions=None decodes the whole chromosome segment by segment (so the
    decompressed buffer never exceeds one segment). regions=[(beg, end),
    ...] (ascending, disjoint) decodes ONLY the segments overlapping the
    given spans — the window-union mode: callers pass the merged union of
    their windows' ±READBACK halos, so a sparse-gap WGS chromosome never
    decodes the space between its gaps, while every halo-overlapping
    record is still decoded exactly once (reads entering a region from the
    left ride the BAI query of its first segment; cross-region duplicates
    drop by record file offset).

    Only usable when the native columnar loader is available; callers fall
    back to per-window loads otherwise (ok == False).
    """

    def __init__(self, bam: BamReader, chrom: str, config: MmrConfig,
                 seg_len: int = 0, regions=None):
        self.ok = False
        self.chrom = chrom
        if seg_len <= 0:
            # Small genomic tiles keep each plain-BAM span (and the native
            # call's scratch) to tens of MB, so consecutive tiles recycle
            # the same heap pages (utils/malloc_tune.py) instead of first-
            # touching a whole-chromosome span — on the virtualized hosts
            # new-page faults cost ~100x warm ones, so peak footprint, not
            # inflate throughput, dominated this scan at seg_len=8M.
            seg_len = int(os.environ.get("POMFRET_CHROM_SEG_LEN",
                                         1_000_000))
        fwc = getattr(bam, "fetch_window_columnar", None)
        if fwc is None or os.environ.get("POMFRET_NO_NATIVE_WINDOW") \
                or os.environ.get("POMFRET_NO_CHROM_SCAN"):
            return
        tid = bam.ref_id(chrom)
        if tid < 0:
            # unknown chromosome: every window is legitimately empty
            self._empty_init()
            return
        ref_len = bam.ref_lens[tid]

        if regions is None:
            regions = [(0, ref_len)]

        from ..utils.stats import current_group, group, stage

        ics = getattr(bam, "iter_columnar_segments", None)
        if ics is not None:
            # reader-provided segmentation (CRAM: one segment per slice,
            # each decoded+parsed exactly once — genomic tiles re-parsed
            # every overlapping multi-MB slice per tile). Records are
            # unique across segments; rec_off gets a per-segment base so
            # the cross-segment dedup never collides.
            parts = []
            base = 0
            _END = object()
            items = iter(ics(chrom, None if regions == [(0, ref_len)]
                             else regions, config.min_mapq,
                             config.readlen_threshold, MIN_ALN_DE,
                             config.lo, config.hi))
            while True:
                with stage("wl_src_fetch"):
                    item = next(items, _END)
                if item is _END:
                    break
                if item is None:
                    return  # reader bailed (spool mode/no native)
                cols, buf = item
                with stage("wl_src_assemble"):
                    part = self._segment_part(cols, buf, config, None,
                                              off_base=base)
                base += len(buf) + 1
                if part is not None:
                    parts.append(part)
            with stage("wl_src_finish"):
                self._finish_init(parts)
            return

        # Adaptive segmentation: genomic seg_len is the UPPER bound, and a
        # compressed-byte cap (BAI linear index, 16 kb granularity) splits
        # dense spans further. A 222x chromosome at the 1 Mb genomic
        # default inflated ~340 MB of plain bytes per segment into FRESH
        # pages each time — fresh-page inflate runs at ~177 MB/s on these
        # virtualized hosts vs ~1 GB/s into recycled pages (the round-4
        # seg_len note, now bounded in BYTES so coverage cannot re-open
        # it). POMFRET_SEG_COMP_MB overrides the cap (default 8 MB
        # compressed ~= 60-90 MB plain).
        comp = None
        idx = bam._load_index() if hasattr(bam, "_load_index") else None
        if idx is not None and tid < len(idx.intervals) \
                and len(idx.intervals[tid]):
            ivs = np.asarray(idx.intervals[tid], dtype=np.uint64)
            comp = np.maximum.accumulate(ivs >> np.uint64(16)).astype(
                np.int64)
        comp_cap = int(float(os.environ.get("POMFRET_SEG_COMP_MB", "8"))
                       * (1 << 20))

        segs = []  # (g0, g1, first-of-region)
        for r_lo, r_hi in regions:
            r_lo = max(0, int(r_lo))
            r_hi = min(ref_len, int(r_hi))
            first = True
            g0 = r_lo
            while g0 < r_hi:
                g1 = min(g0 + seg_len, r_hi)
                if comp is not None:
                    w0 = min(g0 >> 14, len(comp) - 1)
                    w1 = int(np.searchsorted(comp, comp[w0] + comp_cap,
                                             side="right"))
                    # always advance at least one 16 kb window
                    g1 = min(g1, max((w1 << 14), g0 + (1 << 14)))
                    g1 = min(g1, r_hi)
                segs.append((g0, g1, first))
                first = False
                g0 = g1

        # decompress into the reader's double-buffered arena when the
        # reader supports it (BAM): each segment's plain buffer reuses
        # already-touched pages instead of a fresh allocation per segment
        fkw = {"reuse_buffer": True} if getattr(bam, "fetch_reuse", False) \
            else {}

        gid = current_group()  # the pipe's worker serves it too

        def _fetch(seg):
            g0, g1, _first = seg
            with group(gid), stage("wl_src_fetch"):
                return fwc(chrom, g0, g1, config.min_mapq,
                           config.readlen_threshold, MIN_ALN_DE,
                           config.lo, config.hi, **fkw)

        # one-deep segment pipeline: the native decode of segment k+1
        # (inflate + bam_window_load, GIL-releasing) runs on a single
        # worker thread while the main thread does segment k's numpy
        # assembly — the wl arenas double-buffer per call so k's slabs
        # survive k+1's fetch. Default OFF below 4 host cores: the native
        # calls already saturate a 2-core host with their internal
        # threads, and the handoff overhead measured 1.78 s vs 1.16 s
        # serial (interleaved medians, 4-chrom bench scan).
        # POMFRET_SEG_PIPE=1 forces on, POMFRET_NO_SEG_PIPE=1 off.
        parts = []  # per-segment dicts of columnar arrays
        want_pipe = os.environ.get(
            "POMFRET_SEG_PIPE",
            "1" if (os.cpu_count() or 2) >= 4 else "")
        pipe = (len(segs) > 1 and bool(want_pipe)
                and not os.environ.get("POMFRET_NO_SEG_PIPE"))
        if pipe:
            import concurrent.futures as _fut
            ex = _fut.ThreadPoolExecutor(1)
            try:
                nxt = ex.submit(_fetch, segs[0])
                for k, seg in enumerate(segs):
                    with stage("wl_src_wait"):  # the worker's fetch
                        cols, buf = nxt.result()
                    if k + 1 < len(segs):
                        nxt = ex.submit(_fetch, segs[k + 1])
                    if cols is None:
                        return  # native path unavailable: stay not-ok
                    with stage("wl_src_assemble"):
                        part = self._segment_part(cols, buf, config,
                                                  None if seg[2] else seg[0])
                    if part is not None:
                        parts.append(part)
            finally:
                ex.shutdown(wait=True)
        else:
            for g0, g1, first in segs:
                cols, buf = _fetch((g0, g1, first))
                if cols is None:
                    return
                with stage("wl_src_assemble"):
                    part = self._segment_part(cols, buf, config,
                                              None if first else g0)
                if part is not None:
                    parts.append(part)

        with stage("wl_src_finish"):
            self._finish_init(parts)

    def _finish_init(self, parts):
        if not parts:
            self._empty_init()
            return
        pos = np.concatenate([p["pos"] for p in parts])
        rec_off = np.concatenate([p["rec_off"] for p in parts])
        # sort by (pos, rec_off) and drop cross-region duplicates (a read
        # longer than the gap between two regions is returned by both; its
        # file offset identifies it). Whole-chrom scans are already sorted
        # and duplicate-free, so this is a near-no-op there.
        order = np.lexsort((rec_off, pos))
        ro = rec_off[order]
        _, first_idx = np.unique(ro, return_index=True)
        sel = order[np.sort(first_idx)] if len(first_idx) != len(ro) \
            else order

        def _take(key):
            return np.concatenate([p[key] for p in parts])[sel]

        self.pos = pos[sel]
        self.end = _take("end")
        self.strand = _take("strand")
        self.hp = _take("hp")
        self.lseq = _take("lseq")
        qn_all = [q for p in parts for q in p["qnames"]]
        self.qnames = [qn_all[int(i)] for i in sel]
        # single calls/quals slab + per-read offsets, re-gathered into the
        # sorted read order
        bases = np.zeros(len(parts), dtype=np.int64)
        if len(parts) > 1:
            np.cumsum([len(p["calls"]) for p in parts[:-1]],
                      out=bases[1:])
        slab_off = np.concatenate(
            [p["call_off"] + b for p, b in zip(parts, bases)])[sel]
        calls_all = np.concatenate([p["calls"] for p in parts])
        quals_all = np.concatenate([p["quals"] for p in parts])
        n = len(sel)
        self.call_n = _take("call_n")
        new_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(self.call_n, out=new_off[1:])
        total = int(new_off[-1])
        if total:
            gath = (np.repeat(slab_off, self.call_n)
                    + np.arange(total, dtype=np.int64)
                    - np.repeat(new_off[:-1], self.call_n))
            self.calls_slab = calls_all[gath]
            self.quals_slab = quals_all[gath]
        else:
            self.calls_slab = np.zeros(0, dtype=np.uint32)
            self.quals_slab = np.zeros(0, dtype=np.uint8)
        self.call_off = new_off
        self.max_span = int((self.end - self.pos).max()) if n else 1
        self._hp_absent = _HP_ABSENT
        # duplicate qnames anywhere in the source: use the per-window
        # builder so the duplicate check fires per window with the
        # reference's semantics (blockjoin.c:1148)
        self._has_dups = len(set(self.qnames)) != n
        self.ok = True

    def _segment_part(self, cols, buf, config: MmrConfig, skip_below,
                      off_base: int = 0):
        """Columnar arrays for one decoded segment: vectorized selection of
        the kept records (skip pos < skip_below: decoded by an earlier
        segment of the same region); rare fallback records re-decode
        through the Python oracle, spliced in record order. off_base
        shifts rec_off into a per-segment range (reader-segmented sources
        reuse stream-local offsets). Adds the records the segment's load
        parsed, kept or not, and its plain bytes to the counters
        source_records and source_plain_bytes (utils.stats)."""
        from ..io.bam import decode_record
        n = cols["n"]
        if "n_parsed" in cols:  # the JAX package's reader does not count
            count("source_records", cols["n_parsed"])
        count("source_plain_bytes", len(buf))
        if not n:
            return None
        if cols["has_implicit"]:
            from ..utils.log import set_data_has_implicit
            set_data_has_implicit()
        pos = np.asarray(cols["pos"], dtype=np.int64)
        keep = np.ones(n, dtype=bool) if skip_below is None \
            else pos >= skip_below
        fb = np.asarray(cols["fallback"], dtype=bool)
        idx = np.flatnonzero(keep & ~fb)
        call_off_in = np.asarray(cols["call_off"][:n], dtype=np.int64)
        call_n_in = np.asarray(cols["call_n"], dtype=np.int64)
        lens = call_n_in[idx]
        part_off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=part_off[1:])
        total = int(part_off[-1])
        gath = (np.repeat(call_off_in[idx], lens)
                + np.arange(total, dtype=np.int64)
                - np.repeat(part_off[:-1], lens)) if total else \
            np.zeros(0, dtype=np.int64)
        # record identity for the cross-segment/cross-region dedup: the
        # ABSOLUTE virtual offset when the reader provides one (BAM —
        # rec_off is relative to each fetch's plain buffer, so distinct
        # records from different segments can coincidentally share it and
        # true duplicates never do), else rec_off + the caller's
        # per-segment base (CRAM slice streams, unique by construction)
        rec_id = np.asarray(cols["voff"] if "voff" in cols
                            else cols["rec_off"], dtype=np.int64)
        part = {
            "pos": pos[idx],
            "end": np.asarray(cols["endpos"], dtype=np.int64)[idx],
            "strand": np.asarray(cols["strand"], dtype=np.int64)[idx],
            "hp": np.asarray(cols["hp"], dtype=np.int64)[idx],
            "lseq": np.asarray(cols["l_seq"], dtype=np.int64)[idx],
            "rec_off": rec_id[idx] + off_base,
            "qnames": [cols["qnames"][int(j)] for j in idx],
            "calls": cols["calls"][gath],
            "quals": cols["quals"][gath],
            "call_off": part_off[:-1],
            "call_n": lens,
        }
        fbi = np.flatnonzero(keep & fb)
        if len(fbi):
            add = {k: [] for k in ("pos", "end", "strand", "hp", "lseq",
                                   "rec_off", "qnames")}
            add_calls, add_quals, add_n = [], [], []
            for j in fbi:
                off = int(cols["rec_off"][j])
                if isinstance(buf, bytes):
                    bs = int.from_bytes(buf[off:off + 4], "little")
                    rb = buf[off:off + 4 + bs]
                else:
                    bs = int.from_bytes(buf[off:off + 4].tobytes(),
                                        "little")
                    rb = buf[off:off + 4 + bs].tobytes()
                rec, _ = decode_record(rb, 0)
                cl, ql, has_implicit = read_meth_calls(
                    rec, config.lo, config.hi)
                if has_implicit:
                    from ..utils.log import set_data_has_implicit
                    set_data_has_implicit()
                if not cl:
                    continue
                add["pos"].append(int(cols["pos"][j]))
                add["end"].append(int(cols["endpos"][j]))
                add["strand"].append(int(cols["strand"][j]))
                add["hp"].append(int(cols["hp"][j]))
                add["lseq"].append(int(cols["l_seq"][j]))
                add["rec_off"].append(int(rec_id[j]) + off_base)
                add["qnames"].append(cols["qnames"][j])
                add_calls.append(np.asarray(cl, dtype=np.uint32))
                add_quals.append(np.asarray(ql, dtype=np.uint8))
                add_n.append(len(cl))
            if add_n:
                base = int(part_off[-1])
                fb_off = base + np.concatenate(
                    [[0], np.cumsum(add_n)[:-1]]).astype(np.int64)
                part = {
                    "pos": np.concatenate(
                        [part["pos"], add["pos"]]).astype(np.int64),
                    "end": np.concatenate(
                        [part["end"], add["end"]]).astype(np.int64),
                    "strand": np.concatenate(
                        [part["strand"], add["strand"]]).astype(np.int64),
                    "hp": np.concatenate(
                        [part["hp"], add["hp"]]).astype(np.int64),
                    "lseq": np.concatenate(
                        [part["lseq"], add["lseq"]]).astype(np.int64),
                    "rec_off": np.concatenate(
                        [part["rec_off"], add["rec_off"]]
                    ).astype(np.int64),
                    "qnames": part["qnames"] + add["qnames"],
                    "calls": np.concatenate([part["calls"], *add_calls]),
                    "quals": np.concatenate([part["quals"], *add_quals]),
                    "call_off": np.concatenate([part["call_off"], fb_off]),
                    "call_n": np.concatenate(
                        [part["call_n"], add_n]).astype(np.int64),
                }
        if len(part["pos"]) == 0:
            return None
        return part

    def _empty_init(self):
        self.pos = np.zeros(0, dtype=np.int64)
        self.end = np.zeros(0, dtype=np.int64)
        self.strand = np.zeros(0, dtype=np.int64)
        self.hp = np.zeros(0, dtype=np.int64)
        self.lseq = np.zeros(0, dtype=np.int64)
        self.qnames = []
        self.call_off = np.zeros(1, dtype=np.int64)
        self.call_n = np.zeros(0, dtype=np.int64)
        self.calls_slab = np.zeros(0, dtype=np.uint32)
        self.quals_slab = np.zeros(0, dtype=np.uint8)
        self.max_span = 1
        self._hp_absent = _HP_ABSENT
        self._has_dups = False
        self.ok = True

    def window(self, itvl_s: int, itvl_e: int, readback: int,
               qname2haptag_raw: Optional[Dict[str, int]] = None) -> ReadSet:
        """ReadSet for one gap window — identical to
        load_reads_given_interval(bam, chrom, itvl_s, itvl_e, readback, ...)."""
        lo1 = itvl_s - readback if itvl_s - readback > 0 else 0
        beg = max(0, lo1 - 1)
        end = itvl_e + readback
        lo_i = int(np.searchsorted(self.pos, beg - self.max_span, side="left"))
        hi_i = int(np.searchsorted(self.pos, end, side="left"))
        if self._has_dups:
            # duplicate qnames in the source: per-window builder so the
            # duplicate check raises exactly like the per-window loader
            wb = _WindowBuilder(itvl_s, itvl_e, qname2haptag_raw)
            add_read = wb.add_read
            for j in range(lo_i, hi_i):
                if self.end[j] <= beg:
                    continue
                hp_raw = int(self.hp[j])
                o = int(self.call_off[j])
                cn = int(self.call_n[j])
                add_read(self.qnames[j],
                         None if hp_raw == self._hp_absent else hp_raw,
                         int(self.pos[j]), int(self.strand[j]),
                         int(self.lseq[j]), int(self.end[j]),
                         self.calls_slab[o:o + cn],
                         self.quals_slab[o:o + cn])
            return wb.finish()

        # vectorized _WindowBuilder equivalent (semantics pinned by
        # tests/test_window_native.py): the dup-qname check ran once at
        # source build, everything else is mask arithmetic + one listcomp
        sel = np.flatnonzero(self.end[lo_i:hi_i] > beg) + lo_i
        n = len(sel)
        rs = ReadSet(ref_start=max(itvl_s, 0), ref_end=itvl_e)
        if n == 0:
            return rs
        pos = self.pos[sel]
        endp = self.end[sel]
        hp_raw = self.hp[sel]
        # HP semantics (get_hp_from_aln, blockjoin.c:910-923)
        hp = np.where(hp_raw == self._hp_absent, HAPTAG_UNPHASED, hp_raw - 1)
        zero = np.flatnonzero(hp_raw == 0)
        if len(zero):
            for j in zero:
                log_warn("get_hp_from_aln",
                         f"irregular HP tag? qn={self.qnames[int(sel[j])]} "
                         f"qs={int(pos[j])}")
            hp[zero] = HAPTAG_UNPHASED
        qnames = [self.qnames[int(j)] for j in sel]
        if qname2haptag_raw is not None:
            g = qname2haptag_raw.get
            hp = np.asarray([g(q, HAPTAG_UNPHASED) for q in qnames],
                            dtype=np.int64)
        # boundary classification + left-coverage gate
        # (blockjoin.c:1127-1136, 1161-1163)
        left = pos <= itvl_s
        right = ~left & (endp >= itvl_e)
        if ((hp == 0) & left).sum() < 15 or ((hp == 1) & left).sum() < 15:
            return rs
        rs.ids_left = np.flatnonzero(left).tolist()
        rs.ids_left_strict = np.flatnonzero(left & (endp > itvl_s)).tolist()
        rs.ids_right = np.flatnonzero(right).tolist()
        rs.ids_right_strict = np.flatnonzero(right & (pos < itvl_e)).tolist()
        rs.rev_order = np.lexsort((np.arange(n), endp)).tolist()
        co, cn_ = self.call_off, self.call_n
        cs, qs_ = self.calls_slab, self.quals_slab
        strand = self.strand[sel]
        lseq = self.lseq[sel]
        rs.reads = [
            Read(i=i, qname=qnames[i], hp=int(hp[i]), strand=int(strand[i]),
                 length=int(lseq[i]), start_pos=int(pos[i]),
                 end_pos=int(endp[i]),
                 calls=cs[co[j]:co[j] + cn_[j]],
                 quals=qs_[co[j]:co[j] + cn_[j]])
            for i, j in enumerate(sel)
        ]
        return rs
