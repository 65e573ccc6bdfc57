"""VCF-based read haplotagging ("varhaptag").

Reimplements the reference's L3 layer:
- parse_variants_for_one_read (blockjoin.c:1545-1691): CIGAR insertions +
  MD-tag SNPs/deletions -> per-read variant list;
- haptag_one_read_with_variants (blockjoin.c:1693-1840): merge-sort read
  variants against known phased variants, vote, majority call with the
  VAR_DIFF_OVERRIDE_RATIO ambiguity rule;
- pre_haplotagging_read_in_one_ref (blockjoin.c:1841-1898): whole-chromosome
  pass tagging reads into qname2haptag_raw (first occurrence wins).

Quirks preserved: the insertion-skip while MD walking uses a strict '>'
comparison (an MD mismatch immediately after an insertion reads the inserted
base); a pending deletion at the very end of the MD string is dropped; the
deletion look-back uses `del_pos + del_len >= ref_pos` (one-past inclusive).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..io.bam import BamRecord, bam_endpos
from ..utils.log import log_err, log_info
from .variants import (HAPTAG_UNPHASED, VAR_OP_D, VAR_OP_I, VAR_OP_X, Variant,
                       seq_nt4)

VAR_DIFF_OVERRIDE_RATIO = 5  # blockjoin.c:32

_MD_DIGIT = set("0123456789")
_MD_BASE = set("ATCGatcgUuNn")


def parse_variants_for_one_read(rec: BamRecord) -> List[Variant]:
    out: List[Variant] = []
    self_start = 0
    ref_start = rec.pos

    # --- CIGAR: record insertions ---
    insertions: List[Tuple[int, int]] = []  # (self_pos, length)
    ref_pos = ref_start
    self_pos = 0
    seq = rec.seq()
    for i, c in enumerate(rec.cigar):
        op = c & 0xF
        ln = c >> 4
        if op == 3:  # N
            ref_pos += ln
        elif op == 4:  # S
            if i == 0:
                self_start = ln
            self_pos += ln
        elif op in (0, 7, 8):  # M,=,X
            ref_pos += ln
            self_pos += ln
        elif op == 1:  # I
            out.append(Variant(ref_pos, VAR_OP_I, ln,
                               seq_nt4(seq[self_pos : self_pos + ln]),
                               HAPTAG_UNPHASED))
            insertions.append((self_pos, ln))
            self_pos += ln
        elif op == 2:  # D
            ref_pos += ln

    # --- MD: SNPs + deletions ---
    md = rec.get_tag("MD")
    if md is None:
        raise ValueError(f"read {rec.qname} lacks MD tag (required)")
    prev_ins_idx = 0
    self_pos = self_start
    ref_pos = ref_start

    def md_type(ch: str) -> int:
        if ch in _MD_DIGIT:
            return 0
        if ch == "^":
            return 1
        if ch in _MD_BASE:
            return 2
        log_err("parse_variants_for_one_read", f"invalid MD: {ch}")
        raise ValueError(f"invalid MD char {ch!r}")

    if not md:
        return out
    prev_t = md_type(md[0])
    prev_i = 0
    if prev_t == 2:  # SNP at the very start
        out.append(Variant(ref_pos, VAR_OP_X, 1, seq_nt4(seq[self_pos]), HAPTAG_UNPHASED))
        ref_pos += 1
        self_pos += 1
        prev_t = -1
    i = 1
    while i < len(md):
        t = md_type(md[i])
        if t != prev_t:
            if prev_t == 0:  # match run ended
                l = int(md[prev_i:i])
                ref_pos += l
                self_pos += l
                while (prev_ins_idx < len(insertions)
                       and self_pos > insertions[prev_ins_idx][0]):
                    self_pos += insertions[prev_ins_idx][1]
                    prev_ins_idx += 1
            elif prev_t == 1:  # deletion run
                if t == 0:  # run ended
                    dl = i - prev_i - 1
                    out.append(Variant(ref_pos, VAR_OP_D, dl,
                                       seq_nt4(md[prev_i + 1 : i]), HAPTAG_UNPHASED))
                    ref_pos += dl
                    prev_t = 0
                    prev_i = i
                i += 1
                continue
            if t == 2:  # SNP
                out.append(Variant(ref_pos, VAR_OP_X, 1,
                                   seq_nt4(seq[self_pos]), HAPTAG_UNPHASED))
                ref_pos += 1
                self_pos += 1
                prev_t = -1
                prev_i = i
            else:
                prev_t = t
                prev_i = i
        i += 1
    return out


def haptag_one_read_with_variants(
    known_vars: List[Variant],
    read_vars: List[Variant],
    start_pos: int,
    end_pos: int,
    prev_i_left: List[int],
) -> int:
    """Vote a haplotype for one read. Returns 0/1 or HAPTAG_UNPHASED."""
    if not known_vars:
        return HAPTAG_UNPHASED

    i_left = prev_i_left[0]
    n_known = len(known_vars)
    while i_left < n_known and known_vars[i_left].pos < start_pos:
        i_left += 1
    prev_i_left[0] = 0 if i_left == 0 else i_left - 1

    # piggyback keys: (pos, typebit, idx); typebit 0 = known, 1 = read
    pb: List[Tuple[int, int, int]] = []
    for i in range(i_left, n_known):
        if known_vars[i].pos >= end_pos:
            break
        pb.append((known_vars[i].pos, 0, i))
    for i, rv in enumerate(read_vars):
        pb.append((rv.pos, 1, i))
    pb.sort()

    hp_cnt = [0, 0]
    i = 0
    n = len(pb)
    while i < n:
        pos, typ, idx = pb[i]
        if typ == 1:
            i += 1
            continue
        if i + 1 == n:  # end of interval: read must hold REF here
            hp_cnt[known_vars[idx].haptag] += 1
            break
        npos, ntyp, nidx = pb[i + 1]
        if pos != npos:
            skip_due_del = False
            if i > 0 and pb[i - 1][1] == 1:
                lv = read_vars[pb[i - 1][2]]
                if lv.op == VAR_OP_D and pb[i - 1][0] + lv.length >= pos:
                    skip_due_del = True
            if not skip_due_del:
                hp_cnt[known_vars[idx].haptag] += 1
            i += 1
        else:
            if ntyp == 0:
                # multi-allele entry in the reference collection: skip both
                i += 2
            else:
                r = known_vars[idx]
                s = read_vars[nidx]
                if r.length == s.length and r.chars == s.chars:
                    hp_cnt[r.haptag ^ 1] += 1
                i += 2

    hi, lo = max(hp_cnt), min(hp_cnt)
    ratio = 0.0 if lo == 0 else hi / float(lo)
    if (hp_cnt[0] > 3 and hp_cnt[1] > 3 and ratio < VAR_DIFF_OVERRIDE_RATIO) \
            or hp_cnt[0] == hp_cnt[1]:
        return HAPTAG_UNPHASED
    return 0 if hp_cnt[0] > hp_cnt[1] else 1


def pre_haplotagging_read_in_one_ref(
    bam, chrom: str, known_vars: List[Variant],
    qname2haptag_raw: Dict[str, int],
) -> None:
    """Tag every primary read of `chrom` and store into qname2haptag_raw
    (first occurrence wins), mirroring blockjoin.c:1841-1898."""
    tid = bam.ref_id(chrom)
    if tid < 0:
        return
    tot = [0, 0, 0, 0]  # new hap0, new hap1, new unphased, dup

    def account(qname: str, haptag: int) -> None:
        if qname not in qname2haptag_raw:
            qname2haptag_raw[qname] = haptag
            tot[haptag if haptag in (0, 1) else 2] += 1
        else:
            tot[3] += 1

    done = _pre_haplotag_native(bam, tid, known_vars, account)
    if not done:
        prev_i_left = [0]
        for rec in bam.fetch(chrom, 0, bam.ref_lens[tid]):
            if rec.flag & (4 | 256 | 2048):
                continue
            read_vars = parse_variants_for_one_read(rec)
            haptag = haptag_one_read_with_variants(
                known_vars, read_vars, rec.pos, bam_endpos(rec), prev_i_left)
            account(rec.qname, haptag)
    log_info("pre_haplotagging_read_in_one_ref",
             f"tagged: {tot[0]} new hap0, {tot[1]} new hap1, {tot[2]} new unphased, {tot[3]} dup")


def _pre_haplotag_native(bam, tid: int, known_vars: List[Variant],
                         account) -> bool:
    """Run the whole-chromosome pass through the C++ fast path
    (io/native varhaptag_reads). Returns False when unavailable; reads the
    native parser can't handle (missing/invalid MD) re-run through the
    Python oracle — which raises on missing MD exactly like the serial path
    (the reference exits, blockjoin.c:1560)."""
    import os
    import numpy as np
    if os.environ.get("POMFRET_NO_NATIVE_VARHAPTAG"):
        return False
    try:
        from ..io import native
    except ImportError:
        return False
    if not native.native_available():
        return False
    idx = getattr(bam, "_load_index", lambda: None)()
    if idx is None or not hasattr(bam, "plain_span"):
        return False
    end = bam.ref_lens[tid]
    chunks = idx.chunks_for_region(tid, 0, end)
    bufs = []
    ranges = []
    base = 0
    for cb, ce in chunks:
        span = bam.plain_span(cb, ce)
        if span is None:
            return False
        plain, s, e = span
        bufs.append(plain)
        ranges.append((base + s, base + e))
        base += len(plain)
    if not bufs:
        buf = np.empty(0, dtype=np.uint8)
    elif len(bufs) == 1:
        buf = bufs[0]
    else:
        buf = np.concatenate(bufs)
    n_known = len(known_vars)
    kv_pos = np.asarray([v.pos for v in known_vars], dtype=np.int64)
    kv_op = np.asarray([v.op for v in known_vars], dtype=np.uint8)
    kv_len = np.asarray([v.length for v in known_vars], dtype=np.int32)
    kv_hap = np.asarray([v.haptag & 0xFF for v in known_vars], dtype=np.uint8)
    kv_chars_off = np.zeros(n_known + 1, dtype=np.int64)
    np.cumsum([len(v.chars) for v in known_vars], out=kv_chars_off[1:])
    kv_chars = (np.concatenate([np.asarray(v.chars, dtype=np.uint8)
                                for v in known_vars if len(v.chars)])
                if int(kv_chars_off[-1]) else np.zeros(0, dtype=np.uint8))
    res = native.varhaptag_reads(buf, ranges, tid, 0, end, kv_pos, kv_op,
                                 kv_len, kv_hap, kv_chars_off, kv_chars)
    if res is None:
        return False
    buf_bytes = None
    from ..io.bam import decode_record
    for j in range(res["n"]):
        if res["fallback"][j]:
            if buf_bytes is None:
                buf_bytes = buf if isinstance(buf, bytes) else buf.tobytes()
            rec, _ = decode_record(buf_bytes, int(res["rec_off"][j]))
            read_vars = parse_variants_for_one_read(rec)
            haptag = haptag_one_read_with_variants(
                known_vars, read_vars, rec.pos, bam_endpos(rec), [0])
        else:
            haptag = int(res["hap"][j])
        account(res["qnames"][j], haptag)
    return True
