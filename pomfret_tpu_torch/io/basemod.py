"""Base-modification decoding: MM/ML tag parsing + read→reference lifting.

Reimplements the semantics of the reference's meth decode path:
- 5mC-at-CpG extraction + qual classing: blockjoin.c:794-908
  (fill_read_meth_record_from_bam_line)
- read→ref coordinate lifting with implicit-call insertion:
  blockjoin.c:605-792 (get_mod_poss_on_ref)

The reference relies on htslib's bam_parse_basemod/bam_mods_at_next_pos for
MM/ML decoding; here we parse the tags directly. Quirks of the original are
preserved deliberately (they are behavior-defining for output parity):

- "implicit mode" is inferred from seeing any 5mC call outside CpG context in
  the stored read sequence, NOT from the MM header's '?' flag;
- a mod call at position 0 or len-1 of the read is ignored entirely;
- consecutive duplicate reference positions are deduped against only the
  immediately preceding emitted call;
- CIGAR 'N' and a trailing soft clip terminate the lift early.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .bam import BamRecord

_COMPL = str.maketrans("ACGTUacgtuNn", "TGCAAtgcaann")

UINT32_MAX = 0xFFFFFFFF

# qual classes (mod_t.quals, blockjoin.c:426)
CALL_METH = 0
CALL_UNMETH = 1
CALL_NOCALL = 2


def revcomp(s: str) -> str:
    return s.translate(_COMPL)[::-1]


def parse_mm_items(mm: str):
    """Parse an MM tag value into items.

    Returns list of (base, strand, codes, implicit, deltas) where codes is a
    list of single-char or '(NNN)' chebi codes in written order.
    """
    items = []
    for part in mm.split(";"):
        if not part:
            continue
        fields = part.split(",")
        head = fields[0]
        base = head[0]
        strand = head[1]
        rest = head[2:]
        implicit = True
        if rest.endswith("?"):
            implicit = False
            rest = rest[:-1]
        elif rest.endswith("."):
            rest = rest[:-1]
        codes: List[str] = []
        if rest and rest[0].isdigit():
            codes.append(f"({rest})")  # ChEBI numeric code
        else:
            codes.extend(rest)
        deltas = [int(x) for x in fields[1:] if x != ""]
        items.append((base, strand, codes, implicit, deltas))
    return items


def mods_per_stored_position(rec: BamRecord):
    """Decode MM/ML into {stored_pos: [(canonical_base, code, qual), ...]}.

    Mirrors what htslib's bam_mods_at_next_pos exposes to the reference:
    positions are in stored-sequence coordinates; canonical_base/code are as
    written in MM; qual comes from ML (255 if ML missing).
    """
    mm = rec.get_tag("MM")
    if mm is None:
        mm = rec.get_tag("Mm")
    if not mm:
        return {}
    ml = rec.get_tag("ML")
    if ml is None:
        ml = rec.get_tag("Ml")
    ml_vals = ml[1] if ml else None

    stored = rec.seq()
    L = rec.l_seq
    if rec.is_reverse:
        original = revcomp(stored)
    else:
        original = stored

    out = {}
    ml_i = 0
    ml_arr = np.asarray(ml_vals, dtype=np.int64) if ml_vals is not None else None
    for base, strand, codes, implicit, deltas in parse_mm_items(mm):
        ncodes = max(1, len(codes))
        nd = len(deltas)
        # '-' strand items ('C-m') are processed exactly like '+' ones: the
        # MM delta walk counts occurrences of the fundamental base in the
        # as-sequenced read regardless of the mod's strand, and the reference
        # never inspects mods[j].strand (blockjoin.c:845-858), so positions
        # and CpG filtering are identical.
        # occurrences of `base` in the original read orientation
        if base == "N":
            occ = np.arange(L)
        else:
            occ = np.frombuffer(original.encode(), dtype=np.uint8)
            occ = np.flatnonzero(occ == ord(base))
        # vectorized delta walk: k-th listed mod is occurrence cumsum(d+1)-1
        idx = np.cumsum(np.asarray(deltas, dtype=np.int64) + 1) - 1
        if ml_arr is not None:
            qmat = np.full((nd, ncodes), 255, dtype=np.int64)
            avail = ml_arr[ml_i : ml_i + nd * ncodes]
            qmat.ravel()[: len(avail)] = avail
        else:
            qmat = np.full((nd, ncodes), 255, dtype=np.int64)
        ml_i += nd * ncodes
        valid = idx < len(occ)
        orig_pos = occ[idx[valid]]
        stored_pos = (L - 1 - orig_pos) if rec.is_reverse else orig_pos
        code_list = codes if codes else ["?"]
        for sp, quals in zip(stored_pos.tolist(), qmat[valid].tolist()):
            lst = out.setdefault(sp, [])
            for code, q in zip(code_list, quals):
                lst.append((base, code, q))
    return out


def _extract_cpg_fast(rec: BamRecord, qual_lo: int, qual_hi: int):
    """Vectorized fast path for the dominant tag shape: exactly one MM item,
    'C+m' on the '+' strand. Returns (poss, quals, has_implicit) or None
    when the tag needs the general path."""
    mm = rec.get_tag("MM") or rec.get_tag("Mm")
    if not mm:
        return [], [], False
    items = parse_mm_items(mm)
    if len(items) != 1:
        return None
    base, strand, codes, implicit, deltas = items[0]
    if base != "C" or strand != "+" or codes != ["m"]:
        return None
    if not deltas:
        return [], [], False
    ml = rec.get_tag("ML") or rec.get_tag("Ml")
    ml_vals = np.asarray(ml[1], dtype=np.int64) if ml else None

    stored_b = np.frombuffer(rec.seq().encode(), dtype=np.uint8)
    L = rec.l_seq
    original_b = stored_b if not rec.is_reverse else \
        np.frombuffer(revcomp(rec.seq()).encode(), dtype=np.uint8)
    occ = np.flatnonzero(original_b == ord("C"))
    idx = np.cumsum(np.asarray(deltas, dtype=np.int64) + 1) - 1
    if ml_vals is not None:
        quals = np.full(len(deltas), 255, dtype=np.int64)
        avail = ml_vals[: len(deltas)]
        quals[: len(avail)] = avail
    else:
        quals = np.full(len(deltas), 255, dtype=np.int64)
    valid = idx < len(occ)
    orig_pos = occ[idx[valid]]
    quals = quals[valid]
    stored_pos = (L - 1 - orig_pos) if rec.is_reverse else orig_pos
    if rec.is_reverse:  # iterate in ascending stored order
        stored_pos = stored_pos[::-1]
        quals = quals[::-1]

    interior = (stored_pos > 0) & (stored_pos < L - 1)
    sp = stored_pos[interior]
    q = quals[interior]
    is_c = stored_b[sp] == ord("C")
    nxt = stored_b[np.minimum(sp + 1, L - 1)]
    prv = stored_b[np.maximum(sp - 1, 0)]
    cpg_ok = np.where(is_c, nxt == ord("G"), prv == ord("C"))
    has_implicit = bool((~cpg_ok).any())
    sp = sp[cpg_ok]
    q = q[cpg_ok]
    classes = np.where(q < qual_lo, CALL_UNMETH,
                       np.where(q >= qual_hi, CALL_METH, CALL_NOCALL))
    return sp.tolist(), classes.tolist(), has_implicit


def extract_cpg_5mc_calls(rec: BamRecord, qual_lo: int, qual_hi: int):
    """5mC-at-CpG calls in stored-seq coordinates with qual classes.

    Returns (positions ascending, qual classes, has_implicit) mirroring
    fill_read_meth_record_from_bam_line's buf_mod_poss/buf_mod_quals.
    """
    fast = _extract_cpg_fast(rec, qual_lo, qual_hi)
    if fast is not None:
        return fast
    mods = mods_per_stored_position(rec)
    if not mods:
        return [], [], False
    stored = rec.seq()
    L = rec.l_seq
    poss: List[int] = []
    quals: List[int] = []
    has_implicit = False
    for pos in sorted(mods):
        for base, code, q in mods[pos]:
            if base == "C" and code == "m" and 0 < pos < L - 1:
                if not (stored[pos + 1] == "G" if stored[pos] == "C"
                        else stored[pos - 1] == "C"):
                    has_implicit = True
                    continue
                poss.append(pos)
                quals.append(
                    CALL_UNMETH if q < qual_lo else (CALL_METH if q >= qual_hi else CALL_NOCALL)
                )
    return poss, quals, has_implicit


def lift_mod_positions_to_ref(
    cigar: Tuple[int, ...],
    qs: int,
    strand: int,
    mod_poss: List[int],
    mod_quals: List[int],
    seq: Optional[str],
    aln_len: int,
) -> Tuple[List[int], List[int]]:
    """Map stored-seq mod positions to reference coords, optionally inserting
    implicit-unmethylated calls at every CpG in the read when `seq` is given.

    A faithful reimplementation of get_mod_poss_on_ref (blockjoin.c:605-792);
    see module docstring for the quirks preserved.
    """
    calls: List[int] = []
    quals: List[int] = []
    if not cigar or not mod_poss:
        return calls, quals
    cgoffset = -1 if strand else 0
    mod_l = len(mod_poss)

    i_read = 0
    i_ref = qs
    i_trigger = 0
    next_trigger = mod_poss[0]
    next_qual = mod_quals[0]

    def _is_cpg(i: int) -> bool:
        return i < aln_len - 1 and seq[i] == "C" and seq[i + 1] == "G"

    i_cigar = 0
    if (cigar[0] & 0xF) == 4:  # leading soft clip
        i_read = cigar[0] >> 4
        while next_trigger < i_read:
            i_trigger += 1
            if i_trigger < mod_l:
                next_trigger = mod_poss[i_trigger]
                next_qual = mod_quals[i_trigger]
            else:
                break
        if next_trigger == i_read:
            calls.append(i_ref + cgoffset)
            quals.append(next_qual)
            i_trigger += 1
            if i_trigger < mod_l:
                next_trigger = mod_poss[i_trigger]
                next_qual = mod_quals[i_trigger]
            # else: stale next_trigger kept on purpose (reference behavior)
        i_ref -= cigar[0] >> 4
        i_cigar = 1

    offset = 0
    while i_cigar < len(cigar):
        action = cigar[i_cigar] & 0xF
        length = cigar[i_cigar] >> 4
        if action <= 1:  # M or I
            pos_canonical = i_read
            while next_trigger != UINT32_MAX and i_read + length >= next_trigger:
                if action == 0:
                    if seq is not None:
                        until = min(next_trigger - 1, i_read + length)
                        tmpi = pos_canonical
                        while tmpi < until:
                            if _is_cpg(tmpi):
                                pos_cano = i_ref + tmpi + offset
                                if not (calls and calls[-1] == pos_cano):
                                    calls.append(pos_cano)
                                    quals.append(CALL_UNMETH)
                                tmpi += 1  # skip the G
                            tmpi += 1
                    pos_trigger = i_ref + next_trigger + cgoffset + offset
                    if calls and calls[-1] == pos_trigger:
                        quals[-1] = next_qual
                    else:
                        calls.append(pos_trigger)
                        quals.append(next_qual)
                    pos_canonical = next_trigger + 1 if cgoffset == 0 else next_trigger + 2
                i_trigger += 1
                if i_trigger >= mod_l:
                    next_trigger = UINT32_MAX
                    break
                next_trigger = mod_poss[i_trigger]
                next_qual = mod_quals[i_trigger]
            if action == 0:
                if seq is not None:
                    until = i_read + length
                    tmpi = pos_canonical
                    while tmpi < until:
                        if _is_cpg(tmpi):
                            pos_cano = i_ref + tmpi + offset
                            if not (calls and calls[-1] == pos_cano):
                                calls.append(pos_cano)
                                quals.append(CALL_UNMETH)
                            tmpi += 1
                        tmpi += 1
                i_read += length
            else:
                i_read += length
                offset -= length
        elif action == 2:  # D
            offset += length
        elif action == 3:  # N
            break
        elif action == 4:  # trailing S
            break
        elif action == 5:  # H — the reference errors out; tolerate by stopping
            break
        else:
            raise ValueError(f"unknown cigar op {action}")
        i_cigar += 1

    return calls, quals


def read_meth_calls(rec: BamRecord, qual_lo: int, qual_hi: int):
    """Full decode for one read: (ref positions, qual classes, has_implicit).

    Mirrors fill_read_meth_record_from_bam_line + get_mod_poss_on_ref.
    Returns ([], [], has_implicit) when the read has no usable call.

    The dominant single-'C+m' MM shape goes through the native C++ decoder
    (io/native meth_decode_read, the window-load hot path); everything else
    (multi-item MM, ChEBI codes, '-' strand items) uses the Python oracle
    below, which also pins the native path's semantics in parity tests.
    """
    mm = rec.get_tag("MM") or rec.get_tag("Mm")
    if mm and rec.l_seq >= 2:
        from . import native as _native
        if _native.native_available():
            ml = rec.get_tag("ML") or rec.get_tag("Ml")
            res = _native.meth_decode_read(
                rec.seq_packed, rec.l_seq, 1 if rec.is_reverse else 0, mm,
                ml[1] if ml else None, rec.cigar, rec.pos, qual_lo, qual_hi)
            if res is not None:
                poss_n, quals_n, has_implicit = res
                return poss_n.tolist(), quals_n.tolist(), has_implicit
    poss, quals, has_implicit = extract_cpg_5mc_calls(rec, qual_lo, qual_hi)
    if not poss:
        # reference: stat=0 from get_mod_poss_on_ref when mod_l==0
        return [], [], has_implicit
    seq = rec.seq() if has_implicit else None
    calls, cquals = lift_mod_positions_to_ref(
        rec.cigar, rec.pos, 1 if rec.is_reverse else 0,
        list(poss), list(quals), seq, rec.l_seq,
    )
    return calls, cquals, has_implicit
