"""BAM alignment records: the record type, its end and bin (what the
maker needs to encode and index its records)."""
from __future__ import annotations

import struct
from typing import List, Tuple

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
import numpy as _np_mod
_SEQ_LUT = _np_mod.frombuffer(SEQ_NT16.encode(), dtype=_np_mod.uint8)
CIGAR_OPS = "MIDNSHP=X"
# CIGAR ops that consume reference: M, D, N, =, X
_REF_CONSUME = (1 << 0) | (1 << 2) | (1 << 3) | (1 << 7) | (1 << 8)
# ops that consume query: M, I, S, =, X
_QRY_CONSUME = (1 << 0) | (1 << 1) | (1 << 4) | (1 << 7) | (1 << 8)

FUNMAP = 4
FREVERSE = 16
FSECONDARY = 256
FSUPPLEMENTARY = 2048


class BamRecord:
    __slots__ = (
        "refID", "pos", "mapq", "bin", "flag", "l_seq", "next_refID",
        "next_pos", "tlen", "qname", "cigar", "seq_packed", "qual", "aux",
        "_seq_cache",
    )

    def __init__(self, refID, pos, mapq, bin_, flag, l_seq, next_refID,
                 next_pos, tlen, qname, cigar, seq_packed, qual, aux):
        self.refID = refID
        self.pos = pos
        self.mapq = mapq
        self.bin = bin_
        self.flag = flag
        self.l_seq = l_seq
        self.next_refID = next_refID
        self.next_pos = next_pos
        self.tlen = tlen
        self.qname = qname
        self.cigar = cigar          # tuple of u32 (len<<4 | op)
        self.seq_packed = seq_packed
        self.qual = qual
        self.aux = aux              # raw aux bytes
        self._seq_cache = None

    # ---- sequence access ----
    def seq_base(self, i: int) -> str:
        b = self.seq_packed[i >> 1]
        return SEQ_NT16[(b >> 4) if (i & 1) == 0 else (b & 0xF)]

    def seq(self) -> str:
        if self._seq_cache is None:
            import numpy as _np
            b = _np.frombuffer(self.seq_packed, dtype=_np.uint8)
            out = _np.empty(2 * len(b), dtype=_np.uint8)
            out[0::2] = _SEQ_LUT[b >> 4]
            out[1::2] = _SEQ_LUT[b & 0xF]
            self._seq_cache = out[: self.l_seq].tobytes().decode("ascii")
        return self._seq_cache

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    # ---- cigar ----
    def cigar_tuples(self) -> List[Tuple[int, int]]:
        return [(c & 0xF, c >> 4) for c in self.cigar]

    def endpos(self) -> int:
        return bam_endpos(self)

    def query_len_from_cigar(self) -> int:
        n = 0
        for c in self.cigar:
            if _QRY_CONSUME >> (c & 0xF) & 1:
                n += c >> 4
        return n

    # ---- aux tags ----
    def get_tag(self, tag: str):
        """Return decoded aux value or None (mirrors bam_aux_get semantics)."""
        raw = self.aux
        t = tag.encode()
        i = 0
        n = len(raw)
        while i + 3 <= n:
            cur = raw[i : i + 2]
            typ = raw[i + 2]
            j, val = _decode_aux_value(raw, i + 3, typ)
            if cur == t:
                return val
            i = j
        return None

    def set_int_tag(self, tag: str, value: int) -> None:
        """Remove existing `tag` then append as the smallest unsigned/signed
        int type, mirroring bam_aux_update_int (blockjoin.c:3092)."""
        self.remove_tag(tag)
        t = tag.encode()
        if 0 <= value <= 0xFF:
            self.aux = self.aux + t + b"C" + struct.pack("<B", value)
        elif -128 <= value < 0:
            self.aux = self.aux + t + b"c" + struct.pack("<b", value)
        elif 0 <= value <= 0xFFFF:
            self.aux = self.aux + t + b"S" + struct.pack("<H", value)
        elif -32768 <= value < 0:
            self.aux = self.aux + t + b"s" + struct.pack("<h", value)
        elif value >= 0:
            self.aux = self.aux + t + b"I" + struct.pack("<I", value)
        else:
            self.aux = self.aux + t + b"i" + struct.pack("<i", value)

    def remove_tag(self, tag: str) -> None:
        raw = self.aux
        t = tag.encode()
        i = 0
        n = len(raw)
        while i + 3 <= n:
            cur = raw[i : i + 2]
            typ = raw[i + 2]
            j, _ = _decode_aux_value(raw, i + 3, typ, skip_only=True)
            if cur == t:
                self.aux = raw[:i] + raw[j:]
                return
            i = j


def _decode_aux_value(raw: bytes, i: int, typ: int, skip_only: bool = False):
    c = chr(typ)
    if c == "A":
        return i + 1, (None if skip_only else chr(raw[i]))
    if c == "c":
        return i + 1, (None if skip_only else struct.unpack_from("<b", raw, i)[0])
    if c == "C":
        return i + 1, (None if skip_only else raw[i])
    if c == "s":
        return i + 2, (None if skip_only else struct.unpack_from("<h", raw, i)[0])
    if c == "S":
        return i + 2, (None if skip_only else struct.unpack_from("<H", raw, i)[0])
    if c == "i":
        return i + 4, (None if skip_only else struct.unpack_from("<i", raw, i)[0])
    if c == "I":
        return i + 4, (None if skip_only else struct.unpack_from("<I", raw, i)[0])
    if c == "f":
        return i + 4, (None if skip_only else struct.unpack_from("<f", raw, i)[0])
    if c in ("Z", "H"):
        j = raw.index(b"\x00", i)
        return j + 1, (None if skip_only else raw[i:j].decode())
    if c == "B":
        sub = chr(raw[i])
        cnt = struct.unpack_from("<i", raw, i + 1)[0]
        sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
        j = i + 5 + cnt * sz
        if skip_only:
            return j, None
        fmt = "<" + str(cnt) + sub.replace("C", "B").replace("S", "H")
        vals = struct.unpack_from(fmt, raw, i + 5)
        return j, (sub, list(vals))
    raise ValueError(f"unknown aux type {c!r}")


def bam_endpos(rec: BamRecord) -> int:
    """Reference-consumed end position; pos+1 when no ref-consuming op
    (mirrors htslib bam_endpos)."""
    if rec.flag & FUNMAP or not rec.cigar:
        return rec.pos + 1
    n = 0
    for c in rec.cigar:
        if _REF_CONSUME >> (c & 0xF) & 1:
            n += c >> 4
    return rec.pos + (n if n > 0 else 1)


def decode_record(buf: bytes, off: int) -> Tuple[BamRecord, int]:
    """Decode one BAM record starting at `off`; return (record, next_off)."""
    block_size = struct.unpack_from("<i", buf, off)[0]
    p = off + 4
    end = p + block_size
    (refID, pos, l_read_name, mapq, bin_, n_cigar, flag, l_seq,
     next_refID, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", buf, p)
    p += 32
    qname = buf[p : p + l_read_name - 1].decode()
    p += l_read_name
    cigar = struct.unpack_from("<%dI" % n_cigar, buf, p) if n_cigar else ()
    p += 4 * n_cigar
    nseq = (l_seq + 1) // 2
    seq_packed = buf[p : p + nseq]
    p += nseq
    qual = buf[p : p + l_seq]
    p += l_seq
    aux = buf[p:end]
    return (
        BamRecord(refID, pos, mapq, bin_, flag, l_seq, next_refID, next_pos,
                  tlen, qname, cigar, seq_packed, qual, aux),
        end,
    )


# ---------------------------------------------------------------------------
# BAI index
# ---------------------------------------------------------------------------

def _reg2bins(beg: int, end: int) -> List[int]:
    """Bins overlapping [beg, end), 5-level binning scheme (SAM spec)."""
    bins = [0]
    end -= 1
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0
