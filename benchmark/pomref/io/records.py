"""Helpers to construct BAM records from high-level fields (used by the
synthetic data generator, tests and the BAM rewriter)."""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .bam import BamRecord, reg2bin

_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_OPS = {c: i for i, c in enumerate("MIDNSHP=X")}
_NT16_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in _NT16.items():
    _NT16_LUT[ord(_c)] = _i
    _NT16_LUT[ord(_c.lower())] = _i


def pack_seq(seq: str) -> bytes:
    v = _NT16_LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]
    if len(v) & 1:
        v = np.concatenate([v, np.zeros(1, dtype=np.uint8)])
    return ((v[0::2] << 4) | v[1::2]).tobytes()


def encode_cigar(cig: Sequence[Tuple[str, int]]) -> Tuple[int, ...]:
    return tuple((ln << 4) | _OPS[op] for op, ln in cig)


def make_aux(tags: Sequence[Tuple[str, str, object]]) -> bytes:
    """tags: (name, type, value); type in {A,i,f,Z,B:C,B:c,...}."""
    out = bytearray()
    for name, typ, val in tags:
        out += name.encode()
        if typ == "A":
            out += b"A" + val.encode()
        elif typ == "i":
            out += b"i" + struct.pack("<i", val)
        elif typ == "I":
            out += b"I" + struct.pack("<I", val)
        elif typ == "c":
            out += b"c" + struct.pack("<b", val)
        elif typ == "C":
            out += b"C" + struct.pack("<B", val)
        elif typ == "s":
            out += b"s" + struct.pack("<h", val)
        elif typ == "S":
            out += b"S" + struct.pack("<H", val)
        elif typ == "f":
            out += b"f" + struct.pack("<f", val)
        elif typ == "Z":
            out += b"Z" + val.encode() + b"\x00"
        elif typ.startswith("B:"):
            sub = typ[2:]
            out += b"B" + sub.encode() + struct.pack("<i", len(val))
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            out += struct.pack("<%d%s" % (len(val), fmt), *val)
        else:
            raise ValueError(f"unsupported tag type {typ}")
    return bytes(out)


def make_record(
    qname: str,
    refID: int,
    pos: int,
    seq: str,
    cigar: Sequence[Tuple[str, int]],
    flag: int = 0,
    mapq: int = 60,
    qual: Optional[bytes] = None,
    tags: Sequence[Tuple[str, str, object]] = (),
) -> BamRecord:
    cig = encode_cigar(cigar)
    span = sum(ln for op, ln in cigar if op in "MDN=X")
    end = pos + (span if span > 0 else 1)
    return BamRecord(
        refID=refID,
        pos=pos,
        mapq=mapq,
        bin_=reg2bin(pos, end),
        flag=flag,
        l_seq=len(seq),
        next_refID=-1,
        next_pos=-1,
        tlen=0,
        qname=qname,
        cigar=cig,
        seq_packed=pack_seq(seq),
        qual=qual if qual is not None else bytes([30]) * len(seq),
        aux=make_aux(tags),
    )
