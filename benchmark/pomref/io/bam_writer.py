"""BAM writing and BAI index construction.

Replaces the reference's output path (bam_hdr_write/bam_write1 +
sam_index_build3, blockjoin.c:3022-3103, 4714-4731).
"""
from __future__ import annotations

import struct

from .bam import BamRecord, bam_endpos, reg2bin


def encode_record(rec: BamRecord) -> bytes:
    qname_b = rec.qname.encode() + b"\x00"
    body = struct.pack(
        "<iiBBHHHiiii",
        rec.refID, rec.pos, len(qname_b), rec.mapq, rec.bin,
        len(rec.cigar), rec.flag, rec.l_seq, rec.next_refID, rec.next_pos,
        rec.tlen,
    )
    body += qname_b
    if rec.cigar:
        body += struct.pack("<%dI" % len(rec.cigar), *rec.cigar)
    body += rec.seq_packed
    body += rec.qual
    body += rec.aux
    return struct.pack("<i", len(body)) + body


def build_bai_from_meta(bai_path: str, meta, n_ref: int) -> None:
    """meta: iterable of (refID, pos, endpos, vbeg, vend, is_unmapped)."""
    per_ref_bins = [dict() for _ in range(n_ref)]
    per_ref_intv = [dict() for _ in range(n_ref)]
    n_mapped = [0] * n_ref
    n_unmapped = [0] * n_ref
    vspan = [[None, None] for _ in range(n_ref)]
    n_no_coor = 0
    for refID, pos, epos, vbeg, vend, unmapped in meta:
        if refID < 0:
            n_no_coor += 1
            continue
        if unmapped:
            n_unmapped[refID] += 1
        else:
            n_mapped[refID] += 1
        b = reg2bin(pos, max(epos, pos + 1))
        chunks = per_ref_bins[refID].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        for w in range(pos >> 14, (max(epos, pos + 1) - 1 >> 14) + 1):
            cur = per_ref_intv[refID].get(w)
            if cur is None or vbeg < cur:
                per_ref_intv[refID][w] = vbeg
        if vspan[refID][0] is None or vbeg < vspan[refID][0]:
            vspan[refID][0] = vbeg
        if vspan[refID][1] is None or vend > vspan[refID][1]:
            vspan[refID][1] = vend

    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", n_ref)
    for r in range(n_ref):
        bins = per_ref_bins[r]
        n_bin = len(bins) + (1 if n_mapped[r] + n_unmapped[r] > 0 else 0)
        out += struct.pack("<i", n_bin)
        for b in sorted(bins):
            chunks = bins[b]
            out += struct.pack("<Ii", b, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        if n_mapped[r] + n_unmapped[r] > 0:
            # metadata pseudo-bin 37450
            out += struct.pack("<Ii", 37450, 2)
            out += struct.pack("<QQ", vspan[r][0] or 0, vspan[r][1] or 0)
            out += struct.pack("<QQ", n_mapped[r], n_unmapped[r])
        iv = per_ref_intv[r]
        if iv:
            n_intv = max(iv) + 1
            # fill gaps with previous value (htslib convention)
            arr = []
            prev = 0
            for w in range(n_intv):
                v = iv.get(w)
                if v is not None:
                    prev = v
                arr.append(prev)
        else:
            n_intv = 0
            arr = []
        out += struct.pack("<i", n_intv)
        for v in arr:
            out += struct.pack("<Q", v)
    with open(bai_path, "wb") as f:
        f.write(bytes(out))
