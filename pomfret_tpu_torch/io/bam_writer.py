"""BAM writing and BAI index construction.

Replaces the reference's output path (bam_hdr_write/bam_write1 +
sam_index_build3, blockjoin.c:3022-3103, 4714-4731).
"""
from __future__ import annotations

import struct
from typing import List, Optional

from .bam import BamRecord, bam_endpos, reg2bin
from .bgzf import BgzfWriter


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


class BamWriter:
    def __init__(self, path: str, ref_names: List[str], ref_lens: List[int],
                 header_text: str = "", threads: int = 1, level: int = 6,
                 keep_index_info: bool = False):
        self.path = path
        self._w = BgzfWriter(path, level=level, threads=threads)
        hdr = b"BAM\x01"
        ht = header_text.encode()
        hdr += struct.pack("<i", len(ht)) + ht
        hdr += struct.pack("<i", len(ref_names))
        for n, l in zip(ref_names, ref_lens):
            nb = n.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
        self._w.write(hdr)
        # flush so records start on a block boundary -> clean virtual offsets
        self._w.flush_block()
        self._keep_index_info = keep_index_info
        self._recs_meta = []  # (refID, pos, endpos, voff_beg, voff_end, unmapped)

    def write(self, rec: BamRecord) -> None:
        if self._keep_index_info:
            vbeg = self._w.mark()
        self._w.write(encode_record(rec))
        if self._keep_index_info:
            vend = self._w.mark()
            self._recs_meta.append(
                (rec.refID, rec.pos, bam_endpos(rec), vbeg, vend, bool(rec.flag & 4))
            )

    def write_raw_records(self, chunk: bytes, metas) -> None:
        """Append pre-encoded record bytes in bulk with index bookkeeping.

        metas: iterable of (refID, pos, endpos, offset, length, unmapped)
        covering `chunk` exactly (the native retag pass emits these).
        Intra-chunk marks are computed arithmetically: between header flush
        and close, BgzfWriter submits exactly BLOCK-sized blocks, so a byte
        at `within+off` from mark (seq, within) lives at block
        seq + (within+off)//BLOCK, offset (within+off)%BLOCK."""
        if self._keep_index_info:
            seq0, w0 = self._w.mark()
            B = self._w.BLOCK
            for refID, pos, epos, off, ln, unm in metas:
                p = w0 + int(off)
                q = p + int(ln)
                self._recs_meta.append(
                    (int(refID), int(pos), int(epos),
                     (seq0 + p // B, p % B), (seq0 + q // B, q % B),
                     bool(unm)))
        self._w.write(chunk)

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def build_index(self, bai_path: Optional[str] = None, n_ref: int = None) -> None:
        """Resolve deferred marks to virtual offsets (writer must be closed)."""
        assert self._keep_index_info, "writer not opened with keep_index_info"
        meta = [(r, p, e, self._w.resolve_mark(vb), self._w.resolve_mark(ve), u)
                for (r, p, e, vb, ve, u) in self._recs_meta]
        build_bai_from_meta(bai_path or (self.path + ".bai"), meta, n_ref)


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


def build_bai_index(bam_path: str, bai_path: Optional[str] = None) -> None:
    """Index an existing BAM by streaming it once."""
    from .bam import BamReader
    rd = BamReader(bam_path)
    bg = rd._bgzf
    bg.seek_virtual(rd._data_voffset)
    meta = []
    while True:
        vbeg = bg.tell_virtual()
        head = bg.read(4)
        if len(head) < 4:
            break
        size = struct.unpack("<i", head)[0]
        body = bg.read(size)
        if len(body) < size:
            break
        refID, pos = struct.unpack_from("<ii", body, 0)
        flag = struct.unpack_from("<H", body, 14)[0]
        n_cigar = struct.unpack_from("<H", body, 12)[0]
        l_read_name = body[8]
        cigar = struct.unpack_from("<%dI" % n_cigar, body, 32 + l_read_name) if n_cigar else ()
        span = 0
        for c in cigar:
            if (1 << (c & 0xF)) & ((1 << 0) | (1 << 2) | (1 << 3) | (1 << 7) | (1 << 8)):
                span += c >> 4
        epos = pos + (span if span > 0 else 1)
        vend = bg.tell_virtual()
        meta.append((refID, pos, epos, vbeg, vend, bool(flag & 4)))
    build_bai_from_meta(bai_path or (bam_path + ".bai"), meta, len(rd.ref_names))
