"""CRAM 3.0 writer.

The reference never writes CRAM (output_modify_bam writes BAM,
blockjoin.c:3022-3103); this writer exists (a) to round-trip-validate the
CRAM reader without htslib in the environment, and (b) as a TPU-era extra
(`bam_to_cram`) so pipelines can archive inputs compactly.

Encoding choices (all decoded by io/cram.py and any spec-conforming reader):
one slice per container; EXTERNAL encodings with one block per data series;
read names via BYTE_ARRAY_STOP('\\0'); tag values + IN/SC via BYTE_ARRAY_LEN
(EXTERNAL lengths + EXTERNAL bytes); quality/base-heavy blocks rans4x8,
medium blocks gzip, tiny blocks raw. Reference handling: ref-based slices
with substitutions/deletions/insertions/softclips as read features, with
either an embedded reference block or an external FASTA; or non-reference
mode (RR=false) storing bases verbatim as 'b' features.
"""
from __future__ import annotations

import struct
import zlib
from hashlib import md5
from typing import Dict, Iterable, List, Optional, Tuple

from .bam import BamRecord, bam_endpos
from .cram import (CF_DETACHED, CF_QS_STORED, MF_MATE_REVERSED,
                   MF_MATE_UNMAPPED, CT_COMPRESSION_HEADER, CT_CORE,
                   CT_EXTERNAL, CT_FILE_HEADER, CT_MAPPED_SLICE,
                   ContainerHeader, E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP,
                   E_EXTERNAL, EOF_START_SENTINEL, M_GZIP, M_RANS4x8, M_RAW,
                   _SUB_BASES, sub_code, write_array_itf8, write_block,
                   write_container_header, write_encoding, write_itf8,
                   write_ltf8)

_OPS_STR = "MIDNSHP=X"

# fixed content-id assignment for the one-block-per-series layout
_SERIES_IDS = {
    "BF": 1, "CF": 2, "RI": 3, "RL": 4, "AP": 5, "RG": 6, "MF": 7, "NS": 8,
    "NP": 9, "TS": 10, "NF": 11, "TL": 12, "FN": 13, "FC": 14, "FP": 15,
    "DL": 16, "BS": 17, "MQ": 18, "BA": 19, "QS": 20, "RS": 21, "PD": 22,
    "HC": 23,
}
_ID_RN = 30
_ID_IN_LEN, _ID_IN = 31, 32
_ID_SC_LEN, _ID_SC = 33, 34
_ID_BB_LEN, _ID_BB = 35, 36
_ID_TAG_LEN, _ID_TAG = 37, 38
_ID_EMBREF = 40

_INT_SERIES = {"BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
               "NF", "TL", "FN", "FP", "DL", "MQ", "RS", "PD", "HC"}
_BYTE_SERIES = {"FC", "BS", "BA", "QS"}


class _Streams:
    def __init__(self):
        self.d: Dict[int, bytearray] = {}

    def put_itf8(self, cid: int, v: int):
        self.d.setdefault(cid, bytearray()).extend(write_itf8(v))

    def put_byte(self, cid: int, v: int):
        self.d.setdefault(cid, bytearray()).append(v)

    def put_bytes(self, cid: int, v: bytes):
        self.d.setdefault(cid, bytearray()).extend(v)


def _features_for_record(rec: BamRecord, ref: Optional[str], ref_off: int,
                         sub_matrix: bytes, no_ref: bool,
                         feature_style: str = "X"
                         ) -> List[Tuple[str, int, object]]:
    """Derive CRAM read features from a BAM record (inverse of
    cram.build_alignment). feature_style 'X' emits substitution codes (the
    htslib default); 'B' emits verbatim base+qual features and single-base
    insertions as 'i' (both legal per spec; exercises those decode paths)."""
    seq = rec.seq()
    feats: List[Tuple[str, int, object]] = []
    rpos = 0
    gpos = rec.pos

    def refb(g: int) -> str:
        if ref is None:
            return "N"
        i = g - ref_off
        return ref[i] if 0 <= i < len(ref) else "N"

    for op_enc in rec.cigar:
        op = _OPS_STR[op_enc & 0xF]
        ln = op_enc >> 4
        if op in ("M", "=", "X"):
            if no_ref:
                feats.append(("b", rpos + 1, seq[rpos : rpos + ln].encode()))
            else:
                for k in range(ln):
                    sb = seq[rpos + k]
                    rb = refb(gpos + k)
                    if sb == rb:
                        continue
                    # a substitution code exists only for ACGTN alts of the
                    # (effective) reference base; anything else — IUPAC
                    # bases, N-vs-N — is stored verbatim as a 'B' feature
                    eff = rb if rb in _SUB_BASES else "N"
                    if feature_style != "B" and sb in _SUB_BASES[eff]:
                        feats.append(("X", rpos + k + 1,
                                      sub_code(sub_matrix, rb, sb)))
                    else:
                        q = rec.qual[rpos + k] if rpos + k < len(rec.qual) else 0xFF
                        feats.append(("B", rpos + k + 1, (ord(sb), q)))
            rpos += ln
            gpos += ln
        elif op == "I":
            if feature_style == "B" and ln == 1:
                feats.append(("i", rpos + 1, ord(seq[rpos])))
            else:
                feats.append(("I", rpos + 1, seq[rpos : rpos + ln].encode()))
            rpos += ln
        elif op == "S":
            feats.append(("S", rpos + 1, seq[rpos : rpos + ln].encode()))
            rpos += ln
        elif op == "D":
            feats.append(("D", rpos + 1, ln))
            gpos += ln
        elif op == "N":
            feats.append(("N", rpos + 1, ln))
            gpos += ln
        elif op == "P":
            feats.append(("P", rpos + 1, ln))
        elif op == "H":
            feats.append(("H", rpos + 1, ln))
    return feats


def _split_aux(rec: BamRecord) -> List[Tuple[str, int, bytes]]:
    """Split raw BAM aux data into (tag, type, value bytes) triplets."""
    out = []
    raw = rec.aux
    i = 0
    while i + 3 <= len(raw):
        tag = raw[i : i + 2].decode()
        typ = raw[i + 2]
        i += 3
        t = chr(typ)
        if t == "A":
            val = raw[i : i + 1]; i += 1
        elif t in "cC":
            val = raw[i : i + 1]; i += 1
        elif t in "sS":
            val = raw[i : i + 2]; i += 2
        elif t in "iIf":
            val = raw[i : i + 4]; i += 4
        elif t in "ZH":
            j = raw.index(b"\x00", i)
            val = raw[i : j + 1]
            i = j + 1
        elif t == "B":
            sub = chr(raw[i])
            n = struct.unpack_from("<i", raw, i + 1)[0]
            w = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            val = raw[i : i + 5 + n * w]
            i += 5 + n * w
        else:
            raise ValueError(f"unknown aux type {t}")
        out.append((tag, typ, val))
    return out


def _compression_header_blob(tag_dict: List[List[Tuple[str, int]]],
                             tag_keys: List[int], no_ref: bool,
                             sub_matrix: bytes) -> bytes:
    # preservation map
    pres = bytearray()
    n_entries = 0
    for key, val in (("RN", 1), ("AP", 1), ("RR", 0 if no_ref else 1)):
        pres += key.encode() + bytes([val])
        n_entries += 1
    pres += b"SM" + sub_matrix
    n_entries += 1
    td_blob = bytearray()
    for line in tag_dict:
        for tag, typ in line:
            td_blob += tag.encode() + bytes([typ])
        td_blob.append(0)
    pres += b"TD" + write_itf8(len(td_blob)) + td_blob
    n_entries += 1
    pres_map = write_itf8(len(pres) + len(write_itf8(n_entries))) \
        + write_itf8(n_entries) + pres
    # hmm: spec's "size in bytes" covers the map content after the size
    # field; include the entry-count varint in it (read side skips by count,
    # not size, so both conventions parse identically here)

    # data series encoding map
    dse = bytearray()
    n = 0
    for key in sorted(_SERIES_IDS):
        dse += key.encode() + write_encoding(E_EXTERNAL,
                                             write_itf8(_SERIES_IDS[key]))
        n += 1
    dse += b"RN" + write_encoding(E_BYTE_ARRAY_STOP,
                                  bytes([0]) + write_itf8(_ID_RN))
    n += 1
    for key, (lid, vid) in (("IN", (_ID_IN_LEN, _ID_IN)),
                            ("SC", (_ID_SC_LEN, _ID_SC)),
                            ("BB", (_ID_BB_LEN, _ID_BB))):
        params = write_encoding(E_EXTERNAL, write_itf8(lid)) \
            + write_encoding(E_EXTERNAL, write_itf8(vid))
        dse += key.encode() + write_encoding(E_BYTE_ARRAY_LEN, params)
        n += 1
    dse_map = write_itf8(len(dse) + len(write_itf8(n))) + write_itf8(n) + dse

    # tag encoding map: every tag value via shared BYTE_ARRAY_LEN streams
    te = bytearray()
    for key in tag_keys:
        params = write_encoding(E_EXTERNAL, write_itf8(_ID_TAG_LEN)) \
            + write_encoding(E_EXTERNAL, write_itf8(_ID_TAG))
        te += write_itf8(key) + write_encoding(E_BYTE_ARRAY_LEN, params)
    te_map = write_itf8(len(te) + len(write_itf8(len(tag_keys)))) \
        + write_itf8(len(tag_keys)) + te

    return bytes(pres_map + dse_map + te_map)


def _method_for(cid: int, data: bytes) -> int:
    if len(data) < 64:
        return M_RAW
    if cid in (_SERIES_IDS["QS"], _SERIES_IDS["BA"], _ID_IN, _ID_SC, _ID_BB,
               _ID_EMBREF):
        return M_RANS4x8
    return M_GZIP


def make_eof_container() -> bytes:
    blk = write_block(M_RAW, CT_COMPRESSION_HEADER, 0,
                      write_itf8(1) + write_itf8(0)
                      + write_itf8(1) + write_itf8(0)
                      + write_itf8(1) + write_itf8(0))
    h = ContainerHeader(length=len(blk), ref_id=-1,
                        start=EOF_START_SENTINEL, span=0, n_records=0,
                        record_counter=0, n_bases=0, n_blocks=1,
                        landmarks=[])
    return write_container_header(h) + blk


class CramWriter:
    def __init__(self, path: str, ref_names: List[str], ref_lens: List[int],
                 header_text: Optional[str] = None,
                 ref_fasta: Optional[str] = None,
                 embed_ref: bool = True,
                 no_ref: bool = False,
                 records_per_slice: int = 1000,
                 feature_style: str = "X"):
        self.path = path
        self._f = open(path, "wb")
        self.ref_names = ref_names
        self.ref_lens = ref_lens
        self.no_ref = no_ref
        self.embed_ref = embed_ref and not no_ref
        self.records_per_slice = records_per_slice
        self.feature_style = feature_style
        self.sub_matrix = b"\x1b" * 5  # identity code assignment per row
        self._fasta = None
        if ref_fasta:
            from .fasta import FastaReader
            self._fasta = FastaReader(ref_fasta)
        if not no_ref and self._fasta is None and not embed_ref:
            raise ValueError("ref-based CRAM needs ref_fasta or embed_ref")
        if header_text is None:
            header_text = "@HD\tVN:1.6\tSO:coordinate\n"
        # CRAM carries the reference dictionary only in the SAM text header
        # (BAM keeps a binary copy); synthesize missing @SQ lines
        have_sq = {line.split("\t")[1][3:]
                   for line in header_text.splitlines()
                   if line.startswith("@SQ") and "\t" in line}
        missing = "".join(f"@SQ\tSN:{n}\tLN:{l}\n"
                          for n, l in zip(ref_names, ref_lens)
                          if n not in have_sq)
        if missing:
            lines = header_text.splitlines(keepends=True)
            at = 1 if lines and lines[0].startswith("@HD") else 0
            header_text = "".join(lines[:at]) + missing + "".join(lines[at:])
        self.header_text = header_text

        # @RG IDs in header order: the RG data series stores the index
        from .cram import parse_rg_ids
        self.rg_ids = parse_rg_ids(self.header_text)
        self._rg_index = {rg: i for i, rg in enumerate(self.rg_ids)}

        self._f.write(b"CRAM" + bytes([3, 0]) + b"\x00" * 20)
        hdr_blob = struct.pack("<i", len(header_text)) + header_text.encode()
        blk = write_block(M_RAW, CT_FILE_HEADER, 0, hdr_blob)
        ch = ContainerHeader(length=len(blk), ref_id=0, start=0, span=0,
                             n_records=0, record_counter=0, n_bases=0,
                             n_blocks=1, landmarks=[0])
        self._f.write(write_container_header(ch) + blk)

        self._pending: List[BamRecord] = []
        self._counter = 0
        self._crai: List[Tuple[int, int, int, int, int, int]] = []

    # ------------------------------------------------------------ write
    def write(self, rec: BamRecord) -> None:
        if self._pending and (rec.refID != self._pending[0].refID
                              or len(self._pending) >= self.records_per_slice):
            self._flush_slice()
        self._pending.append(rec)

    def write_many(self, recs: Iterable[BamRecord]) -> None:
        for r in recs:
            self.write(r)

    def _ref_for(self, ref_id: int, start0: int, end0: int) -> Optional[str]:
        if self.no_ref or ref_id < 0:
            return None
        if self._fasta is not None:
            return self._fasta.fetch(self.ref_names[ref_id], start0, end0)
        return None

    def _flush_slice(self) -> None:
        recs = self._pending
        self._pending = []
        if not recs:
            return
        ref_id = recs[0].refID
        start0 = min(r.pos for r in recs)
        end0 = max(bam_endpos(r) for r in recs)
        span = max(1, end0 - start0)

        # reference window
        ref = None
        ref_off = start0
        if not self.no_ref and ref_id >= 0:
            ref = self._ref_for(ref_id, start0, end0)
            if ref is None and self.embed_ref:
                # derive an embedded reference from the reads themselves:
                # majority base per column (a valid embedded reference per
                # spec; substitutions stay exact because features are
                # computed against this same sequence)
                ref = _consensus_reference(recs, start0, end0)
        embed = self.embed_ref and ref is not None

        # tag dictionary
        tag_lines: List[List[Tuple[str, int]]] = []
        line_idx: Dict[tuple, int] = {}
        rec_tags: List[List[Tuple[str, int, bytes]]] = []
        rec_tl: List[int] = []
        rec_rg: List[int] = []
        for r in recs:
            triplets = _split_aux(r)
            # RG:Z rides the RG data series (as an @RG index), not the tag
            # dictionary — matching htslib's encoding
            rg = -1
            if self._rg_index:
                for t, ty, val in triplets:
                    if t == "RG" and ty == ord("Z"):
                        rg = self._rg_index.get(val[:-1].decode(errors="replace"), -1)
                        break
                if rg >= 0:
                    triplets = [x for x in triplets if x[0] != "RG"]
            rec_rg.append(rg)
            key = tuple((t, ty) for t, ty, _ in triplets)
            if key not in line_idx:
                line_idx[key] = len(tag_lines)
                tag_lines.append([(t, ty) for t, ty in key])
            rec_tags.append(triplets)
            rec_tl.append(line_idx[key])
        tag_keys = sorted({(ord(t[0]) << 16) | (ord(t[1]) << 8) | ty
                           for line in tag_lines for t, ty in line})

        st = _Streams()
        prev_ap = start0 + 1
        n_bases = 0
        for r, triplets, tl, rg in zip(recs, rec_tags, rec_tl, rec_rg):
            n_bases += r.l_seq
            flag = r.flag
            bf = flag & ~(0x20 | 0x8)
            cf = CF_QS_STORED
            detached = bool(flag & 0x1) or r.next_refID >= 0 or (flag & (0x20 | 0x8))
            if detached:
                cf |= CF_DETACHED
            st.put_itf8(_SERIES_IDS["BF"], bf)
            st.put_itf8(_SERIES_IDS["CF"], cf)
            st.put_itf8(_SERIES_IDS["RL"], r.l_seq)
            ap = r.pos + 1
            st.put_itf8(_SERIES_IDS["AP"], ap - prev_ap)
            prev_ap = ap
            st.put_itf8(_SERIES_IDS["RG"], rg)
            st.put_bytes(_ID_RN, r.qname.encode() + b"\x00")
            if detached:
                mf = 0
                if flag & 0x20:
                    mf |= MF_MATE_REVERSED
                if flag & 0x8:
                    mf |= MF_MATE_UNMAPPED
                st.put_itf8(_SERIES_IDS["MF"], mf)
                st.put_itf8(_SERIES_IDS["NS"], r.next_refID)
                st.put_itf8(_SERIES_IDS["NP"], r.next_pos + 1)
                st.put_itf8(_SERIES_IDS["TS"], r.tlen)
            st.put_itf8(_SERIES_IDS["TL"], tl)
            for _, _, val in triplets:
                st.put_itf8(_ID_TAG_LEN, len(val))
                st.put_bytes(_ID_TAG, val)
            if not (flag & 4):
                feats = _features_for_record(r, ref, ref_off,
                                             self.sub_matrix, self.no_ref,
                                             self.feature_style)
                st.put_itf8(_SERIES_IDS["FN"], len(feats))
                last = 0
                for fc, fp, op in feats:
                    st.put_byte(_SERIES_IDS["FC"], ord(fc))
                    st.put_itf8(_SERIES_IDS["FP"], fp - last)
                    last = fp
                    if fc == "X":
                        st.put_byte(_SERIES_IDS["BS"], op)
                    elif fc == "B":
                        st.put_byte(_SERIES_IDS["BA"], op[0])
                        st.put_byte(_SERIES_IDS["QS"], op[1])
                    elif fc == "i":
                        st.put_byte(_SERIES_IDS["BA"], op)
                    elif fc == "I":
                        st.put_itf8(_ID_IN_LEN, len(op))
                        st.put_bytes(_ID_IN, op)
                    elif fc == "S":
                        st.put_itf8(_ID_SC_LEN, len(op))
                        st.put_bytes(_ID_SC, op)
                    elif fc == "b":
                        st.put_itf8(_ID_BB_LEN, len(op))
                        st.put_bytes(_ID_BB, op)
                    elif fc == "D":
                        st.put_itf8(_SERIES_IDS["DL"], op)
                    elif fc == "N":
                        st.put_itf8(_SERIES_IDS["RS"], op)
                    elif fc == "P":
                        st.put_itf8(_SERIES_IDS["PD"], op)
                    elif fc == "H":
                        st.put_itf8(_SERIES_IDS["HC"], op)
                st.put_itf8(_SERIES_IDS["MQ"], r.mapq)
                st.put_bytes(_SERIES_IDS["QS"], r.qual[: r.l_seq])
            else:
                st.put_bytes(_SERIES_IDS["BA"], r.seq().encode())
                st.put_bytes(_SERIES_IDS["QS"], r.qual[: r.l_seq])

        # assemble blocks
        comp_blob = _compression_header_blob(tag_lines, tag_keys,
                                             self.no_ref, self.sub_matrix)
        comp_block = write_block(M_GZIP if len(comp_blob) > 100 else M_RAW,
                                 CT_COMPRESSION_HEADER, 0, comp_blob)

        ext_ids = sorted(st.d)
        content_ids = list(ext_ids)
        emb_id = -1
        if embed:
            emb_id = _ID_EMBREF
            content_ids.append(emb_id)
        data_blocks = bytearray()
        # core block (empty: all encodings are external)
        data_blocks += write_block(M_RAW, CT_CORE, 0, b"")
        for cid in ext_ids:
            data = bytes(st.d[cid])
            data_blocks += write_block(_method_for(cid, data),
                                       CT_EXTERNAL, cid, data)
        if embed:
            data_blocks += write_block(_method_for(emb_id, ref.encode()),
                                       CT_EXTERNAL, emb_id, ref.encode())

        ref_md5 = md5(ref.encode()).digest() if (ref is not None and not self.no_ref) \
            else b"\x00" * 16
        shdr = bytearray()
        shdr += write_itf8(ref_id)
        shdr += write_itf8(start0 + 1)
        shdr += write_itf8(span)
        shdr += write_itf8(len(recs))
        shdr += write_ltf8(self._counter)
        shdr += write_itf8(1 + len(content_ids))  # core + externals
        shdr += write_array_itf8(content_ids)
        shdr += write_itf8(emb_id)
        shdr += bytes(ref_md5)
        slice_block = write_block(M_RAW, CT_MAPPED_SLICE, 0, bytes(shdr))

        body = comp_block + slice_block + bytes(data_blocks)
        landmark = len(comp_block)
        h = ContainerHeader(length=len(body), ref_id=ref_id,
                            start=start0 + 1, span=span,
                            n_records=len(recs),
                            record_counter=self._counter,
                            n_bases=n_bases,
                            n_blocks=1 + 1 + 1 + len(content_ids),
                            landmarks=[landmark])
        coff = self._f.tell()
        self._f.write(write_container_header(h) + body)
        self._crai.append((ref_id, start0 + 1, span, coff, landmark,
                           len(body) - landmark))
        self._counter += len(recs)

    def close(self) -> None:
        self._flush_slice()
        self._f.write(make_eof_container())
        self._f.close()
        import gzip as _gz
        with _gz.open(self.path + ".crai", "wt") as f:
            for e in self._crai:
                f.write("\t".join(str(x) for x in e) + "\n")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _consensus_reference(recs: List[BamRecord], start0: int, end0: int) -> str:
    """Majority base per reference column across the slice's alignments."""
    import numpy as np
    L = end0 - start0
    counts = np.zeros((L, 5), dtype=np.int32)
    idx = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
    for r in recs:
        if r.flag & 4:
            continue
        seq = r.seq()
        rpos = 0
        gpos = r.pos
        for op_enc in r.cigar:
            op = _OPS_STR[op_enc & 0xF]
            ln = op_enc >> 4
            if op in ("M", "=", "X"):
                for k in range(ln):
                    g = gpos + k - start0
                    if 0 <= g < L:
                        counts[g, idx.get(seq[rpos + k], 4)] += 1
                rpos += ln
                gpos += ln
            elif op in ("I", "S"):
                rpos += ln
            elif op in ("D", "N"):
                gpos += ln
    best = counts.argmax(axis=1)
    bases = np.array(list("ACGTN"))
    out = bases[best]
    out[counts.sum(axis=1) == 0] = "N"
    return "".join(out.tolist())


def bam_to_cram(bam_path: str, cram_path: str,
                ref_fasta: Optional[str] = None,
                embed_ref: bool = True, no_ref: bool = False,
                records_per_slice: int = 1000,
                feature_style: str = "X") -> None:
    """Convert a BAM into CRAM 3.0 (+ .crai)."""
    from .bam import BamReader
    rd = BamReader(bam_path)
    with CramWriter(cram_path, rd.ref_names, rd.ref_lens,
                    header_text=rd.header_text or None,
                    ref_fasta=ref_fasta, embed_ref=embed_ref,
                    no_ref=no_ref,
                    records_per_slice=records_per_slice,
                    feature_style=feature_style) as w:
        w.write_many(rd.fetch_all())
