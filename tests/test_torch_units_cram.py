"""The port's CRAM 3.0 reader and writer held to the JAX package's unit
checks of them (tests/test_cram.py), on the same inputs, with the same
expected values: ITF8/LTF8, rANS 4x8 and FASTA primitives; record round
trips through each CRAM mode (the reference embedded, an external FASTA,
no reference, 'B' features, MD regenerated from the reference), region
queries through the .crai, unmapped and fuzzed records, read groups and
mates; methphase on a CRAM read slice by slice, with no spool; columnar
window loads against the BAM's and with the QS series skipped; the CRAM
3.1 codecs refused.

The scenario and each CRAM mode are made once for the module, the CRAMs
at once, each in a process of its own. One CRAM (the reference embedded,
100 records a slice) serves every case of that mode: test_cram.py makes
it again for each, at 1,000, 100, 150 or 200 records a slice. The
native-against-Python cases of test_cram.py (the spool, the spool's hot
paths, rANS) are entries of testing.NATIVE_CHECKS
(tests/test_torch_units_native.py). Tolerance: exact.
"""
import os

import numpy as np
import pytest
import torch

from pomfret_tpu_torch.cli import main as cli_main
from pomfret_tpu_torch.io import rans4x8
from pomfret_tpu_torch.io.bam import BamReader, bam_endpos
from pomfret_tpu_torch.io.bam_writer import BamWriter
from pomfret_tpu_torch.io.cram import (CramReader, is_cram, open_alignment,
                                       read_itf8, read_ltf8, write_itf8,
                                       write_ltf8)
from pomfret_tpu_torch.io.cram_writer import bam_to_cram
from pomfret_tpu_torch.io.fasta import FastaReader, write_fasta
from pomfret_tpu_torch.io.records import make_record
from pomfret_tpu_torch.testing import (Spawned, fuzz_bam,
                                       make_two_block_scenario,
                                       port_modules)

torch.set_num_threads(1)


# ------------------------------------------------------------- primitives

@pytest.mark.parametrize("v", [0, 1, 0x7F, 0x80, 0x3FFF, 0x4000, 0x1FFFFF,
                               0x200000, 0xFFFFFFF, 0x10000000, 0x7FFFFFFF,
                               -1, -2])
def test_itf8_roundtrip(v):
    enc = write_itf8(v)
    got, p = read_itf8(enc, 0)
    assert got == v
    assert p == len(enc)


@pytest.mark.parametrize("v", [0, 0x7F, 0x80, 0x3FFF, 1 << 20, 1 << 30,
                               (1 << 35) + 12345, (1 << 48) - 1, 1 << 55,
                               (1 << 62) + 7])
def test_ltf8_roundtrip(v):
    enc = write_ltf8(v)
    got, p = read_ltf8(enc, 0)
    assert got == v
    assert p == len(enc)


def test_rans4x8_roundtrip_orders():
    import random
    rng = random.Random(11)
    cases = [b"", b"x", b"pomfret" * 100,
             bytes(rng.choices(b"ACGTN", weights=[9, 8, 7, 6, 1], k=33333)),
             bytes(rng.choices(range(256), k=5000)),
             bytes([0]) * 4096, bytes(range(256)) * 3]
    for data in cases:
        for order in (0, 1):
            assert rans4x8.uncompress(rans4x8.compress(data, order)) == data


def test_rans4x8_stream_header_layout():
    import struct
    s = rans4x8.compress(b"AAAABBBBCCCC", order=0)
    order, comp, raw = struct.unpack_from("<BII", s, 0)
    assert order == 0 and raw == 12 and comp == len(s) - 9


def test_fasta_reader_fetch(tmp_path):
    p = str(tmp_path / "r.fa")
    write_fasta(p, {"chrA": "ACGT" * 25, "chrB": "GGCC" * 10}, width=13)
    fa = FastaReader(p)
    assert fa.names == ["chrA", "chrB"]
    assert fa.length("chrA") == 100
    assert fa.fetch("chrA", 0, 8) == "ACGTACGT"
    assert fa.fetch("chrA", 11, 17) == "TACGTA"
    assert fa.fetch("chrB", 36) == "GGCC"


# ------------------------------------------------------------- round-trips

def _records_equal(a, b, check_aux=True):
    assert a.qname == b.qname
    assert a.flag == b.flag
    assert a.refID == b.refID
    assert a.pos == b.pos
    assert a.mapq == b.mapq
    assert a.cigar == b.cigar
    assert a.seq() == b.seq()
    assert a.qual == b.qual
    if check_aux:
        for tag in ("HP", "MM", "ML", "MD", "de"):
            assert a.get_tag(tag) == b.get_tag(tag), tag


# mode -> bam_to_cram's arguments after (bam, cram): ref_fasta,
# embed_ref, no_ref, records_per_slice, feature_style; "nomd" converts
# the BAM without its MD tags
MODES = {"emb": (None, True, False, 100, "X"),
         "ext": ("fa", False, False, 1000, "X"),
         "noref": (None, True, True, 1000, "X"),
         "bq": (None, True, False, 1000, "B"),
         "nomd": ("fa", False, False, 1000, "X")}


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """(dir, bam, vcf, truth, {mode: CRAM}, reference FASTA)."""
    d = str(tmp_path_factory.mktemp("cram_scn"))
    bam, vcf, truth = make_two_block_scenario(d)
    sr = truth["region"]
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, {sr.cfg.chrom: sr.ref})
    rb = BamReader(bam)
    stripped = os.path.join(d, "nomd.bam")
    with BamWriter(stripped, rb.ref_names, rb.ref_lens,
                   header_text=rb.header_text) as w:
        for rec in rb.fetch_all():
            rec.remove_tag("MD")
            w.write(rec)
    crams = {m: os.path.join(d, f"{m}.cram") for m in MODES}
    procs = [Spawned(bam_to_cram, stripped if m == "nomd" else bam,
                     crams[m], fa if a[0] else None, *a[1:])
             for m, a in MODES.items()]
    for p in procs:
        p.result(timeout=600)
    return d, bam, vcf, truth, crams, fa


def test_cram_roundtrip_embedded_ref(scenario):
    d, bam, vcf, truth, crams, fa = scenario
    cram = crams["emb"]
    assert is_cram(cram) and not is_cram(bam)
    orig = list(BamReader(bam).fetch_all())
    rd = CramReader(cram)
    assert rd.ref_names == BamReader(bam).ref_names
    got = list(rd.fetch_all())
    assert len(got) == len(orig)
    for a, b in zip(orig, got):
        _records_equal(a, b)


def test_cram_roundtrip_external_fasta(scenario, monkeypatch):
    d, bam, vcf, truth, crams, fa = scenario
    cram = crams["ext"]
    orig = list(BamReader(bam).fetch_all())
    got = list(CramReader(cram, ref_fasta=fa).fetch_all())
    assert len(got) == len(orig)
    for a, b in zip(orig, got):
        _records_equal(a, b)
    # without any reference the mapped slices must fail loudly
    with pytest.raises(ValueError, match="reference"):
        list(CramReader(cram).fetch_all())
    # env var resolution path
    monkeypatch.setenv("POMFRET_REF_FASTA", fa)
    assert len(list(CramReader(cram).fetch_all())) == len(orig)


def test_cram_roundtrip_no_ref_mode(scenario):
    d, bam, vcf, truth, crams, fa = scenario
    orig = list(BamReader(bam).fetch_all())
    got = list(CramReader(crams["noref"]).fetch_all())  # no reference
    assert len(got) == len(orig)
    for a, b in zip(orig, got):
        _records_equal(a, b)


def test_cram_region_fetch_matches_bam(scenario):
    d, bam, vcf, truth, crams, fa = scenario
    cram = crams["emb"]
    assert os.path.exists(cram + ".crai")
    rb = BamReader(bam)
    rc = CramReader(cram)
    chrom = rb.ref_names[0]
    for beg, end in ((0, 10_000), (79_000, 121_000), (150_000, 200_000)):
        a = sorted(r.qname for r in rb.fetch(chrom, beg, end))
        b = sorted(r.qname for r in rc.fetch(chrom, beg, end))
        assert a == b and len(a) > 0


def test_cram_md_regeneration(scenario):
    """The MD tags of a CRAM made without them are regenerated from the
    reference (varhaptag parses MD, blockjoin.c:1545-1691)."""
    d, bam, vcf, truth, crams, fa = scenario
    orig = {r.qname: r for r in BamReader(bam).fetch_all()}
    n = 0
    for rec in CramReader(crams["nomd"], ref_fasta=fa).fetch_all():
        md = rec.get_tag("MD")
        assert md is not None
        assert md == orig[rec.qname].get_tag("MD"), rec.qname
        n += 1
    assert n == len(orig)


def test_open_alignment_dispatch(scenario):
    d, bam, vcf, truth, crams, fa = scenario
    assert isinstance(open_alignment(bam), BamReader)
    assert isinstance(open_alignment(crams["emb"]), CramReader)


def test_cram_roundtrip_bq_feature_style(scenario):
    """'B' (verbatim base+qual) and 'i' (single-base insertion) features are
    legal alternatives to 'X'/'I'; decode must give identical records."""
    d, bam, vcf, truth, crams, fa = scenario
    orig = list(BamReader(bam).fetch_all())
    got = list(CramReader(crams["bq"]).fetch_all())
    assert len(got) == len(orig)
    for a, b in zip(orig, got):
        _records_equal(a, b)


def test_cram_unmapped_records_roundtrip(tmp_path):
    bam = str(tmp_path / "u.bam")
    recs = [
        make_record("m0", 0, 100, "ACGTACGTAA", [("M", 10)], flag=0,
                    tags=[("HP", "i", 1)]),
        make_record("u1", 0, 150, "TTGGCCAATT", [], flag=4, mapq=0),
        make_record("m2", 0, 200, "ACGTACGTAA", [("S", 2), ("M", 8)],
                    flag=16),
    ]
    with BamWriter(bam, ["chrZ"], [1000]) as w:
        for r in recs:
            w.write(r)
    cram = str(tmp_path / "u.cram")
    bam_to_cram(bam, cram, embed_ref=True, records_per_slice=10)
    got = list(CramReader(cram).fetch_all())
    assert [r.qname for r in got] == ["m0", "u1", "m2"]
    for a, b in zip(recs, got):
        assert a.flag == b.flag and a.seq() == b.seq() and a.pos == b.pos
        assert a.cigar == b.cigar and a.qual == b.qual
    assert got[0].get_tag("HP") == 1


def test_build_alignment_q_and_Q_features():
    """'q' (qual stretch) and 'Q' (single qual) are pure overlays: they set
    quality bytes without consuming read/ref positions (htslib semantics);
    bases come from the reference."""
    from pomfret_tpu_torch.io.cram import (CompressionHeader, _CramRec,
                                           build_alignment)
    ch = CompressionHeader()
    ref = "ACGTACGTAC"
    r = _CramRec(rl=10, ap=1)
    r.features = [("q", 3, b"\x1e\x1f"), ("Q", 7, 40)]
    seq, cig, overlay = build_alignment(r, ch, ref, 0)
    assert seq == ref
    assert cig == [("M", 10)]
    assert overlay == {2: 0x1e, 3: 0x1f, 6: 40}
    # a substitution AFTER a 'q' stretch must land at its own position,
    # not be displaced by the stretch length
    r2 = _CramRec(rl=6, ap=3)
    r2.features = [("q", 1, b"\x1e\x1e\x1e"), ("X", 2, 0)]
    seq2, cig2, ov2 = build_alignment(r2, ch, ref, 0)
    # ap=3 -> 0-based ref pos 2; read[1] substituted from ref 'T'(pos3)
    # code 0 -> 'A'
    assert cig2 == [("M", 6)]
    assert seq2[0] == ref[2] and seq2[1] == "A" and seq2[2:] == ref[4:8]
    assert ov2 == {0: 0x1e, 1: 0x1e, 2: 0x1e}


def test_cram_fuzz_roundtrip(tmp_path):
    """Randomized records: mixed CIGARs (S/I/D/N/P/H), IUPAC bases, every
    aux type, paired/detached mates, multiple chromosomes, multiple
    slices."""
    bam = str(tmp_path / "fz.bam")
    recs = fuzz_bam(port_modules(), bam, 4242, 120, tail_clip=True)
    for mode in ({"embed_ref": True}, {"no_ref": True}):
        cram = str(tmp_path / f"fz_{'e' if mode.get('embed_ref') else 'n'}"
                              ".cram")
        bam_to_cram(bam, cram, records_per_slice=37, **mode)
        got = list(CramReader(cram).fetch_all())
        assert len(got) == len(recs)
        for a, b in zip(recs, got):
            assert a.qname == b.qname
            assert a.flag == b.flag and a.pos == b.pos and a.refID == b.refID
            assert a.cigar == b.cigar, (a.qname, a.cigar, b.cigar)
            # bases outside the substitution alphabet fall back to verbatim
            # 'B' features, so every mode round-trips sequences exactly
            assert a.seq() == b.seq(), a.qname
            assert a.qual == b.qual
            assert a.get_tag("HP") == b.get_tag("HP")
            assert a.get_tag("XZ") == b.get_tag("XZ")
            assert abs((a.get_tag("de") or 0) - (b.get_tag("de") or 0)) \
                < 1e-6
            if a.flag & 1:
                assert b.next_refID == a.next_refID
                assert b.next_pos == a.next_pos
                assert b.tlen == a.tlen


def test_cram_rg_and_nf_mate_roundtrip(tmp_path):
    """RG:Z rides the RG series (index into @RG header lines); NF-linked
    mates get both directions' RNEXT/PNEXT/flags and TLEN
    reconstructed."""
    hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
           "@SQ\tSN:cX\tLN:10000\n"
           "@RG\tID:groupA\tSM:s1\n@RG\tID:groupB\tSM:s2\n")
    r1 = make_record("p1", 0, 100, "ACGTACGTAC", [("M", 10)], flag=1 | 64,
                     tags=[("RG", "Z", "groupB")])
    r2 = make_record("p1", 0, 300, "ACGTACGTAC", [("M", 10)],
                     flag=1 | 16 | 128, tags=[("RG", "Z", "groupA")])
    bam = str(tmp_path / "rg.bam")
    with BamWriter(bam, ["cX"], [10000], header_text=hdr) as w:
        w.write(r1)
        w.write(r2)
    cram = str(tmp_path / "rg.cram")
    bam_to_cram(bam, cram, no_ref=True)
    a, b = list(CramReader(cram).fetch_all())
    assert a.get_tag("RG") == "groupB"
    assert b.get_tag("RG") == "groupA"
    assert a.flag & 0x20 == 0  # mate-reverse bits recomputed from MF
    assert b.flag & 0x10


def test_cram_nf_linked_mates_decode_both_sides():
    """Direct slice-level check of the NF path: decode fixes up BOTH
    mates."""
    from pomfret_tpu_torch.io.cram import (CF_QS_STORED, CompressionHeader,
                                           _CramRec)
    rd = CramReader.__new__(CramReader)
    rd.rg_ids = []
    recs = [_CramRec(bf=1 | 64, cf=0x4 | CF_QS_STORED, ref_id=0, rl=4,
                     ap=101, nf=0, name=b"m", quals=b"####"),
            _CramRec(bf=1 | 16 | 128, cf=CF_QS_STORED, ref_id=0, rl=4,
                     ap=201, nf=-1, name=b"m", quals=b"####")]
    ch = CompressionHeader()
    out = [rd._to_bam_record(r, recs, i, ch, "A" * 300, 100)
           for i, r in enumerate(recs)]
    # replicate the post-pass from _decode_slice
    a, b = out
    b.next_refID = a.refID
    b.next_pos = a.pos
    if a.flag & 0x10:
        b.flag |= 0x20
    span = max(bam_endpos(a), bam_endpos(b)) - min(a.pos, b.pos)
    a.tlen, b.tlen = span, -span
    assert a.next_pos == 200 and a.flag & 0x20  # mate reversed
    assert b.next_pos == 100 and b.tlen == -104 and a.tlen == 104


def test_cram_direct_region_reads_no_spool(scenario, tmp_path, monkeypatch):
    """methphase on a CRAM without --write-bam decodes slices (the native
    cram_decode_slice feeding bam_window_load and bam_scan), makes no
    spool BAM, and writes what the run on the BAM writes."""
    import pomfret_tpu_torch.io.cram as C
    d, bam, vcf, truth, crams, fa = scenario
    monkeypatch.setenv("POMFRET_SPOOL_DIR", str(tmp_path))
    C._SPOOL_CACHE.clear()
    p_bam = str(tmp_path / "o_bam")
    p_cram = str(tmp_path / "o_cram")
    # no -c: the coverage scan exercises the direct scan_columns too
    assert cli_main(["methphase", "-o", p_bam, "--vcf", vcf,
                     "--engine", "torch", bam]) == 0
    assert cli_main(["methphase", "-o", p_cram, "--vcf", vcf,
                     "--engine", "torch", crams["emb"]]) == 0
    spools = [f for f in os.listdir(str(tmp_path))
              if f.startswith("pomfret_spool_")]
    assert spools == [], f"direct CRAM path must not spool, got {spools}"
    for ext in (".mp.gtf", ".mp.vcf"):
        with open(p_bam + ext, "rb") as f1, open(p_cram + ext, "rb") as f2:
            assert f1.read() == f2.read(), ext


def _same_columns(cb, cc):
    assert cb is not None and cc is not None
    assert cb["n"] == cc["n"] > 0
    assert cb["qnames"] == cc["qnames"]
    for k in ("pos", "endpos", "strand", "hp", "l_seq", "call_n"):
        np.testing.assert_array_equal(cb[k], cc[k], err_msg=k)
    for j in range(cb["n"]):
        ob, oc = int(cb["call_off"][j]), int(cc["call_off"][j])
        n = int(cb["call_n"][j])
        np.testing.assert_array_equal(cb["calls"][ob:ob + n],
                                      cc["calls"][oc:oc + n])
        np.testing.assert_array_equal(cb["quals"][ob:ob + n],
                                      cc["quals"][oc:oc + n])


def test_cram_direct_window_columnar_matches_bam(scenario):
    """fetch_window_columnar on a CRAM (direct slice decode) returns the
    same records/calls as the BAM reader's native window load."""
    d, bam, vcf, truth, crams, fa = scenario
    br = BamReader(bam)
    cr = CramReader(crams["emb"])
    for beg, end in ((0, 60_000), (50_000, 130_000), (150_000, 200_000)):
        cb, _ = br.fetch_window_columnar("chr1", beg, end, 10, 15000, 0.1,
                                         100, 156)
        cc, _ = cr.fetch_window_columnar("chr1", beg, end, 10, 15000, 0.1,
                                         100, 156)
        _same_columns(cb, cc)


def test_cram_qs_skip_engages_and_matches_full_decode(scenario,
                                                      monkeypatch):
    """The window path skips decompressing the QS series block: (a) the
    skip engages on the writer's output (QS has a dedicated external
    block), (b) window results are identical with the skip on and forced
    off (POMFRET_CRAM_FULL_QS=1)."""
    from pomfret_tpu_torch.io.cram import (CT_COMPRESSION_HEADER,
                                           parse_compression_header,
                                           read_block)
    d, bam, vcf, truth, crams, fa = scenario
    cram = crams["emb"]
    cr = CramReader(cram)
    pos, h, body = next(cr._iter_containers())
    blk, _ = read_block(body, 0)
    assert blk.content_type == CT_COMPRESSION_HEADER
    ch = parse_compression_header(blk.data)
    assert cr._qs_skip_cid(ch) is not None

    def _win(reader):
        return reader.fetch_window_columnar("chr1", 50_000, 130_000, 10,
                                            15000, 0.1, 100, 156)[0]

    c_skip = _win(cr)
    monkeypatch.setenv("POMFRET_CRAM_FULL_QS", "1")
    _same_columns(c_skip, _win(CramReader(cram)))  # no warm slice cache


def test_cram_31_codec_error_message():
    """A block compressed with a CRAM 3.1-only codec raises an error that
    names the codec and the re-encode workaround."""
    from pomfret_tpu_torch.io.cram import decompress_block
    with pytest.raises(ValueError, match=r"rANS Nx16.*3\.1-only.*"
                                         r"version=3\.0"):
        decompress_block(5, b"\x00\x01\x02", 16)
    with pytest.raises(ValueError, match="name tokenizer"):
        decompress_block(8, b"\x00", 4)
