"""The port's io/ modules held to the JAX package's unit checks of them,
on the same inputs, with the same expected values: the JAX tests' bodies,
run on the port's modules.
- io/basemod.py (tests/test_basemod.py, 15 cases; test_basemod_fast.py,
  1): MM/ML decoding, the quality classes, the CIGAR lift and the
  reference's quirks; the single-item 'C+m' fast path against the general
  decode on synthetic reads;
- io/bgzf.py, io/bam.py, io/bam_writer.py (tests/test_io_roundtrip.py, 4
  cases): BGZF and BAM round trips, region fetch through the index, tag
  updates, and the reference's own index where the reference tree is
  present (it is not everywhere: the JAX test skips then, and so does
  this one).
Tolerance: exact.
"""
import os

import pytest

import pomfret_tpu_torch.io.basemod as B
from pomfret_tpu_torch.io.bam import BamReader, bam_endpos
from pomfret_tpu_torch.io.bam_writer import BamWriter
from pomfret_tpu_torch.io.basemod import (
    CALL_METH, CALL_NOCALL, CALL_UNMETH,
    extract_cpg_5mc_calls, read_meth_calls,
)
from pomfret_tpu_torch.io.bgzf import BgzfReader, BgzfWriter, is_bgzf
from pomfret_tpu_torch.io.records import make_record
from pomfret_tpu_torch.testing import SynthConfig, SynthRegion

from parity.build_ref import REF_DIR  # where the reference tree is kept


# ------------------------------------------------------------------ basemod

LO, HI = 100, 156


def mk(seq, cigar, mm, ml, pos=1000, flag=0):
    return make_record(
        "q", 0, pos, seq, cigar, flag=flag,
        tags=[("MM", "Z", mm), ("ML", "B:C", ml), ("MD", "Z", str(len(seq)))],
    )


def test_forward_explicit_simple():
    # CpGs at stored pos 1 and 5 (modified); seq ACGTACGTA
    seq = "ACGTACGTA"
    rec = mk(seq, [("M", 9)], "C+m?,0,0;", [200, 50])
    poss, quals, imp = extract_cpg_5mc_calls(rec, LO, HI)
    assert poss == [1, 5]
    assert quals == [CALL_METH, CALL_UNMETH]
    assert not imp
    calls, cq, imp = read_meth_calls(rec, LO, HI)
    assert calls == [1001, 1005]
    assert cq == [CALL_METH, CALL_UNMETH]


def test_qual_class_boundaries():
    seq = "ACGTACGTA"
    rec = mk(seq, [("M", 9)], "C+m?,0,0;", [LO, HI - 1])
    _, quals, _ = extract_cpg_5mc_calls(rec, LO, HI)
    # q==lo -> nocall band [lo, hi); q==hi-1 -> nocall; q<lo -> unmeth; q>=hi -> meth
    assert quals == [CALL_NOCALL, CALL_NOCALL]
    rec2 = mk(seq, [("M", 9)], "C+m?,0,0;", [LO - 1, HI])
    _, quals2, _ = extract_cpg_5mc_calls(rec2, LO, HI)
    assert quals2 == [CALL_UNMETH, CALL_METH]


def test_reverse_strand_mapping():
    # stored AACGTTACGT; original (revcomp) ACGTAACGTT with Cs at 1 and 6
    seq = "AACGTTACGT"
    rec = mk(seq, [("M", 10)], "C+m?,0,0;", [220, 10], flag=16)
    poss, quals, imp = extract_cpg_5mc_calls(rec, LO, HI)
    # orig 1 -> stored 8 (qual 220); orig 6 -> stored 3 (qual 10); ascending
    assert poss == [3, 8]
    assert quals == [CALL_UNMETH, CALL_METH]
    calls, cq, _ = read_meth_calls(rec, LO, HI)
    # reverse strand: cgoffset=-1 maps stored G position to the CpG C position
    assert calls == [1002, 1007]
    assert cq == [CALL_UNMETH, CALL_METH]


def test_position_edges_ignored():
    # call at stored pos 0 and len-1 must be ignored entirely
    seq = "CGTACG"  # CpG at 0; C at 4 with G at 5 -> CpG at 4
    rec = mk(seq, [("M", 6)], "C+m?,0,0;", [200, 200])
    poss, quals, imp = extract_cpg_5mc_calls(rec, LO, HI)
    assert poss == [4]  # pos 0 dropped by the 0<pos guard
    assert not imp


def test_indel_lift():
    seq = "ACGTTTACGT"
    # 4M 2D 4M: stored pos 7 (CpG C at 7? seq[7]='C', seq[8]='G') in 2nd M
    rec = mk(seq, [("M", 4), ("D", 2), ("M", 6)], "C+m?,1;", [200])
    # C occurrences: pos1, pos7 -> delta 1 selects pos7
    calls, cq, _ = read_meth_calls(rec, LO, HI)
    assert calls == [1000 + 7 + 2]
    # insertion shifts the other way: 4M 2I 4M
    rec2 = mk(seq, [("M", 4), ("I", 2), ("M", 4)], "C+m?,1;", [200])
    calls2, _, _ = read_meth_calls(rec2, LO, HI)
    assert calls2 == [1000 + 7 - 2]


def test_trigger_at_op_boundary_attributed_to_previous_m():
    # reference quirk: while condition is >=, so a trigger exactly at the end
    # of an M op (here the first inserted base, read pos 4) is consumed and
    # pushed by that M op
    seq = "ACGTCGACGT"
    rec = mk(seq, [("M", 4), ("I", 2), ("M", 4)], "C+m?,1;", [200])
    calls, _, _ = read_meth_calls(rec, LO, HI)
    assert calls == [1004]


def test_trigger_strictly_inside_insertion_dropped():
    seq = "ACGTACGACG"  # C occurrences at 1, 5, 8; pos 5 strictly inside the I
    rec = mk(seq, [("M", 4), ("I", 2), ("M", 4)], "C+m?,1;", [200])
    calls, _, _ = read_meth_calls(rec, LO, HI)
    assert calls == []


def test_leading_softclip():
    seq = "ACGTCGTCGA"  # CpG Cs at stored 1 (in clip), 4 (== cliplen), 7
    rec = mk(seq, [("S", 4), ("M", 6)], "C+m?,0,0,0;", [150, 200, 90])
    # trigger 1: inside clip, silently consumed.
    # trigger 4 == cliplen: special-case push at i_ref+cgoffset = 1000
    # trigger 7 -> ref 996 + 7 = 1003
    calls, cq, _ = read_meth_calls(rec, LO, HI)
    assert calls == [1000, 1003]
    assert cq == [CALL_METH, CALL_UNMETH]


def test_implicit_mode_detection_and_insertion():
    seq = "ACCGTCGA"
    # C occ at 1,2,5; mods listed at 1 (non-CpG -> implicit flag) and 2 (CpG)
    rec = mk(seq, [("M", 8)], "C+m,0,0;", [200, 200])
    poss, quals, imp = extract_cpg_5mc_calls(rec, LO, HI)
    assert imp
    assert poss == [2]
    calls, cq, imp = read_meth_calls(rec, LO, HI)
    assert imp
    # explicit call at CpG 2 (meth) + implicit unmeth inserted at CpG 5
    assert calls == [1002, 1005]
    assert cq == [CALL_METH, CALL_UNMETH]


def test_implicit_scan_does_not_duplicate_explicit():
    seq = "ACGACGTT"
    # CpGs at 1 and 4; explicit call at 4 only; non-CpG C... need implicit flag:
    # add a C at 3? seq[3]='A'. Use seq with stray C: "ACGCCGTT": CpGs at 1, 4;
    seq = "ACGCCGTT"
    # C occ: 1,3,4. mods: delta1 -> pos3 (non-CpG, implicit), delta0 after -> pos4
    rec = mk(seq, [("M", 8)], "C+m,1,0;", [200, 40])
    calls, cq, _ = read_meth_calls(rec, LO, HI)
    # implicit unmeth at CpG 1, explicit unmeth at 4 (q=40<lo)
    assert calls == [1001, 1004]
    assert cq == [CALL_UNMETH, CALL_UNMETH]


def test_multi_mod_interleaved_ml():
    # C+hm shares deltas; ML interleaves h,m per position
    seq = "ACGTACGTA"
    rec = make_record(
        "q", 0, 1000, seq, [("M", 9)],
        tags=[("MM", "Z", "C+hm?,0,0;"), ("ML", "B:C", [5, 200, 7, 50]),
              ("MD", "Z", "9")],
    )
    poss, quals, _ = extract_cpg_5mc_calls(rec, LO, HI)
    assert poss == [1, 5]
    assert quals == [CALL_METH, CALL_UNMETH]  # m quals 200, 50


def test_chebi_codes_ignored():
    seq = "ACGTACGTA"
    rec = make_record(
        "q", 0, 1000, seq, [("M", 9)],
        tags=[("MM", "Z", "C+76792?,0,0;"), ("ML", "B:C", [200, 200]),
              ("MD", "Z", "9")],
    )
    poss, _, imp = extract_cpg_5mc_calls(rec, LO, HI)
    assert poss == []
    assert not imp


def test_n_skip_terminates():
    seq = "ACGTACGTA"
    rec = mk(seq, [("M", 4), ("N", 100), ("M", 5)], "C+m?,0,0;", [200, 200])
    calls, _, _ = read_meth_calls(rec, LO, HI)
    assert calls == [1001]  # second call (pos 5) dropped after N


def test_minus_strand_item_processed_like_plus():
    # The reference never checks mods[j].strand (blockjoin.c:845-858): a
    # 'C-m' item yields the same positions/quals as 'C+m' at the same deltas.
    seq = "ACGTACGTA"
    rec_minus = mk(seq, [("M", 9)], "C-m?,0,0;", [200, 50])
    rec_plus = mk(seq, [("M", 9)], "C+m?,0,0;", [200, 50])
    assert extract_cpg_5mc_calls(rec_minus, LO, HI) == \
        extract_cpg_5mc_calls(rec_plus, LO, HI)
    poss, quals, imp = extract_cpg_5mc_calls(rec_minus, LO, HI)
    assert poss == [1, 5] and quals == [CALL_METH, CALL_UNMETH]


def test_mixed_plus_minus_items_share_ml_cursor():
    # two items: C+m then C-m; ML holds quals for both in written order
    seq = "ACGTACGTA"
    rec = mk(seq, [("M", 9)], "C+m?,0;C-m?,1;", [200, 50])
    poss, quals, _ = extract_cpg_5mc_calls(rec, LO, HI)
    # C+m delta 0 -> first C (stored 1, q 200); C-m delta 1 -> second C
    # (stored 5, q 50)
    assert poss == [1, 5]
    assert quals == [CALL_METH, CALL_UNMETH]


# -------------------------------------------------------- basemod fast path

def test_fast_path_matches_general(monkeypatch):
    sr = SynthRegion(SynthConfig(ref_len=60_000, read_len=16_000,
                                 read_stagger=1500, noise=0.1, nocall=0.1,
                                 frac_reverse=0.5, seed=11))
    recs = sr.make_reads(tagged=True, region=(0, 60_000))
    assert len(recs) > 20
    n_checked = 0
    for rec in recs:
        fast = B._extract_cpg_fast(rec, 100, 156)
        assert fast is not None  # generator emits single-item C+m tags
        orig = B.extract_cpg_5mc_calls
        monkeypatch.setattr(B, "_extract_cpg_fast", lambda *a: None)
        general = B.extract_cpg_5mc_calls(rec, 100, 156)
        monkeypatch.undo()
        assert fast == general, rec.qname
        n_checked += 1
    assert n_checked == len(recs)


# ------------------------------------------------------------- BGZF and BAM

def test_bgzf_roundtrip(tmp_path):
    p = str(tmp_path / "x.bgzf")
    payload = os.urandom(300000) + b"tail"
    with BgzfWriter(p, threads=3) as w:
        w.write(payload)
    assert is_bgzf(p)
    r = BgzfReader(p, threads=2)
    assert r.read_all() == payload
    r2 = BgzfReader(p)
    assert r2.read(10) == payload[:10]
    assert r2.read(len(payload)) == payload[10:]


def _sample_records():
    recs = []
    for i in range(50):
        pos = 1000 + i * 500
        recs.append(
            make_record(
                f"read{i}", 0, pos, "ACGTACGTAC", [("M", 10)],
                flag=16 if i % 3 == 0 else 0,
                tags=[("HP", "i", (i % 2) + 1), ("de", "f", 0.01),
                      ("MD", "Z", "10"), ("MM", "Z", "C+m?,0;"),
                      ("ML", "B:C", [200])],
            )
        )
    # second chromosome
    for i in range(10):
        recs.append(make_record(f"r2_{i}", 1, 100 + i * 50, "ACGT", [("M", 4)]))
    return recs


def test_bam_roundtrip_and_fetch(tmp_path):
    p = str(tmp_path / "t.bam")
    recs = _sample_records()
    with BamWriter(p, ["chr1", "chr2"], [1000000, 5000], header_text="@HD\tVN:1.6\n",
                   keep_index_info=True) as w:
        for r in recs:
            w.write(r)
    w.build_index(n_ref=2)
    assert os.path.exists(p + ".bai")

    rd = BamReader(p)
    assert rd.ref_names == ["chr1", "chr2"]
    got = list(rd.fetch_all())
    assert len(got) == len(recs)
    assert got[0].qname == "read0"
    assert got[0].seq() == "ACGTACGTAC"
    assert got[0].get_tag("HP") == 1
    assert abs(got[0].get_tag("de") - 0.01) < 1e-6
    assert got[0].get_tag("MM") == "C+m?,0;"
    assert got[0].get_tag("ML") == ("C", [200])
    assert bam_endpos(got[0]) == 1010

    # region fetch via index
    sel = list(rd.fetch("chr1", 5000, 8000))
    expect = [r for r in recs if r.refID == 0 and r.pos < 8000 and bam_endpos(r) > 5000]
    assert [r.qname for r in sel] == [r.qname for r in expect]
    sel2 = list(rd.fetch("chr2", 0, 10000))
    assert len(sel2) == 10

    # 1-based region API
    sel3 = list(rd.fetch_region_1based("chr1", 5001, 8000))
    assert [r.qname for r in sel3] == [r.qname for r in expect]


def test_tag_update(tmp_path):
    r = make_record("q", 0, 5, "ACGT", [("M", 4)], tags=[("HP", "i", 1), ("MD", "Z", "4")])
    r.set_int_tag("HP", 2)
    assert r.get_tag("HP") == 2
    assert r.get_tag("MD") == "4"
    r2 = make_record("q", 0, 5, "ACGT", [("M", 4)], tags=[("MD", "Z", "4")])
    r2.set_int_tag("HP", 255)
    assert r2.get_tag("HP") == 255


def test_external_index_compat(tmp_path):
    """Our BAI parser must read the reference's real index files."""
    ref_bai = os.path.join(REF_DIR, "example", "phased.bam.bai")
    if not os.path.exists(ref_bai):
        pytest.skip("reference example index missing")
    from pomfret_tpu_torch.io.bam import BaiIndex
    idx = BaiIndex(ref_bai)
    assert len(idx.bins) >= 1
    # chr6 region used by the bundled example
    chunks = idx.chunks_for_region(0, 11_000_000, 11_200_000)
    assert isinstance(chunks, list)
