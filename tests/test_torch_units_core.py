"""The port's core/ modules held to the JAX package's unit checks of
them, on the same inputs, with the same expected values: the JAX tests'
bodies, run on the port's modules.
- core/varhaptag.py and core/variants.py (tests/test_varhaptag.py, 13
  cases): the CIGAR+MD variant walk and the read's haplotype vote;
- core/fisher.py (tests/test_fisher.py, 13 cases): kt_fisher_exact
  against scipy;
- core/methmer.py (tests/test_methmer_fast.py, 2 cases;
  test_review_regressions.py:8): the vectorized methmer extraction
  against the literal walk, and the store's clamp on a duplicated start
  grid;
- core/intervals.py and io/intervals_loader.py (tests/test_intervals.py,
  6 cases): gap extraction from VCF, GTF and TSV, merging, lifting,
  flips and the new phase blocks.
Tolerance: exact, Fisher's p-values to scipy's within 1e-6 relative.
"""
import gzip

import numpy as np
import pytest
from scipy import stats

from pomfret_tpu_torch.core.fisher import kt_fisher_exact
from pomfret_tpu_torch.core.intervals import (
    FlipLookup, Ranges, Storage, UnphasedLookup, check_if_in_dropped_intervals,
    generate_new_phase_blocks, get_new_phaseblock_id, lift_decisions,
    make_decisions_flippings_onraw, merge_close_intervals, store_raw_intervals,
)
from pomfret_tpu_torch.core.methmer import (Methmers, _get_mmr_of_read_walk,
                                            get_mmr_of_read,
                                            store_mmr_of_reads)
from pomfret_tpu_torch.core.readset import MmrConfig, Read, ReadSet
from pomfret_tpu_torch.core.varhaptag import (haptag_one_read_with_variants,
                                              parse_variants_for_one_read)
from pomfret_tpu_torch.core.variants import (HAPTAG_UNPHASED, VAR_OP_D,
                                             VAR_OP_I, VAR_OP_X, Variant,
                                             seq_nt4)
from pomfret_tpu_torch.io.intervals_loader import (IS_GTF, IS_TSV, IS_VCF,
                                                   load_intervals_from_file)
from pomfret_tpu_torch.io.records import make_record


# ---------------------------------------------------------------- varhaptag

def mk(seq, cigar, md, pos=100):
    return make_record("q", 0, pos, seq, cigar, tags=[("MD", "Z", md)])


def test_md_snp():
    r = mk("ACGTACGTAC", [("M", 10)], "4A5")
    vs = parse_variants_for_one_read(r)
    assert len(vs) == 1
    v = vs[0]
    assert (v.pos, v.op, v.length) == (104, VAR_OP_X, 1)
    assert v.chars == seq_nt4("A")  # read base at self_pos 4


def test_md_adjacent_snps():
    r = mk("ACGTACGTAC", [("M", 10)], "4GT4")
    vs = parse_variants_for_one_read(r)
    assert [(v.pos, v.op) for v in vs] == [(104, VAR_OP_X), (105, VAR_OP_X)]
    assert vs[0].chars == seq_nt4("A")
    assert vs[1].chars == seq_nt4("C")


def test_md_deletion():
    r = mk("ACGTACGTAC", [("M", 4), ("D", 2), ("M", 6)], "4^AC6")
    vs = parse_variants_for_one_read(r)
    assert len(vs) == 1
    v = vs[0]
    assert (v.pos, v.op, v.length) == (104, VAR_OP_D, 2)
    assert v.chars == seq_nt4("AC")


def test_md_del_at_end_dropped():
    # pending deletion at end of MD never flushes (reference quirk)
    r = mk("ACGTACGTAC", [("M", 10), ("D", 2)], "10^AC")
    vs = parse_variants_for_one_read(r)
    assert vs == []


def test_cigar_insertion_recorded():
    r = mk("ACGTTTACGTAC", [("M", 4), ("I", 2), ("M", 6)], "10")
    vs = parse_variants_for_one_read(r)
    assert len(vs) == 1
    v = vs[0]
    assert (v.pos, v.op, v.length) == (104, VAR_OP_I, 2)
    assert v.chars == seq_nt4("TT")


def test_md_snp_right_after_insertion_reads_inserted_base():
    # strict '>' in the insertion-skip: the SNP base comes from the inserted
    # sequence (reference quirk, blockjoin.c:1631-1635)
    r = mk("ACGTTTACGTAC", [("M", 4), ("I", 2), ("M", 6)], "4G5")
    vs = parse_variants_for_one_read(r)
    snps = [v for v in vs if v.op == VAR_OP_X]
    assert len(snps) == 1
    assert snps[0].pos == 104
    assert snps[0].chars == seq_nt4("T")  # inserted base, not seq[6]


def test_md_with_leading_softclip():
    r = mk("ACGTACGTAC", [("S", 3), ("M", 7)], "3G3")
    vs = parse_variants_for_one_read(r)
    assert len(vs) == 1
    assert vs[0].pos == 103
    assert vs[0].chars == seq_nt4(("ACGTACGTAC")[6])


def _kv(pos, alt, hp):
    return Variant(pos, VAR_OP_X, 1, seq_nt4(alt), hp)


def test_vote_alt_and_ref():
    known = [_kv(100, "C", 0), _kv(200, "G", 1), _kv(300, "T", 0)]
    read_vars = [Variant(100, VAR_OP_X, 1, seq_nt4("C"), HAPTAG_UNPHASED),
                 Variant(300, VAR_OP_X, 1, seq_nt4("A"), HAPTAG_UNPHASED)]
    # ALT match at 100 -> vote hap 0^1=1; absent at 200 -> REF vote hap 1;
    # mismatching ALT at 300 -> no vote. (but 300 also skips REF vote)
    tag = haptag_one_read_with_variants(known, read_vars, 50, 350, [0])
    assert tag == 1


def test_vote_deletion_explains_absence():
    known = [_kv(200, "G", 1)]
    read_vars = [Variant(195, VAR_OP_D, 10, seq_nt4("ACGTACGTAC"), HAPTAG_UNPHASED),
                 Variant(210, VAR_OP_X, 1, seq_nt4("A"), HAPTAG_UNPHASED)]
    # REF vote at 200 suppressed by the covering deletion -> 0 votes -> unphased
    tag = haptag_one_read_with_variants(known, read_vars, 50, 350, [0])
    assert tag == HAPTAG_UNPHASED


def test_vote_end_of_interval_ignores_deletion():
    # reference quirk: when the known variant is the LAST piggyback entry, the
    # REF vote is cast without the deletion look-back (blockjoin.c:1757-1761)
    known = [_kv(200, "G", 1)]
    read_vars = [Variant(195, VAR_OP_D, 10, seq_nt4("ACGTACGTAC"), HAPTAG_UNPHASED)]
    tag = haptag_one_read_with_variants(known, read_vars, 50, 350, [0])
    assert tag == 1


def test_vote_ambiguity_rules():
    # 5 vs 4 with both >3 and ratio<5 -> unphased
    known = [_kv(100 + i * 10, "C", 0) for i in range(5)] + \
            [_kv(300 + i * 10, "C", 1) for i in range(4)]
    tag = haptag_one_read_with_variants(known, [], 50, 500, [0])
    assert tag == HAPTAG_UNPHASED
    # 1 vs 0 -> hap0
    tag2 = haptag_one_read_with_variants([_kv(100, "C", 0)], [], 50, 500, [0])
    assert tag2 == 0
    # strong override: 20 vs 4 ratio=5 >= 5 -> majority wins
    known3 = [_kv(100 + i * 10, "C", 0) for i in range(20)] + \
             [_kv(700 + i * 10, "C", 1) for i in range(4)]
    tag3 = haptag_one_read_with_variants(known3, [], 50, 1000, [0])
    assert tag3 == 0


def test_vote_indel_match():
    known = [Variant(150, VAR_OP_I, 2, seq_nt4("AT"), 1)]
    rv_match = [Variant(150, VAR_OP_I, 2, seq_nt4("AT"), HAPTAG_UNPHASED)]
    assert haptag_one_read_with_variants(known, rv_match, 50, 400, [0]) == 0
    rv_diff = [Variant(150, VAR_OP_I, 2, seq_nt4("AA"), HAPTAG_UNPHASED)]
    # mismatch -> no ALT vote; and no REF vote either (position present)
    assert haptag_one_read_with_variants(known, rv_diff, 50, 400, [0]) == HAPTAG_UNPHASED


def test_range_restriction():
    known = [_kv(100, "C", 0), _kv(900, "C", 1)]
    # read spans only 50-200: variant at 900 out of range -> one REF vote hap0
    assert haptag_one_read_with_variants(known, [], 50, 200, [0]) == 0


# ------------------------------------------------------------------- fisher

@pytest.mark.parametrize("tbl", [
    (10, 0, 0, 10), (12, 1, 2, 14), (5, 5, 5, 5), (0, 0, 0, 0),
    (1, 0, 0, 0), (30, 2, 1, 25), (100, 3, 4, 90), (7, 7, 0, 0),
    (2, 3, 4, 5), (0, 10, 10, 0), (1, 1, 1, 1), (50, 0, 0, 1),
])
def test_two_sided_matches_scipy(tbl):
    n11, n12, n21, n22 = tbl
    _, _, two = kt_fisher_exact(n11, n12, n21, n22)
    expect = stats.fisher_exact([[n11, n12], [n21, n22]])[1]
    assert two == pytest.approx(expect, rel=1e-6, abs=1e-12)


def test_decision_threshold_band():
    """Exhaustively confirm p<0.001 decisions agree with scipy over the
    realistic contingency range (boundary read counts 0..25)."""
    rng = np.random.default_rng(0)
    n_checked = 0
    for _ in range(500):
        n11, n12, n21, n22 = rng.integers(0, 26, size=4)
        _, _, two = kt_fisher_exact(int(n11), int(n12), int(n21), int(n22))
        expect = stats.fisher_exact([[n11, n12], [n21, n22]])[1]
        assert (two < 0.001) == (expect < 0.001), (n11, n12, n21, n22, two, expect)
        n_checked += 1
    assert n_checked == 500


# ------------------------------------------------------------------ methmer

def _mk_ms(rng, n_sites, with_dups):
    pos = np.sort(rng.choice(np.arange(100, 100000, 7), size=n_sites, replace=False)).astype(np.uint32)
    if with_dups:
        # bwd-style starts: non-decreasing with duplicate runs
        starts = pos.copy()
        for i in range(1, n_sites):
            if rng.random() < 0.3:
                starts[i] = starts[i - 1]
        starts = np.maximum.accumulate(starts)
    else:
        starts = pos
    lens = rng.integers(1, 6, size=n_sites).astype(np.uint8)
    return Methmers(config=MmrConfig(), n=n_sites, sites_real_poss=pos,
                    sites_starts=starts, mmr_lens=lens)


def _mk_read(rng, ms, i):
    # calls at a random subset of grid positions + a few off-grid positions
    grid = np.unique(ms.sites_starts)
    k = rng.integers(2, max(3, len(grid)))
    sel = np.sort(rng.choice(grid, size=min(k, len(grid)), replace=False))
    extra = rng.choice(np.arange(50, 110000, 13), size=3, replace=False)
    calls = np.unique(np.concatenate([sel, extra])).astype(np.uint32)
    quals = rng.integers(0, 3, size=len(calls)).astype(np.uint8)
    return Read(i=i, qname=f"r{i}", hp=0, strand=0, length=20000,
                start_pos=int(calls[0]), end_pos=int(calls[-1]) + 1,
                calls=calls, quals=quals)


@pytest.mark.parametrize("with_dups", [False, True])
def test_fuzz_fast_matches_walk(with_dups):
    rng = np.random.default_rng(42 if with_dups else 7)
    for trial in range(300):
        n_sites = int(rng.integers(2, 40))
        ms = _mk_ms(rng, n_sites, with_dups)
        read = _mk_read(rng, ms, trial)
        fast = get_mmr_of_read(read, ms)
        walk = _get_mmr_of_read_walk(read, ms)
        assert fast == walk, (trial, ms.sites_starts.tolist(),
                              read.calls.tolist(), read.quals.tolist(),
                              ms.mmr_lens.tolist(), fast, walk)


def test_methmer_overflow_clamped():
    """The i>1 dedup quirk can triple-emit on a duplicated bwd start grid;
    the C writes out of bounds (UB) — we clamp to the site array."""
    ms = Methmers(config=MmrConfig(), n=2,
                  sites_real_poss=np.array([1000, 1200], dtype=np.uint32),
                  sites_starts=np.array([1000, 1000], dtype=np.uint32),
                  mmr_lens=np.array([2, 1], dtype=np.uint8))
    rd = Read(i=0, qname="q", hp=0, strand=0, length=20000,
              start_pos=900, end_pos=1300,
              calls=np.array([1000, 1200], dtype=np.uint32),
              quals=np.array([0, 1], dtype=np.uint8))
    rs = ReadSet(ref_start=900, ref_end=1300, reads=[rd])
    store_mmr_of_reads(rs, ms)
    assert rd.mmr_start_i + rd.mmr_n <= ms.n  # no out-of-bounds inserts


# ---------------------------------------------------------------- intervals

def _vcf_line(chrom, pos, ps, gt="0|1"):
    return f"{chrom}\t{pos}\t.\tA\tC\t50\tPASS\t.\tGT:PS\t{gt}:{ps}"


def _write(path, lines, gz=False):
    data = "\n".join(lines) + "\n"
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        with open(path, "w") as f:
            f.write(data)


VCF_HEADER = [
    "##fileformat=VCFv4.2",
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample",
]


def test_vcf_gap_extraction(tmp_path):
    p = str(tmp_path / "a.vcf")
    lines = VCF_HEADER + [
        _vcf_line("chr1", 100, 100),
        _vcf_line("chr1", 150, 100),
        _vcf_line("chr1", 220, "."),      # PS '.' skipped, state untouched
        _vcf_line("chr1", 300, 300),      # new block: gap (150, 300)
        _vcf_line("chr1", 400, 300),
        _vcf_line("chr1", 900, 900),      # gap (400, 900)
        # second chromosome: abs_start stays 0 (global prev_group_ID quirk)
        _vcf_line("chr2", 50, 50),
        _vcf_line("chr2", 80, 50),
        _vcf_line("chr2", 500, 500),      # gap (80, 500)
    ]
    _write(p, lines)
    st = Storage()
    load_intervals_from_file(p, IS_VCF, st)
    assert st.ref_names == ["chr1", "chr2"]
    r1, r2 = st.ranges
    assert r1.abs_start == 100
    assert r1.starts == [150, 400]
    assert r1.ends == [300, 900]
    assert r1.abs_end == 900
    assert r2.abs_start == 0   # quirk preserved
    assert r2.starts == [80]
    assert r2.ends == [500]
    assert r2.abs_end == 500


def test_vcf_gzip_and_variant_collection(tmp_path):
    p = str(tmp_path / "a.vcf.gz")
    lines = VCF_HEADER + [
        "chr1\t100\t.\tA\tC\t50\tPASS\t.\tGT:PS\t0|1:100",
        "chr1\t120\t.\tAT\tA\t50\tPASS\t.\tGT:PS\t1|0:100",   # DEL
        "chr1\t140\t.\tA\tACC\t50\tPASS\t.\tGT:PS\t0|1:100",  # INS
        "chr1\t160\t.\tA\tC\t50\tPASS\t.\tGT:PS\t0/1:100",    # unphased: skip
        "chr1\t180\t.\tAG\tCT\t50\tPASS\t.\tGT:PS\t0|1:100",  # MNP: skip
    ]
    _write(p, lines, gz=True)
    st = Storage()
    collected = {}

    def cb(chrom, variants):
        collected[chrom] = list(variants)

    load_intervals_from_file(p, IS_VCF, st, load_vcf_variants_too=True, haptag_callback=cb)
    assert st.stores_raw_tag
    vs = collected["chr1"]
    assert len(vs) == 3
    snp, dele, ins = vs
    assert (snp.pos, snp.op, snp.length, snp.chars, snp.haptag) == (99, 1, 1, (1,), 0)
    assert (dele.pos, dele.op, dele.length, dele.chars, dele.haptag) == (120, 3, 1, (3,), 1)
    assert (ins.pos, ins.op, ins.length, ins.chars, ins.haptag) == (139, 2, 2, (1, 1), 0)


def test_gtf_tsv_loading(tmp_path):
    g = str(tmp_path / "a.gtf")
    _write(g, [
        'chr1\tPhasing\texon\t100\t200\t.\t+\t.\tgene_id "100";',
        'chr1\tPhasing\texon\t500\t800\t.\t+\t.\tgene_id "500";',
        'chr2\tPhasing\texon\t10\t20\t.\t+\t.\tgene_id "10";',
    ])
    st = Storage()
    load_intervals_from_file(g, IS_GTF, st)
    assert st.ranges[0].abs_start == 100
    assert st.ranges[0].starts == [200]
    assert st.ranges[0].ends == [500]
    assert st.ranges[0].abs_end == 800
    assert st.ranges[1].abs_start == 10  # GTF resets per-chromosome (asymmetry vs VCF)
    assert st.ranges[1].abs_end == 20

    t = str(tmp_path / "a.tsv")
    _write(t, ["chr1\t100\t200", "chr1\t500\t800"])
    st2 = Storage()
    load_intervals_from_file(t, IS_TSV, st2)
    assert st2.ranges[0].starts == [200]
    assert st2.ranges[0].ends == [500]


def _mk_ranges():
    rg = Ranges(abs_start=50, abs_end=2000)
    rg.starts = [100, 300, 1000, 1300]
    rg.ends = [200, 400, 1100, 1400]
    rg.decisions = [-1, -1, -1, -1]
    return rg


def test_merge_and_lift_flow():
    rg = _mk_ranges()
    store_raw_intervals(rg)
    merge_close_intervals(rg, 150)
    assert rg.starts == [100, 1000, 1300]
    assert rg.ends == [400, 1100, 1400]
    assert rg.dropped == [(200, 300)]
    assert len(rg.decisions) == 4  # pre-merge length retained
    assert rg.rawunphasedblocks == [[100, 200], [300, 400], [1000, 1100], [1300, 1400]]

    st = Storage(ref_names=["chr1"], ranges=[rg])
    # merged gap 0 joins cis (0): collapses raw gaps 0+1; gap1 no-join; gap2 trans
    rg.decisions[0] = 0
    rg.decisions[1] = -1
    rg.decisions[2] = 1
    lift_decisions(st)
    assert rg.rawunphasedblocks == [[100, 400], [1000, 1100], [1300, 1400]]
    assert rg.decisions_onraw == [0, -1, 1]
    make_decisions_flippings_onraw(st)
    assert rg.flips_onraw == [0, 0, 1]
    generate_new_phase_blocks(st, use_raw=True)
    # non-joined gaps split blocks: gap (1000,1100) only. Reference quirk:
    # the trailing block starts at the LAST non-joined gap's START (not end),
    # blockjoin.c:2354-2357.
    assert rg.phaseblocks == [(50, 1000), (1000, 2000)]

    assert get_new_phaseblock_id(rg, 999) == 50
    assert get_new_phaseblock_id(rg, 1000) == 1000  # strict <: trailing block wins
    assert get_new_phaseblock_id(rg, 1150) == 1000
    assert check_if_in_dropped_intervals(rg, 250)
    assert not check_if_in_dropped_intervals(rg, 350)

    fl = FlipLookup()
    assert fl.get(rg, 60) == 0        # before first gap
    assert fl.get(rg, 500) == 0       # after joined cis gap: flip 0
    fl2 = FlipLookup()
    assert fl2.get(rg, 1200) == 0     # between gap1(end 1100) and gap2 start
    assert fl2.get(rg, 1500) == 1     # after the trans gap
    fl3 = FlipLookup()
    assert fl3.get(rg, 1350) == 1     # inside the trans gap: falls through to last flip


def test_all_no_join_keeps_blocks():
    rg = _mk_ranges()
    store_raw_intervals(rg)
    merge_close_intervals(rg, 50)  # nothing merges
    st = Storage(ref_names=["chr1"], ranges=[rg])
    lift_decisions(st)
    assert rg.decisions_onraw == [-1, -1, -1, -1]
    make_decisions_flippings_onraw(st)
    generate_new_phase_blocks(st, use_raw=True)
    # trailing-block-starts-at-gap-start quirk again
    assert rg.phaseblocks == [(50, 100), (200, 300), (400, 1000), (1100, 1300), (1300, 2000)]


def test_unphased_lookup():
    rg = _mk_ranges()
    ul = UnphasedLookup()
    ok, upd = ul.check(rg, 250)   # between gap0 end(200) and gap1 start(300)
    assert ok and not upd         # j == prev(1)
    ok, upd = ul.check(rg, 1200)  # between gap2 end(1100) and gap3 start(1300)
    assert ok and upd
    ok, _ = ul.check(rg, 1350)    # inside a gap
    assert not ok
