"""The benchmark's maker: a seed gives the same set twice and another seed
another set of the same sizes; with the port's own seeds it gives the
port's maker's records and VCF, and its index finds every region's
records."""
from __future__ import annotations

import gzip
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from pbench import maker  # noqa: E402

CHROM = dict(read_stagger=700, cpg_every=100, read_len=20000, noise=0.02,
             nocall=0.02)
PARAMS = dict(n_chroms=2, n_blocks=2, block_len=60000, gap_len=30000,
              read_stagger=700, per_chrom=[dict(CHROM), dict(CHROM)])


def made(d, seed, **kw):
    got = maker.make_set(PARAMS, seed, str(d), procs=2, **kw)
    bam = os.path.join(str(d), maker.BAM_NAME)
    with open(bam, "rb") as f, open(bam + ".bai", "rb") as g:
        raw, bai = f.read(), g.read()
    return dict(raw=raw, bai=bai, plain=gzip.decompress(raw),
                vcf=gzip.open(os.path.join(str(d), maker.VCF_NAME)).read(),
                reads=got["reads"])


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    seed = 2**40 + 3
    return {k: made(tmp_path_factory.mktemp(k), s) for k, s in
            (("a", seed), ("b", seed), ("c", seed + 1))}


def test_same_seed_same_bytes(sets):
    a, b = sets["a"], sets["b"]
    assert a["raw"] == b["raw"] and a["bai"] == b["bai"]
    assert a["vcf"] == b["vcf"]


def test_other_seed_other_set_of_the_same_sizes(sets):
    a, c = sets["a"], sets["c"]
    assert a["plain"] != c["plain"]
    assert [len(r) for r in a["reads"]] == [len(r) for r in c["reads"]]
    for ra, rc in zip(a["reads"], c["reads"]):
        assert (ra[:, 0] == rc[:, 0]).all()  # the same read starts


def test_port_seeds_give_the_port_makers_set(tmp_path):
    from pomfret_tpu_torch.testing import make_multichrom_multigap_scenario
    (tmp_path / "port").mkdir()
    bam, vcf, _ = make_multichrom_multigap_scenario(
        str(tmp_path / "port"), n_chroms=2, n_blocks=2,
        per_chrom=PARAMS["per_chrom"], read_stagger=700)
    mine = made(tmp_path / "mine", 0, chrom_seeds=[0, 1])
    with open(bam, "rb") as f:
        assert gzip.decompress(f.read()) == mine["plain"]
    assert gzip.open(vcf).read() == mine["vcf"]


def test_index_finds_every_regions_records(tmp_path):
    from pomfret_tpu_torch.io.bam import BamReader, bam_endpos
    made(tmp_path, 5)
    rd = BamReader(str(tmp_path / maker.BAM_NAME))
    every = list(rd.fetch_all())
    for chrom in rd.ref_names:
        for lo, hi in ((0, 1), (0, 50_000), (61_000, 95_000),
                       (100_000, 160_000)):
            got = [r.qname for r in rd.fetch(chrom, lo, hi)]
            want = [r.qname for r in every
                    if rd.ref_names[r.refID] == chrom and r.pos < hi
                    and bam_endpos(r) > lo]
            assert got == want and (want or lo == 0)
