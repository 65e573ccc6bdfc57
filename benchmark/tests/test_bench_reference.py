"""The plain reference (pbench/oracle.py) against the port, which it shares
no code with: on a tiny set its decisions, tags and written outputs are
those of the port's host route; its methmers are those of the port's
literal walk of blockjoin.c's sort buffer on grids with duplicate starts;
its Fisher test decides as the port's; and a gap whose right side carries
the other haplotype's tags comes out trans, its genotypes flipped."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from pbench import check, maker, oracle  # noqa: E402

CHROM = dict(read_stagger=700, cpg_every=100, read_len=20000, noise=0.02,
             nocall=0.02)
PARAMS = dict(n_chroms=2, n_blocks=3, block_len=60000, gap_len=30000,
              read_stagger=700, per_chrom=[dict(CHROM), dict(CHROM)])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("set")
    got = maker.make_set(PARAMS, 2**35 + 11, str(d), procs=2)
    maker.save_truth(str(d / maker.TRUTH_NAME), got["reads"], got["truth"])
    vcf = str(d / maker.VCF_NAME)
    reads = {n: oracle.Reads(n, t) for n, t in
             maker.load_truth(str(d / maker.TRUTH_NAME)).items()}
    ref_len, _ = maker.block_layout(3, 60000, 30000)
    wins = oracle.windows(vcf)
    covs = {n: oracle.coverage(r, ref_len) for n, r in reads.items()}
    dec = [oracle.decide(reads[c], s, e, covs[c]) for c, s, e in wins]
    return dict(dir=d, bam=str(d / maker.BAM_NAME), vcf=vcf, wins=wins,
                reads=reads, covs=covs, dec=dec)


def test_reference_is_the_ports_host_route(tiny, tmp_path):
    prefix = str(tmp_path / "host")
    env = dict(os.environ, POMFRET_SPOOL_DIR=str(tmp_path),
               PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "pomfret_tpu_torch.cli", "methphase", "-o",
         prefix, "--engine", "host", "--vcf", tiny["vcf"], tiny["bam"]],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(prefix + ".mp.manifest.jsonl") as f:
        man = [json.loads(line) for line in f if line.strip()]
    assert len(man) == len(tiny["wins"]) == 4
    for (c, s, e), m, got in zip(tiny["wins"], man, tiny["dec"]):
        assert (m["ref"], m["start"], m["end"]) == (c, s, e)
        assert got["decision"] == m["decision"] == 0
        assert got["tags"] == m["tags"] and len(got["tags"]) > 300
    ref = str(tmp_path / "ref")
    check.write_outputs(tiny["vcf"], tiny["wins"], tiny["dec"], ref)
    for ext in (".mp.vcf", ".mp.gtf"):
        with open(prefix + ext) as f, open(ref + ext) as g:
            assert f.read() == g.read()


def test_methmers_are_the_ports_literal_walk():
    from pomfret_tpu_torch.core.methmer import Methmers, _get_mmr_of_read_walk
    from pomfret_tpu_torch.core.readset import MmrConfig, Read
    rng = np.random.default_rng(7)
    for trial in range(400):
        n = int(rng.integers(1, 30))
        grid = np.sort(rng.integers(0, 60, n))
        if trial % 3 == 0:
            grid[:2] = grid[0]  # the index-0/1 duplicate (M3)
        lens = rng.integers(1, 4, n)
        m = int(rng.integers(1, 25))
        pos = np.unique(rng.integers(0, 70, m))
        cls = rng.integers(0, 3, len(pos))
        read = Read(i=0, qname="r", hp=0, strand=0, length=100, start_pos=0,
                    end_pos=100, calls=pos.astype(np.uint32),
                    quals=cls.astype(np.uint8))
        ms = Methmers(config=MmrConfig(), n=n,
                      sites_real_poss=grid.astype(np.uint32),
                      sites_starts=grid.astype(np.uint32),
                      mmr_lens=lens.astype(np.uint8))
        want, start = _get_mmr_of_read_walk(read, ms)
        got_start, got = oracle.methmers((pos, cls), grid, lens)
        if start == 0xFFFFFFFF:
            assert len(got) == 0
            continue
        want = want[:n - start]
        assert (got_start, got.tolist()) == (start, want), trial


def test_fisher_decides_as_the_ports():
    from pomfret_tpu_torch.core.fisher import kt_fisher_exact
    for a in range(0, 30, 3):
        for b in range(0, 8):
            for c in range(0, 8):
                for d in range(0, 30, 4):
                    want = kt_fisher_exact(a, b, c, d)[2]
                    got = oracle.fisher_two_sided(a, b, c, d)
                    assert got == pytest.approx(want, rel=1e-9, abs=1e-300)


def test_other_haplotype_right_of_a_gap_is_trans(tiny, tmp_path):
    c, s, e = tiny["wins"][0]
    r = tiny["reads"][c]
    swapped = oracle.Reads(c, dict(
        pos=r.pos, end=r.end, hap=np.where(r.pos > s, 1 - r.hap, r.hap),
        strand=r.reverse.astype(np.int8), draw=r.draw, sites=r.sites,
        call_n=r.call_n, ml=r.ml))
    got = oracle.decide(swapped, s, e, tiny["covs"][c])
    assert got["decision"] == 1
    dec = [got] + tiny["dec"][1:]
    out = str(tmp_path / "trans")
    check.write_outputs(tiny["vcf"], tiny["wins"], dec, out)
    with open(out + ".mp.vcf") as f:
        rows = [x.split("\t") for x in f.read().split("\n")
                if x and x[0] != "#" and x.startswith(c + "\t")]
    after = [x[9].split(":") for x in rows if s < int(x[1]) < tiny["wins"][1][1]]
    src = oracle.read_vcf(tiny["vcf"])[0]
    before = {int(x.split("\t")[1]): x.split("\t")[9].split(":")
              for x in src if x.startswith(c + "\t")}
    flipped = [x for x, y in zip(after, [before[int(r[1])] for r in rows
                                         if s < int(r[1]) < tiny["wins"][1][1]])
               if x[0] != y[0]]
    assert after and len(flipped) == len(after)


def test_bfloat16_rounds_as_bfloat16():
    assert oracle._bf16(1.0)[0] == 1.0
    assert oracle._bf16(100.3)[0] == 100.5
    assert oracle._bf16(1 / 3)[0] == pytest.approx(0.333984375)
    assert oracle.Arith("bfloat16").r(1 / 3)[0] == pytest.approx(0.333984375)
