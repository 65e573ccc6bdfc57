"""Reads the synthetic scenarios do not make by default, the port against
the JAX package, each built as the JAX test builds it (pomfret_tpu_torch.
testing.make_weird_hp_scenario, make_messy_scenario):
- absurd HP values (HP:i:5 on one read start in 7) seed no count table
  (tests/test_review_regressions.py:24);
- soft clips and CpG-neutral indels on both strands, 3% noise
  (tests/test_realistic_reads.py:39 and :63): the join found, and
  varhaptag's tags through the clips and indels;
methphase's .mp.vcf, .mp.gtf, .mp.tsv and the manifest's records (its
per-read tags), the port's torch and host engines both; varhaptag's
.varhaptag.tsv, retagged BAM and .bai.
Tolerance: exact (torch_parity_cases.py).
"""
import pytest
import torch

from torch_parity_cases import (PORT_ENGINES, assert_same, decisions,
                                jax_side, make_files, port_side)

torch.set_num_threads(1)

RUNS = ("weird_hp", "messy")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return {name: make_files(tmp_path_factory, name) for name in RUNS}


@pytest.fixture(scope="module")
def jax(files, tmp_path_factory):
    return {name: jax_side(name, files[name], tmp_path_factory)
            for name in RUNS}


@pytest.fixture(scope="module", params=PORT_ENGINES)
def port(request, files, tmp_path_factory):
    return {name: port_side(name, files[name], tmp_path_factory,
                            request.param) for name in RUNS}


@pytest.mark.parametrize("name", RUNS)
def test_methphase_matches_jax(port, jax, name):
    assert_same(port[name], jax[name], (".mp.vcf", ".mp.gtf", ".mp.tsv",
                                        "manifest"))
    assert decisions(port[name]) == {("chr1", 0): 0}   # cis join


def test_messy_varhaptag_matches_jax(port, jax):
    assert_same(port["messy"], jax["messy"],
                ("hp.vh.bam", ".vh.bam", ".vh.bam.bai",
                 ".vh.bam.varhaptag.tsv"))
    rows = [r.split("\t") for r in port["messy"]["outputs"][0][
        ".vh.bam.varhaptag.tsv"].decode().splitlines()[1:]]
    tagged = [(q, int(new)) for q, _, new in rows if new in ("1", "2")]
    assert len(tagged) > 0.7 * len(rows)
    assert all(hp - 1 == int(q.split("_")[1]) for q, hp in tagged)
