"""Two chromosomes in one BAM, the port against the JAX package
(tests/test_two_chrom.py:9, test_native_retag.py:49,
test_manifest.py:36), `methphase -t 2 --write-bam`:
- .mp.vcf, .mp.gtf (chr2's blocks are placeholders the writer skips) and
  the manifest's records;
- the retagged .mp.bam across the chromosome change (its HP tags read
  for read, and its bytes) and .mp.bai, by the native retag (port torch,
  JAX) and the Python one (port host);
- --resume from that run's manifest without chr2's line: chr2's gap
  recomputed, one manifest line added, the same outputs.
Tolerance: exact (torch_parity_cases.py).
"""
import pytest
import torch

from torch_parity_cases import (PORT_ENGINES, assert_same, decisions,
                                jax_side, make_files, port_side, text)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return make_files(tmp_path_factory, "two_chrom")


@pytest.fixture(scope="module")
def jax(files, tmp_path_factory):
    return jax_side("two_chrom", files, tmp_path_factory)


@pytest.fixture(scope="module", params=PORT_ENGINES)
def port(request, files, tmp_path_factory):
    return port_side("two_chrom", files, tmp_path_factory, request.param)


def test_two_chromosomes_match_jax(port, jax):
    assert_same(port, jax, (".mp.vcf", ".mp.gtf", "manifest"))
    assert [ln.split("\t")[0] for ln in
            text(port, ".mp.gtf").splitlines()] == ["chr1"]
    assert decisions(port) == {("chr1", 0): 0, ("chr2", 0): 0}


def test_two_chromosome_write_bam_matches_jax(port, jax):
    assert_same(port, jax, ("hp.mp.bam", ".mp.bam", ".mp.bam.bai"))


def test_partial_resume_matches_jax(port, jax):
    assert port["resume_added"] == jax["resume_added"] == 1
    assert_same(port, jax, step=1)
    full, resumed = port["outputs"]
    assert full == resumed
