"""An untagged BAM, the port against the JAX package
(tests/test_flags.py:24, test_cli_extra.py:84, test_pipeline_e2e.py:125,
test_native_retag.py:44), on the untagged cis two-block scenario:
`methphase -u -U --write-bam` (varhaptag's tags seed the gap engine):
- .mp.input_haptag.tsv;
- .mp.vcf, .mp.gtf and the manifest's records, the port's torch and host
  engines both;
- the retagged .mp.bam (HP appended; its HP tags read for read, and its
  bytes) and .mp.bai, by the native retag (port torch, JAX) and the
  Python one (port host).
Tolerance: exact (torch_parity_cases.py).
"""
import pytest
import torch

from torch_parity_cases import (PORT_ENGINES, assert_same, jax_side,
                                make_files, port_side, text)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return make_files(tmp_path_factory, "untagged")


@pytest.fixture(scope="module")
def jax(files, tmp_path_factory):
    return jax_side("untagged", files, tmp_path_factory)


@pytest.fixture(scope="module", params=PORT_ENGINES)
def port(request, files, tmp_path_factory):
    return port_side("untagged", files, tmp_path_factory, request.param)


def test_input_tagging_matches_jax(port, jax):
    assert_same(port, jax, (".mp.input_haptag.tsv",))
    rows = text(port, ".mp.input_haptag.tsv").splitlines()
    assert rows[0].startswith("#qname") and len(rows) > 100
    assert all(r.split("\t")[1] == "255" for r in rows[1:])


def test_untagged_methphase_matches_jax(port, jax):
    assert_same(port, jax, (".mp.vcf", ".mp.gtf", "manifest"))
    assert text(port, ".mp.gtf").count("\n") == 1   # joined


def test_untagged_write_bam_matches_jax(port, jax):
    assert_same(port, jax, ("hp.mp.bam", ".mp.bam", ".mp.bam.bai"))
