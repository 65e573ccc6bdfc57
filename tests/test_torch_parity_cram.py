"""CRAM input, the port against the JAX package (tests/test_cram.py:195
and :351), on the cis two-block scenario written as CRAM 3.0 with its
reference embedded, 200 records a slice (made once, by the port's
bam_to_cram):
- methphase on the CRAM: .mp.vcf, .mp.gtf, .mp.tsv and the manifest's
  records, equal to the JAX package's on the CRAM and to the port's on
  the BAM;
- varhaptag on the CRAM: .varhaptag.tsv, the retagged BAM and its .bai.
Tolerance: exact (torch_parity_cases.py).
"""
import pytest
import torch

from torch_parity_cases import (PORT_ENGINES, assert_same, jax_side,
                                make_files, port_side)

torch.set_num_threads(1)

VARHAPTAG = ("hp.vh.bam", ".vh.bam", ".vh.bam.bai", ".vh.bam.varhaptag.tsv")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return make_files(tmp_path_factory, "cram")


@pytest.fixture(scope="module")
def jax(files, tmp_path_factory):
    return jax_side("cram", files, tmp_path_factory)


@pytest.fixture(scope="module", params=PORT_ENGINES)
def port(request, files, tmp_path_factory):
    return port_side("cram", files, tmp_path_factory, request.param)


def test_methphase_on_cram_matches_jax(port, jax):
    assert_same(port, jax, (".mp.vcf", ".mp.gtf", ".mp.tsv", "manifest"))


def test_methphase_on_cram_equals_bam(files, port, tmp_path_factory):
    # the same run with the BAM in the CRAM's place
    on_bam = port_side("cram", dict(files, cram=files["bam"]),
                       tmp_path_factory, "torch")
    assert_same(port, on_bam, (".mp.vcf", ".mp.gtf", ".mp.tsv", "manifest"))


def test_varhaptag_on_cram_matches_jax(port, jax):
    assert_same(port, jax, VARHAPTAG)
    assert port["outputs"][0][".vh.bam.varhaptag.tsv"].count(b"\n") > 100
