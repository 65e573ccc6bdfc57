"""methphase's other inputs, the port against the JAX package
(tests/test_cli_extra.py:38 and :58), on the cis two-block scenario:
- phase blocks from a GTF (the scenario's two blocks) instead of the VCF:
  .mp.gtf, .mp.tsv and the manifest's records;
- no -c: the read coverage estimated from the BAM (each run with a
  coverage cache of its own): .mp.vcf, .mp.gtf, .mp.tsv and the
  manifest's records.
Tolerance: exact (torch_parity_cases.py).
"""
import pytest
import torch

from torch_parity_cases import (PORT_ENGINES, assert_same, jax_side,
                                make_files, port_side, text)

torch.set_num_threads(1)

RUNS = ("gtf", "coverage")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return make_files(tmp_path_factory, "cis")


@pytest.fixture(scope="module")
def jax(files, tmp_path_factory):
    return {name: jax_side(name, files, tmp_path_factory) for name in RUNS}


@pytest.fixture(scope="module", params=PORT_ENGINES)
def port(request, files, tmp_path_factory):
    return {name: port_side(name, files, tmp_path_factory, request.param)
            for name in RUNS}


@pytest.mark.parametrize("name", RUNS)
def test_input_matches_jax(port, jax, name):
    assert_same(port[name], jax[name])
    assert text(port[name], ".mp.gtf").count("\n") == 1   # joined
