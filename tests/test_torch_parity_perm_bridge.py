"""Permutation voting where the vote decides, the port against the JAX
package (tests/test_permutation.py:128 at n 3 and 11, :163 at n 7, and
:114, the CLI flag), on the trans two-block scenario of :163 at 5% noise
and no-calls (seed 13) with the gap's methylation wiped from 84 kb to
its end: on that weak bridge the permutation runs disagree, and
--n-permutations 3 (best score) joins the gap where 7 and 11 (the
majority rule) leave it unjoined. On the JAX tests' own permutation
scenarios every n writes what one run writes, so they are not run. .mp.vcf, .mp.gtf
and the manifest's records (its per-read tags), the port's torch and host
engines both; the torch run in one grouped dispatch of every
permutation's lanes.
Tolerance: exact (torch_parity_cases.py).
"""
import pytest
import torch

from torch_parity_cases import (PORT_ENGINES, assert_same, decisions,
                                jax_side, make_files, port_side)

torch.set_num_threads(1)

RUNS = {"perm3_bridge": 3, "perm7_bridge": 7, "perm11_bridge": 11}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return make_files(tmp_path_factory, "perm_bridge")


@pytest.fixture(scope="module")
def jax(files, tmp_path_factory):
    return {name: jax_side(name, files, tmp_path_factory) for name in RUNS}


@pytest.fixture(scope="module", params=PORT_ENGINES)
def port(request, files, tmp_path_factory):
    return {name: port_side(name, files, tmp_path_factory, request.param)
            for name in RUNS}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_permutation_vote_matches_jax(port, jax, name):
    assert_same(port[name], jax[name])
    if port[name]["engine"] == "torch":
        assert port[name]["dispatches"] == 1
        assert port[name]["lanes_last"] >= 2 * RUNS[name]


def test_vote_decides(port):
    # the same gap, joined at 3 and not at 7 or 11
    assert decisions(port["perm3_bridge"]) == {("chr1", 0): 0}
    assert decisions(port["perm7_bridge"]) == {("chr1", 0): -1}
    assert decisions(port["perm11_bridge"]) == {("chr1", 0): -1}
