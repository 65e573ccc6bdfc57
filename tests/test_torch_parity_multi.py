"""Many blocks, the port against the JAX package
(tests/test_multiblock.py:8 and :45, test_manifest.py:63):
- 3 blocks, every gap joined cis and PS unified; then --resume from its
  manifest with only the first half of its last line (a run killed while
  it wrote it): that gap recomputed and its line appended to the
  fragment, the same outputs and manifest bytes as the JAX package's;
- 1 chromosome of 3 blocks with hap-swapped labels on odd blocks, every
  gap decided trans;
.mp.vcf, .mp.gtf, .mp.tsv and the manifest's records, the port's torch
and host engines both.
Tolerance: exact (torch_parity_cases.py).
"""
import pytest
import torch

from torch_parity_cases import (PORT_ENGINES, assert_same, decisions,
                                jax_side, make_files, port_side)

torch.set_num_threads(1)

RUNS = {"multi_block": 0, "trans_alternate": 1}   # every gap's decision


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


@pytest.mark.parametrize("name", sorted(RUNS))
def test_blocks_match_jax(port, jax, name):
    assert_same(port[name], jax[name])
    dec = decisions(port[name])
    assert len(dec) == 2 and set(dec.values()) == {RUNS[name]}


def test_torn_resume_matches_jax(port, jax):
    port, jax = port["multi_block"], jax["multi_block"]
    assert port["resume_added"] == jax["resume_added"] == 1
    assert_same(port, jax, step=1)
    full, resumed = port["outputs"]
    assert {k: v for k, v in full.items() if k != "manifest"} == \
        {k: v for k, v in resumed.items() if k != "manifest"}
    # both glue the recomputed line onto the fragment, so the manifest
    # loads without that gap (ROADMAP queue 3 item 14)
    man = [open(p + "_resumed.mp.manifest.jsonl", "rb").read()
           for p in (port["prefixes"][0], jax["prefixes"][0])]
    assert man[0] == man[1] and man[0].count(b"\n") == 2
    assert len(resumed["manifest"]) == len(full["manifest"]) - 1
