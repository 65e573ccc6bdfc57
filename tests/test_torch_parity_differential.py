"""The scenarios of tests/test_differential.py that no other parity run
reaches, the port against the JAX package (pomfret_tpu.cli --engine
host, as that file runs it against the reference binary), each on its
scenario of testing.PARITY_SCENARIOS:
- recovery (:122): 4 blocks of 32 kb, 20 kb apart, `-c 50 --write-bam`:
  the gaps merge into one, the middle blocks become dropped slivers and
  core/recovery.py re-phases their variants; .mp.vcf, .mp.gtf, the
  manifest's records, the retagged .mp.bam (its HP tags read for read,
  and its bytes) and .mp.bai; the .mp.vcf holds dropped-sliver rewrites
  and the manifest one merged gap;
- tsv_override (:215): an untagged BAM, `-c 50 -u --tsv T --gtf G
  --vcf V`: the blocks come from the TSV, the variants from the VCF;
- noisy_estimator (:98): noise and no-calls at 0.06, no -c: the
  whole-BAM coverage estimator sets the parameters;
- untagged_dbg (:229): an untagged BAM, `-c 50 -u -U --dbg`: also
  .mp.input_haptag.tsv and .mp.dbg.read2tag.
The port's torch and host engines both. Tolerance: exact
(torch_parity_cases.py).
"""
import pytest
import torch

from pomfret_tpu_torch.testing import dropped_sliver_rewrites
from torch_parity_cases import (PORT_ENGINES, assert_same, decisions,
                                jax_side, make_all, port_side, text)

torch.set_num_threads(1)

RUNS = ("recovery", "tsv_override", "noisy_estimator", "untagged_dbg")
SCENARIO = {"recovery": "recovery", "tsv_override": "untagged",
            "noisy_estimator": "noisy", "untagged_dbg": "untagged"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return make_all(tmp_path_factory, sorted(set(SCENARIO.values())))


@pytest.fixture(scope="module")
def jax(files, tmp_path_factory):
    return {n: jax_side(n, files[SCENARIO[n]], tmp_path_factory)
            for n in RUNS}


@pytest.fixture(scope="module", params=PORT_ENGINES)
def port(request, files, tmp_path_factory):
    return {n: port_side(n, files[SCENARIO[n]], tmp_path_factory,
                         request.param) for n in RUNS}


@pytest.mark.parametrize("name", RUNS)
def test_outputs_match_jax(port, jax, name):
    assert_same(port[name], jax[name])


def test_recovery_rephases_dropped_slivers(port):
    p = port["recovery"]
    assert dropped_sliver_rewrites(p["outputs"][0][".mp.vcf"]) > 0
    # one gap: the three merged into one across the slivers
    (key, rec), = p["outputs"][0]["manifest"].items()
    assert rec["end"] - rec["start"] > 100_000
    hp = p["outputs"][0]["hp.mp.bam"]
    assert len(hp) > 400 and {h for _, h in hp} >= {1, 2}


def test_tsv_blocks_take_precedence(port):
    # the TSV's two blocks (not the VCF's PS groups): one gap, joined
    assert decisions(port["tsv_override"]) == {("chr1", 0): 0}
    assert text(port["tsv_override"], ".mp.gtf").count("\n") == 1


def test_untagged_dbg_dumps(port):
    p = port["untagged_dbg"]
    rows = text(p, ".mp.input_haptag.tsv").splitlines()
    assert rows[0].startswith("#qname") and len(rows) > 100
    dbg = text(p, ".mp.dbg.read2tag").splitlines()
    assert len(dbg) > 100
