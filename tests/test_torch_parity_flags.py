"""The secondary methphase flags and checkpoint-resume, the port against
the JAX package (tests/test_flags.py:8, test_native_retag.py:39,
test_manifest.py:10 and :63), on the cis two-block scenario:
- `--output-tsv --dbg --write-bam`: .mp.vcf, .mp.gtf, .mp.tsv,
  .mp.dbg.read2tag and the manifest's records; the retagged .mp.bam (its
  HP tags read for read, and its bytes) and .mp.bai, by the native retag
  (the port's torch run, the JAX side) and the Python one (the port's
  host run);
- `--resume` from that run's manifest with a torn copy of its last line
  after it: no gap recomputed, the same outputs;
- load_manifest of a torn manifest.
Tolerance: exact (torch_parity_cases.py).
"""
import json

import pytest
import torch

from pomfret_tpu.utils.manifest import load_manifest as tpu_load_manifest
from pomfret_tpu_torch.utils.manifest import load_manifest
from torch_parity_cases import (PORT_ENGINES, assert_same, decisions,
                                jax_side, make_files, port_side, text)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return make_files(tmp_path_factory, "cis")


@pytest.fixture(scope="module")
def jax(files, tmp_path_factory):
    return jax_side("flags", files, tmp_path_factory)


@pytest.fixture(scope="module", params=PORT_ENGINES)
def port(request, files, tmp_path_factory):
    return port_side("flags", files, tmp_path_factory, request.param)


def test_dbg_and_tsv_match_jax(port, jax):
    assert_same(port, jax, (".mp.vcf", ".mp.gtf", ".mp.tsv",
                            ".mp.dbg.read2tag", "manifest"))
    assert text(port, ".mp.tsv").count("\n") == 1   # one joined block
    dbg = text(port, ".mp.dbg.read2tag").splitlines()
    assert len(dbg) > 100 and all(r.split("\t")[1] == "-1" for r in dbg)
    assert decisions(port) == {("chr1", 0): 0}


def test_write_bam_matches_jax(port, jax):
    assert_same(port, jax, ("hp.mp.bam", ".mp.bam", ".mp.bam.bai"))
    hp = port["outputs"][0]["hp.mp.bam"]
    assert len(hp) > 400 and {h for _, h in hp} == {1, 2}


def test_resume_skips_done_gaps(port, jax):
    assert port["resume_added"] == jax["resume_added"] == 0
    if port["engine"] == "torch":
        assert port["dispatches"] == 1   # the first run's, none on resume
    assert_same(port, jax, step=1)
    # and the resumed run wrote what the first one did
    full, resumed = port["outputs"]
    assert {k: v for k, v in full.items() if k != "manifest"} == \
        {k: v for k, v in resumed.items() if k != "manifest"}


def test_torn_manifest_matches_jax(tmp_path, port):
    p = str(tmp_path / "m.jsonl")
    with open(port["prefixes"][1] + ".mp.manifest.jsonl") as f:
        torn = f.read()
    assert not torn.endswith("\n")
    for lines in (torn, json.dumps({"ref": "c", "gap_i": 0, "start": 1,
                                    "end": 2, "decision": 0, "tags": {}})
                  + '\n{"ref": "c", "gap_i": 1, "start"'):
        with open(p, "w") as f:
            f.write(lines)
        got = load_manifest(p)
        assert got == tpu_load_manifest(p) and len(got) == 1
