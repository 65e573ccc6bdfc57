"""Two processes of the port (testing.run_processes: POMFRET_COORDINATOR,
POMFRET_NUM_PROCS, POMFRET_PROC_ID) on the two-block scenario, with the
flags of tests/test_multihost_e2e.py:
- `methphase --n-permutations 7`: process 0's .mp.vcf/.mp.gtf are
  byte-identical to one process of the port and to `pomfret-tpu methphase
  --engine host` (per-gap drand48 streams, PARITY.md X7);
- `report`: process 0's .report.tsv is byte-identical to one process of
  the port and to `pomfret-tpu report --engine host`.
No process loads jax or the JAX package. Tolerance: exact.
"""
import os

import pytest

from pomfret_tpu.cli import main as tpu_main
from pomfret_tpu_torch.cli import main as port_main
from pomfret_tpu_torch.testing import make_two_block_scenario, run_processes

ONE_THREAD = {"OMP_NUM_THREADS": "1"}  # processes share the test's cores


@pytest.fixture(scope="module")
def two_block(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("two_block"))
    bam, vcf, _ = make_two_block_scenario(d)
    return d, bam, vcf


def _same_files(p1, p2, exts):
    for ext in exts:
        with open(p1 + ext, "rb") as f1, open(p2 + ext, "rb") as f2:
            a = f1.read()
            assert a == f2.read(), ext
            assert a, ext


def _check_procs(outs, n_procs):
    assert len(outs) == n_procs
    for o in outs:
        assert o["rc"] == 0 and o["loaded"] == []


def test_two_process_permutation_voting(two_block):
    """Per-gap drand48 streams keyed by perm_key_base + i (PARITY.md X7):
    the same votes whichever process scores the gap."""
    d, bam, vcf = two_block
    args = ["-c", "50", "--n-permutations", "7", "--vcf", vcf, bam]
    ref = os.path.join(d, "perm_jax_host")
    assert tpu_main(["methphase", "-o", ref, "--engine", "host", *args]) == 0
    one = os.path.join(d, "perm_one")
    assert port_main(["methphase", "-o", one, "--engine", "torch",
                      *args]) == 0
    two = os.path.join(d, "perm_two")
    _check_procs(run_processes(["methphase", "-o", two, "--engine", "torch",
                                *args], 2, env=ONE_THREAD), 2)
    for p in (one, two):
        _same_files(p, ref, (".mp.vcf", ".mp.gtf"))


def test_two_process_report(two_block):
    d, bam, vcf = two_block
    args = ["-c", "50", "--chunk-size", "40000", "--chunk-stride", "30000",
            "--vcf", vcf, bam]
    ref = os.path.join(d, "rep_jax_host")
    assert tpu_main(["report", "-o", ref, "--engine", "host", *args]) == 0
    one = os.path.join(d, "rep_one")
    assert port_main(["report", "-o", one, "--engine", "torch", *args]) == 0
    two = os.path.join(d, "rep_two")
    outs = run_processes(["report", "-o", two, "--engine", "torch", *args],
                         2, env=ONE_THREAD)
    _check_procs(outs, 2)
    for o in outs:
        assert o["dist"]["n_allgathers"] == 1
    for p in (one, two):
        _same_files(p, ref, (".report.tsv",))
