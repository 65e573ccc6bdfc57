"""Shared by tests/test_torch_parity_*.py: a parity run of
pomfret_tpu_torch.testing.PARITY_RUNS through pomfret_tpu.cli and through
the port's CLI on the same scenario (made once per module), and the
byte-for-byte comparison of what they wrote.

The JAX side runs --engine jax where the JAX package's own test holds its
jax engine equal to its host engine on that behaviour (JAX_ENGINE names
the test; jax is the faster of the two here), else --engine host, as its
test runs it. The port side runs --engine torch (the plain loop on the
CPU; its BAMs retagged by the native library) and --engine host (its
BAMs retagged in Python, POMFRET_NO_NATIVE_RETAG=1), each held to the
JAX side; a run that writes a BAM there fails where the native library
is missing, which would leave the two port runs both retagging in
Python. Tolerance: none.
"""
from pomfret_tpu.cli import main as tpu_main
from pomfret_tpu_torch.cli import main as port_main
from pomfret_tpu_torch.io.native import native_available
from pomfret_tpu_torch.parallel.batch import DISPATCH_STATS
from pomfret_tpu_torch.testing import (PARITY_RUNS, PARITY_SCENARIOS,
                                       Spawned, parity_diffs,
                                       parity_outputs, parity_run,
                                       scenario_files)
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

PORT_ENGINES = ("torch", "host")

JAX_ENGINE = {
    "untagged": "jax",        # tests/test_cli_extra.py:84
    "perm3_bridge": "jax",    # tests/test_permutation.py:128
    "perm7_bridge": "jax",    # tests/test_permutation.py:163
    "perm11_bridge": "jax",   # tests/test_permutation.py:128
    "weird_hp": "jax",        # tests/test_review_regressions.py:24
    "messy": "jax",           # tests/test_realistic_reads.py:39
}


def make_files(tmp_path_factory, scenario):
    return PARITY_SCENARIOS[scenario](str(tmp_path_factory.mktemp(scenario)))


def make_all(tmp_path_factory, scenarios):
    """{scenario: its files}, the scenarios made at once, each in a
    process of its own."""
    procs = {s: Spawned(scenario_files, s, str(tmp_path_factory.mktemp(s)))
             for s in scenarios}
    return {s: p.result(timeout=600) for s, p in procs.items()}


def _side(main, name, files, tmp_path_factory, engine, **kw):
    d = tmp_path_factory.mktemp(f"{name}_{engine}")
    n0 = DISPATCH_STATS["n_dispatches"]
    out = parity_run(main, name, files, str(d / "out"), engine, **kw)
    out["engine"] = engine
    out["dispatches"] = DISPATCH_STATS["n_dispatches"] - n0
    out["lanes_last"] = DISPATCH_STATS["lanes_last"]
    out["outputs"] = [parity_outputs(p, name) for p in out["prefixes"]]
    return out


def jax_side(name, files, tmp_path_factory):
    """The run through pomfret_tpu.cli."""
    return _side(tpu_main, name, files, tmp_path_factory,
                 JAX_ENGINE.get(name, "host"))


def port_side(name, files, tmp_path_factory, engine):
    """The run through the port's CLI with --engine `engine`."""
    run = PARITY_RUNS[name]
    if engine != "host" and (run.varhaptag
                             or any(e.endswith(".bam") for e in run.exts)):
        assert native_available(), "the native retag library is missing"
    return _side(port_main, name, files, tmp_path_factory, engine,
                 native_retag=engine != "host")


def assert_same(port, jax, keys=None, step=0):
    """The outputs of one step (0: the run, 1: its resume) are equal,
    byte for byte, and not empty; `keys` limits the comparison."""
    a, b = port["outputs"][step], jax["outputs"][step]
    keys = sorted(a) if keys is None else keys
    assert sorted(a) == sorted(b)
    diff = [k for k in parity_diffs(a, b) if k in keys]
    assert not diff, f"differ from the JAX package's: {diff}"


def decisions(side, step=0):
    """{(ref, gap_i): decision} of a step's manifest."""
    return {k: e["decision"]
            for k, e in side["outputs"][step]["manifest"].items()}


def text(side, ext, step=0):
    return side["outputs"][step][ext].decode()

