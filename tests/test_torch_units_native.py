"""The port's native IO library against its Python routes, and those
against the JAX package's (tests/test_native.py, test_window_native.py,
test_coverage.py and the spool and rANS cases of test_cram.py):
- every entry of testing.NATIVE_CHECKS: the port's native route against
  the port's Python route on the same inputs (the check raises on the
  first difference), then the port's Python route's result against the
  JAX package's Python route's on the same inputs (NATIVE_CHECKS[name]
  (work, JAX modules) runs that route alone, its CLI runs on every
  Python route that has a switch, testing.PYTHON_ROUTES; BGZF has none
  and inflates natively where the JAX package's library loaded and in
  Python where it did not, so no case depends on that library's build);
- the library's plain-zlib build, the second rung of the link ladder and
  the one a host without libdeflate (the card's) loads: in a process of
  its own, built into a directory of its own, every NATIVE_CHECKS entry
  and the parity suite's `flags` run (methphase --engine torch --output-tsv
  --dbg --write-bam, then --resume), whose outputs must equal those of
  this process's build, the libdeflate rung.
The scenarios (cis, untagged, cram) are made once, at once, in processes
of their own; the zlib build's process runs while the cases run.
Tolerance: exact.
"""
import json
import os
import subprocess
import sys
import types

import pytest
import torch

import pomfret_tpu_torch.io.native as native
from pomfret_tpu_torch.cli import main as port_main
from pomfret_tpu_torch.testing import (NATIVE_CHECKS, Spawned,
                                       first_difference, parity_diffs,
                                       parity_outputs, parity_run,
                                       scenario_files)
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = ("cis", "untagged", "cram")

_ZLIB = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
import pomfret_tpu_torch.io.native as native
native.BUILD_DIR = sys.argv[1]
native._LINK_LADDER = ([],)
from pomfret_tpu_torch.cli import main
from pomfret_tpu_torch.testing import parity_run, run_native_checks, scenario_files
work, prefix = sys.argv[2], sys.argv[3]
lib = native.get_lib()
assert lib is not None, "the zlib build did not load"
secs = run_native_checks(work)
parity_run(main, "flags", scenario_files("cis", os.path.join(work, "cis")),
           prefix, "torch")
print("ZLIB", json.dumps({"lib": lib._name, "seconds": secs}))
"""


def jax_modules():
    """testing.port_modules()'s names bound to the JAX package's modules;
    its CLI runs --engine host. native None: the checks run only the
    Python routes, the CLI runs under testing.PYTHON_ROUTES."""
    from pomfret_tpu import pipeline
    from pomfret_tpu.cli import main
    from pomfret_tpu.core import methmer, readset, varhaptag, variants
    from pomfret_tpu.core.intervals import Storage
    from pomfret_tpu.io import (bam, bam_writer, basemod, bgzf, cram,
                                cram_writer, intervals_loader, rans4x8,
                                records)
    from pomfret_tpu.kernels.engine_jax import _grid_from_arrays
    return types.SimpleNamespace(
        bam=bam, bam_writer=bam_writer, basemod=basemod, bgzf=bgzf,
        cram=cram, cram_writer=cram_writer,
        intervals_loader=intervals_loader, native=None, rans4x8=rans4x8,
        records=records, methmer=methmer, readset=readset,
        varhaptag=varhaptag, variants=variants, Storage=Storage,
        pipeline=pipeline, grid_from_arrays=_grid_from_arrays,
        cli_main=main, engine="host")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("native_checks"))
    procs = [Spawned(scenario_files, s, os.path.join(d, s))
             for s in SCENARIOS]
    for p in procs:
        p.result(timeout=600)
    return d


@pytest.fixture(scope="module")
def zlib_run(work, tmp_path_factory):
    """The zlib build's process, started before the first case."""
    d = tmp_path_factory.mktemp("zlib")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-c", _ZLIB, str(d / "build"), work,
         str(d / "out")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, str(d / "out")
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_mods():
    return jax_modules()


@pytest.mark.parametrize("name", list(NATIVE_CHECKS))
def test_native_route_matches_python(work, zlib_run, jax_mods, name):
    got = NATIVE_CHECKS[name](work)
    want = NATIVE_CHECKS[name](work, jax_mods)
    assert got == want, ("the port's Python route differs from the JAX "
                         "package's at " + first_difference(want, got))


def test_zlib_build_matches_default(work, zlib_run, tmp_path):
    # this host's default is the libdeflate rung: the two builds differ
    assert native.get_lib()._name == native.library_path(
        native._LINK_LADDER[0])
    assert native._LINK_LADDER[0] != []
    prefix = str(tmp_path / "out")
    parity_run(port_main, "flags",
               scenario_files("cis", os.path.join(work, "cis")), prefix,
               "torch")
    proc, zprefix = zlib_run
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    got = json.loads(next(ln for ln in out.splitlines()
                          if ln.startswith("ZLIB "))[5:])
    assert os.path.basename(got["lib"]) == os.path.basename(
        native.library_path([]))
    assert sorted(got["seconds"]) == sorted(NATIVE_CHECKS)
    for p, q in ((prefix, zprefix), (prefix + "_resumed",
                                     zprefix + "_resumed")):
        a, b = parity_outputs(p, "flags"), parity_outputs(q, "flags")
        assert not parity_diffs(a, b), parity_diffs(a, b)
