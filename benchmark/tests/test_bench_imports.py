"""Nothing that the harness or its reference imports is JAX or the JAX
package, compared by the whole top-level name: pomfret_tpu_torch, the
port, begins with pomfret_tpu and is not it."""
from __future__ import annotations

import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

import run  # noqa: E402


def test_forbidden_names_are_whole_top_level_names():
    mods = ["pomfret_tpu_torch", "pomfret_tpu_torch.cli", "jaxtyping",
            "flaxen", "torch"]
    assert run.forbidden_loaded(mods) == []
    assert run.forbidden_loaded(mods + ["pomfret_tpu.cli"]) == \
        ["pomfret_tpu"]
    assert run.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]


def test_harness_reference_and_port_import_no_jax():
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "import run, control\n"
        "from pbench import check, devtrace, host, maker, oracle, "
        "ranks, roofline, rss\n"
        "import pomref.io.bam_writer, pomref.io.records\n"
        "import pomfret_tpu_torch.cli, pomfret_tpu_torch.pipeline\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))"
        % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-3000:]
    names = json.loads(out.stdout.strip().split("\n")[-1])
    assert "pomfret_tpu_torch" in names
    assert run.forbidden_loaded(names) == []


def test_reference_imports_nothing_of_the_port():
    code = (
        "import sys, json; sys.path[:0] = [%r]\n"
        "from pbench import check, maker, oracle\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))"
        % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH)
    assert out.returncode == 0, out.stderr[-3000:]
    names = json.loads(out.stdout.strip().split("\n")[-1])
    assert "pomfret_tpu_torch" not in names and "torch" not in names
