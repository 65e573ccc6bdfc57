"""The tiny cell on the card, with the port's kernels and the device trace
(needs an NVIDIA GPU; skipped without one)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

CASES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "bench_cases.py")


@pytest.mark.cuda
def test_tiny_traced_cell_on_the_card(tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, CASES, "ont60x-methphase", str(2**33 + 9), "1",
         "none", str(tmp_path / "cache"), "cuda"], capture_output=True,
        text=True, timeout=1200, env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().split("\n")[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    m = res["metrics"]
    assert 0 < m["loop_kernel_roofline_pct"]["value"] < 100
    assert 0 < m["device_idle_pct"]["value"] < 100
