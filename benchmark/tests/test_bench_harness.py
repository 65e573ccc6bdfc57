"""The harness end to end on the CPU at a tiny size: one run prints one
contract line with `correct` true; with a fault planted in the port
underneath, the same run comes out not correct."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

CASES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "bench_cases.py")
CELLS = ("ont60x-methphase", "ont30x-methphase")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)


def metrics_of(cell, kind):
    return {m["name"] for m in SPEC[kind] if cell in m.get("workloads",
                                                           [cell])}


def run_tiny(tmp_path, cell, fault="none", trace=0, seed=2**33 + 7):
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, CASES, cell, str(seed), str(trace), fault,
         str(tmp_path / "cache")], capture_output=True, text=True,
        timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    last = out.stdout.strip().split("\n")[-1]
    return json.loads(last), out.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_one_contract_line(tmp_path, cell):
    res, err = run_tiny(tmp_path, cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"]
    assert list(res)[-1] == "check"
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["metrics"]) == metrics_of(cell, "end_to_end")
    assert {"peak_rss_mib", "setup_s"} <= set(res["metrics"])
    assert all(m["value"] > 0 for m in res["metrics"].values())
    for name, v in res["check"].items():
        assert v["value"] <= v["limit"]
        assert f"{name} {v['value']} limit {v['limit']}" in err
    # the benchmark's count of window reads is the port's
    line = next(x for x in err.split("\n") if "the port counted" in x
                and "window:" in x)
    got = line.split("the port counted ")[1].split(" ")[0]
    assert got == line.split("the benchmark ")[1].strip()


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_prints_per_layer_metrics(tmp_path, cell):
    res, _ = run_tiny(tmp_path, cell, trace=1)
    assert res["correct"] is True
    want = metrics_of(cell, "per_layer") - {"device_idle_pct",
                                            "loop_kernel_roofline_pct"}
    assert want and set(res["metrics"]) == want
    # no device on the CPU: nothing read for the device's metrics
    assert "device_idle_pct" not in res["metrics"]
    assert "loop_kernel_roofline_pct" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert len(res["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("cell,fault", [
    ("ont60x-methphase", "answer"), ("ont60x-methphase", "tag"),
    ("ont60x-methphase", "half"), ("ont60x-methphase", "unchanged")])
def test_planted_fault_is_not_correct(tmp_path, cell, fault):
    res, _ = run_tiny(tmp_path, cell, fault=fault)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values())
