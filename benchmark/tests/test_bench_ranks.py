"""A cell run as a gloo group of several ranks on one host (the
configuration's `procs`), on the CPU at bench_cases.py's tiny size: the
harness starts the ranks, runs the warm pass and the window as passes of
the group and sums what each rank measured; a rank that exits or hangs
ends the run with no process left; with no `procs` the contract line is
today's."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = os.path.join(HERE, "bench_cases.py")
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)

from bench_cases import DEADLINE_S  # noqa: E402
from pbench import ranks  # noqa: E402

CELL = "ont60x-methphase"
ROOT = os.path.dirname(BENCH)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)


def run_case(tmp_path, *, fault="none", trace=0, procs=None,
             seed=2**33 + 11):
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    argv = [sys.executable, CASES, CELL, str(seed), str(trace), fault,
            str(tmp_path / "cache")]
    if procs is not None:
        argv.append(f"procs={procs}")
    t = time.monotonic()
    out = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                         env=env)
    return out, time.monotonic() - t


def result(out):
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().split("\n")
    assert len(lines) == 1, out.stdout[-2000:]
    return json.loads(lines[0])


def logged(err, prefix):
    """The JSON logged after `prefix` on each line that starts with it."""
    return [json.loads(x.split(prefix, 1)[1]) for x in err.split("\n")
            if x.startswith(prefix)]


def rank_pids(err):
    return [int(m) for m in re.findall(r"rank \d+ of \d+ started: pid (\d+)",
                                       err)]


def alive_in_group(pgid):
    """Processes (not zombies) whose process group is `pgid`."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            out.append(int(pid))
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out, _ = run_case(tmp_path_factory.mktemp("p2"), procs=2)
    return result(out), out.stderr


def test_two_ranks_print_one_contract_line(two_ranks):
    res, err = two_ranks
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert set(res["metrics"]) == {m["name"] for m in SPEC["end_to_end"]
                                   if CELL in m.get("workloads", [CELL])}
    for name, v in res["check"].items():
        assert f"{name} {v['value']} limit {v['limit']}" in err
    # one group: rank 1 started, the warm pass and every window pass run
    # by both ranks, each gap decided by one of them
    assert len(rank_pids(err)) == 1 and "group of 2 ranks: warm pass" in err
    by_rank = {r: logged(err, f"[bench] rank {r}: ")[0] for r in (0, 1)}
    for r in by_rank.values():
        assert len(r["walls"]) == res["attempted"] and r["window_reads"] > 0
        assert r["dist"]["n_allgathers"] == 2 * res["attempted"]
    line = next(x for x in err.split("\n") if "window:" in x)
    assert line.split("the port counted ")[1].split(" ")[0] == \
        line.split("the benchmark ")[1].strip()


def test_two_ranks_peak_is_the_sum_of_their_peaks(two_ranks):
    res, err = two_ranks
    peaks = [logged(err, f"[bench] rank {r}: ")[0]["peak_rss_mib"]
             for r in (0, 1)]
    assert all(p > 0 for p in peaks)
    assert res["metrics"]["peak_rss_mib"]["value"] == peaks[0] + peaks[1]
    assert res["device"]["memory_peak_bytes"] == 0  # no card


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP queue 3, item 9: every rank opens <prefix>.mp.manifest.jsonl "
    "with 'w' and writes its own gaps' records over the others', so the "
    "check finds gaps missing from the manifest; the port's fix removes "
    "this mark"))
def test_two_ranks_write_correct_outputs(two_ranks):
    res, _ = two_ranks
    assert res["correct"] is True


def test_two_ranks_traced_record_holds_both(tmp_path):
    out, _ = run_case(tmp_path, procs=2, trace=1)
    res = result(out)
    line = next(x for x in out.stderr.split("\n")
                if x.startswith("[bench] busy_s by rank: "))
    own, union = line.split(": ", 1)[1].split("; union ")
    own = [float(x) for x in own.split()]
    assert len(own) == 2 and float(union) >= max(own)
    assert res["device"]["busy_s"] == float(union)
    assert "idle_gaps by rank 0's stage events" in out.stderr
    want = {m["name"] for m in SPEC["per_layer"]
            if CELL in m.get("workloads", [CELL])}
    assert set(res["metrics"]) == want - {"device_idle_pct",
                                          "loop_kernel_roofline_pct"}


def test_union_of_the_ranks_device_time():
    every = [dict(rank=0, intervals=[(1.0, 2.0, "loop_kernel_a"),
                                     (5.0, 6.0, "copy")],
                  loop_kernel=dict(launches=2, bytes=100, device_s=1.0)),
             dict(rank=1, intervals=[[1.5, 3.0, "loop_kernel_a"],
                                     [9.0, 12.0, "copy"]],
                  loop_kernel=dict(launches=3, bytes=50, device_s=1.5),
                  modules=["torch"])]
    ivs, busy, loop, by_rank = ranks.union(every, 0.0, 10.0)
    assert len(ivs) == 4
    assert busy == pytest.approx(2.0 + 1.0 + 1.0)  # [1, 3], [5, 6], [9, 10]
    assert [r["busy_s"] for r in by_rank] == pytest.approx([2.0, 2.5])
    assert loop == dict(launches=5, bytes=150, device_s=2.5)
    assert all("intervals" not in r and "modules" not in r for r in by_rank)


@pytest.mark.parametrize("fault,why", [("rank_exit", "rank 1 exited"),
                                       ("rank_hang", "deadline")])
def test_a_failed_rank_ends_the_run_with_no_process_left(tmp_path, fault,
                                                          why):
    out, took = run_case(tmp_path, procs=2, fault=fault)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "the group failed: pass p0" in out.stderr and why in out.stderr
    assert "rank 1's port log ends" in out.stderr
    # set-up, a warm pass and, for the hang, one deadline: well inside the
    # harness's own deadline of 300 s
    assert took < (DEADLINE_S if fault == "rank_hang" else 0) + 200
    pids = rank_pids(out.stderr)
    assert len(pids) == 1
    assert alive_in_group(pids[0]) == []
    assert not os.path.exists(f"/proc/{pids[0]}")


def test_one_rank_prints_todays_keys(tmp_path):
    out, _ = run_case(tmp_path)
    res = result(out)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert list(res["device"]) == ["platform", "kind", "count",
                                   "memory_peak_bytes"]
    assert res["correct"] is True
    assert "rank 1" not in out.stderr and "group of" not in out.stderr
