"""The port's accuracy tool (python -m pomfret_tpu_torch.tools.
accuracy_scale) on the CPU, on small sets:
- --noise at one level on the dense chromosome cut to 3 blocks (--engine
  torch --device cpu): its row's correct/switch/fail equal a direct count
  of the .report.tsv it keeps, its packed batches are the dense buckets,
  and the JAX engine's record (the root ACCURACY_SCALE.json) keeps its
  bytes and mtime; the tool refuses to write that file;
- --trans at BENCH_SCALE=1 cut to 3 blocks: the port decides each gap as
  the JAX tool's logic (tools/accuracy_scale.py main_trans: the JAX
  package's run_jobs_batched on coverage-derived jobs) does, and the
  tool's row tallies those decisions;
- testing.Spawned, which runs each row in a process of its own, returns
  the child's value and raises what it raised, and a row's peak RSS is
  its own process's, not its parent's: VmHWM, or where the status file
  has none, ru_maxrss in a Spawned child and no peak at all in a process
  that may carry its parent's.
Each row runs in a spawned process of its own, with one thread and
glibc's default heap thresholds (the environment below).
Tolerance: exact.
"""
import json
import os

import pytest
import torch

from pomfret_tpu_torch import testing
from pomfret_tpu_torch.tools import accuracy_scale as tool
from torch_accuracy_cases import REPO, jax_tool

torch.set_num_threads(1)
RECORD = os.path.join(REPO, "ACCURACY_SCALE.json")


def _cpu(tmp_path, monkeypatch, *argv):
    monkeypatch.setenv("POMFRET_NO_MESH", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # utils/malloc_tune.py's 1 GiB thresholds would let the plain loop's
    # temporaries fragment the child's heap (torch_accuracy_cases.
    # heap_returned)
    monkeypatch.setenv("POMFRET_NO_MALLOC_TUNE", "1")
    out = tmp_path / "acc.json"
    rc = tool.main([*argv, "--blocks", "3", "--engine", "torch", "--device",
                    "cpu", "--data-root", str(tmp_path), "--out", str(out)])
    assert rc == 0
    with open(out) as f:
        return json.load(f)


def test_noise_row_counts_its_report(tmp_path, monkeypatch):
    with open(RECORD, "rb") as f:
        before = (os.stat(RECORD).st_mtime_ns, f.read())
    got = _cpu(tmp_path, monkeypatch, "--noise", "--levels", "0.05")
    (row,) = got["noise_ramp_dense"]["rows"]
    with open(row["report_tsv"]) as f:
        verdicts = [line.rstrip("\n").split("\t")[3] for line in f]
    assert {k: row[k] for k in ("correct", "switch", "fail")} == {
        k: verdicts.count(k) for k in ("correct", "switch", "fail")}
    assert row["windows"] == len(verdicts) >= 4
    assert (row["noise"], row["n_blocks"], row["engine"], row["device"],
            row["card"]) == (0.05, 3, "torch", "cpu", None)
    assert row["window_reads"] > 0 and row["peak_rss_mib"] > 0
    assert [(s["R"], s["S"], s["D"], s["nc_cap"])
            for s in row["packed_shapes"]] == [(2048, 1536, 32, 64)]
    assert row["loop_kernel"]["launches"] == 0     # the plain loop ran
    with open(RECORD, "rb") as f:
        assert (os.stat(RECORD).st_mtime_ns, f.read()) == before
    with pytest.raises(ValueError):
        tool.merge_out(RECORD, {})


def test_trans_decides_as_the_jax_tool(tmp_path, monkeypatch):
    from pomfret_tpu.core.readset import MmrConfig
    from pomfret_tpu.kernels.engine_jax import run_jobs_batched as jax_run
    from pomfret_tpu.pipeline import (_derive_chrom_params,
                                      estimate_read_coverage_cached)

    row = _cpu(tmp_path, monkeypatch, "--trans", "--scale", "1")[
        "trans_sweep"]
    params = dict(testing.trans_params(1), n_blocks=3)
    bam, vcf, n_gaps, _ = testing.cached_dataset(
        str(tmp_path), params, "scale_trans.bam", trans_alternate=True)
    # main_trans's jobs and decisions, through the JAX package
    jbam, jst = jax_tool()._load_gap_storage(bam, vcf)
    name2cov = estimate_read_coverage_cached(bam, 2)
    jobs = []
    for job_i, rg in enumerate(jst.ranges):
        ref_name = jst.ref_names[job_i]
        cfg, n_cand = _derive_chrom_params(
            MmrConfig(), 14, name2cov.get(ref_name, 0), ref_name)
        jobs.append(dict(ref_name=ref_name, rg=rg, cfg=cfg, n_cand=n_cand,
                         indices=list(range(len(rg.starts))),
                         perm_key_base=job_i * 1_000_003))
    ref = [dec for dec, _ in jax_run(jst, jbam, jobs)]
    # the port's, gap by gap
    _, st = tool.load_gap_storage(bam, vcf)
    got = tool.decide_gaps(st, tool.load_gap_storage(bam, vcf)[0],
                           tool.gap_jobs(bam, st), "torch",
                           torch.device("cpu"))
    assert got == ref
    tot, per_chrom = tool.trans_tally(jobs, ref)
    assert row["per_chrom"] == per_chrom
    assert (row["gaps"], row["decided_trans_correct"],
            row["decided_cis_switch_errors"], row["fail"]) == (
        n_gaps, tot["trans"], tot["cis_switch"], tot["fail"])
    assert tot["trans"] > 0 and tot["cis_switch"] == 0


def test_spawned_returns_and_raises():
    """testing.Spawned, which runs the tool's rows: the child's return
    value comes back; what it raised comes back as a RuntimeError with
    the child's traceback."""
    assert testing.Spawned(max, 3, 7).result(timeout=120) == 7
    failing = testing.Spawned(int, "not a number")
    with pytest.raises(RuntimeError, match="ValueError"):
        failing.result(timeout=120)
    assert not failing.proc.is_alive()


def test_row_peak_rss_is_its_own():
    """A spawned row's peak RSS (testing.peak_rss_mib) leaves out its
    parent's, which ru_maxrss carries across fork and exec."""
    import resource
    block = bytearray(1 << 30)
    block[::4096] = b"x" * len(block[::4096])  # touch every page
    del block
    parent = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    child = testing.Spawned(testing.peak_rss_mib).result(timeout=120)
    assert 0 < child < parent - 512


def test_peak_rss_without_vmhwm(tmp_path):
    """Where the status file has no VmHWM (as on the card host), the peak
    is ru_maxrss only where it cannot be a parent's: a Spawned child,
    forked from the small forkserver, reads its own; a process spawned by
    fork and exec from this one, which has touched 1 GiB, would read this
    one's, and raises."""
    import multiprocessing
    status = tmp_path / "status"
    status.write_text("Name:\tpython\nVmRSS:\t  2048 kB\n")
    block = bytearray(1 << 30)
    block[::4096] = b"x" * len(block[::4096])  # touch every page
    del block
    own = testing.Spawned(testing.peak_rss_mib, str(status)).result(
        timeout=120)
    assert 0 < own < 512
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        with pytest.raises(RuntimeError, match="no VmHWM"):
            pool.apply(testing.peak_rss_mib, (str(status),))
    status.write_text("VmHWM:\t  3072 kB\nVmRSS:\t  2048 kB\n")
    assert testing.peak_rss_mib(str(status)) == 3.0
