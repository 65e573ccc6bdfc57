"""The port's pipeline vs the JAX package's, on the CPU.

- pomfret_tpu_torch's run_jobs_batched (engine "torch", CPU tensors) gives
  the decisions and per-read tag maps of pomfret_tpu's run_jobs_batched on
  a 2-chromosome multi-gap scenario;
- `pomfret-tpu-torch methphase --engine torch` writes .mp.vcf/.mp.gtf byte
  for byte equal to `pomfret-tpu methphase --engine host` on the cis and
  trans two-block scenarios, under each engine generation
  (POMFRET_FUSED_GEN=1|2|3);
- `pomfret-tpu-torch report` (--engine torch, gens 3 and 2, and --engine
  host) writes a .report.tsv byte for byte equal to `pomfret-tpu report
  --engine host`.
Tolerance: exact.
"""
import os

import pytest
import torch

from pomfret_tpu.cli import main as tpu_main
from pomfret_tpu.core.intervals import (Storage, merge_close_intervals,
                                        store_raw_intervals)
from pomfret_tpu.core.readset import READBACK, MmrConfig
from pomfret_tpu.io.bam import BamReader
from pomfret_tpu.io.intervals_loader import IS_VCF, load_intervals_from_file
from pomfret_tpu.testing import (make_multichrom_multigap_scenario,
                                 make_two_block_scenario)
from pomfret_tpu_torch import resolve_device
from pomfret_tpu_torch.cli import main as port_main
from pomfret_tpu_torch.parallel.batch import DISPATCH_STATS

torch.set_num_threads(1)


def _jobs(vcf, cov):
    """methphase's job list for `-c cov` (pipeline._blockjoin_all_chroms)."""
    st = Storage()
    load_intervals_from_file(vcf, IS_VCF, st)
    for rg in st.ranges:
        store_raw_intervals(rg)
        merge_close_intervals(rg, READBACK)
    cfg = MmrConfig(cov_known=cov, cov_for_selection=cov // 10,
                    cov_for_runtime=2 * (cov // 10))
    jobs = [dict(job_i=i, ref_name=st.ref_names[i], rg=rg, cfg=cfg,
                 n_cand=cov // 4, indices=list(range(len(rg.starts))),
                 perm_key_base=i * 1_000_003)
            for i, rg in enumerate(st.ranges)]
    return st, jobs


def test_run_jobs_batched_matches_jax(tmp_path, monkeypatch):
    from pomfret_tpu.kernels.engine_jax import run_jobs_batched as jax_run
    from pomfret_tpu_torch.kernels.engine_torch import (run_gaps_batched,
                                                        run_jobs_batched)

    monkeypatch.setenv("POMFRET_NO_MESH", "1")  # one device, as the port
    # two groups per chromosome: the pipe spans groups and chromosomes
    monkeypatch.setenv("POMFRET_GAP_GROUP", "2")
    bam, vcf, _ = make_multichrom_multigap_scenario(
        str(tmp_path), n_chroms=2, n_blocks=4, read_stagger=1400)
    st, jobs = _jobs(vcf, 25)
    assert len(jobs) == 2 and all(len(j["indices"]) == 3 for j in jobs)
    ref = jax_run(st, BamReader(bam), jobs)
    w0 = DISPATCH_STATS["window_reads"]
    got = run_jobs_batched(st, BamReader(bam), jobs, engine="torch",
                           device=torch.device("cpu"))
    assert DISPATCH_STATS["window_reads"] > w0
    assert got == ref
    # the one-chromosome entry point runs the same pipeline
    job = jobs[1]
    dec1, tags1 = run_gaps_batched(
        st, BamReader(bam), job["ref_name"], job["rg"], job["cfg"],
        job["n_cand"], perm_key_base=job["perm_key_base"], engine="torch",
        device=torch.device("cpu"))
    assert dec1 == [got[1][0][i] for i in job["indices"]]
    assert tags1 == [got[1][1][i] for i in job["indices"]]
    decisions = [d for dec, _ in got for d in dec.values()]
    assert decisions.count(0) >= 4, decisions   # gaps really joined
    assert any(tags for _, tm in got for tags in tm.values())


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory):
    """pomfret_tpu methphase --engine host on the cis and trans two-block
    scenarios: {trans: (bam, vcf, output prefix)}."""
    out = {}
    for trans in (False, True):
        d = str(tmp_path_factory.mktemp(f"two_block_{int(trans)}"))
        bam, vcf, truth = make_two_block_scenario(d, trans=trans)
        prefix = os.path.join(d, "host")
        assert tpu_main(["methphase", "-o", prefix, "--engine", "host",
                         "--output-tsv", "-c", "50", "--vcf", vcf, bam]) == 0
        out[trans] = (bam, vcf, prefix)
    return out


def _assert_same_files(p1, p2, exts):
    for ext in exts:
        with open(p1 + ext, "rb") as f1, open(p2 + ext, "rb") as f2:
            assert f1.read() == f2.read(), ext


@pytest.mark.parametrize("trans,gen", [
    pytest.param(False, "3", id="False"), pytest.param(True, "3", id="True"),
    pytest.param(False, "2", id="False-gen2"),
    pytest.param(True, "2", id="True-gen2"),
    pytest.param(False, "1", id="False-gen1"),
    pytest.param(True, "1", id="True-gen1")])
def test_methphase_torch_matches_host(host_runs, tmp_path, monkeypatch,
                                      trans, gen):
    bam, vcf, p_h = host_runs[trans]
    p_t = str(tmp_path / "torch")
    monkeypatch.setenv("POMFRET_FUSED_GEN", gen)
    n0 = DISPATCH_STATS["n_dispatches"]
    assert port_main(["methphase", "-o", p_t, "--engine", "torch", "-c",
                      "50", "--vcf", vcf, bam]) == 0
    assert DISPATCH_STATS["n_dispatches"] > n0  # the device path ran
    _assert_same_files(p_h, p_t, (".mp.vcf", ".mp.gtf"))
    with open(p_t + ".mp.gtf") as f:
        assert len(f.read().strip().split("\n")) == 1   # the gap joined


def test_methphase_wide_candidate_set(host_runs, tmp_path, monkeypatch):
    """`-c 100 -n 600` packs nc_cap 608, past the 512 slots the cuda
    engine once refused: --engine torch writes what --engine host
    writes."""
    from pomfret_tpu_torch.parallel import batch as tb
    caps = []

    def loop(*args, nc_cap, **kw):
        caps.append(nc_cap)
        return plain(*args, nc_cap=nc_cap, **kw)
    plain = tb.loop_plain
    monkeypatch.setattr(tb, "loop_plain", loop)
    bam, vcf, _ = host_runs[True]
    prefixes = [str(tmp_path / eng) for eng in ("host", "torch")]
    for p, eng in zip(prefixes, ("host", "torch")):
        assert port_main(["methphase", "-o", p, "--engine", eng,
                          "--output-tsv", "-c", "100", "-n", "600", "--vcf",
                          vcf, bam]) == 0
    assert caps and set(caps) == {608}
    _assert_same_files(*prefixes, (".mp.vcf", ".mp.gtf", ".mp.tsv"))


def test_methphase_host_engine_matches(host_runs, tmp_path):
    """The port's --engine host (its copy of the host oracle) writes what
    the JAX package's does."""
    bam, vcf, p_h = host_runs[True]
    p_p = str(tmp_path / "port")
    n0 = DISPATCH_STATS["n_dispatches"]
    assert port_main(["methphase", "-o", p_p, "--engine", "host",
                      "--output-tsv", "-c", "50", "--vcf", vcf, bam]) == 0
    assert DISPATCH_STATS["n_dispatches"] == n0
    _assert_same_files(p_h, p_p, (".mp.vcf", ".mp.gtf", ".mp.tsv"))


@pytest.mark.parametrize("cmd", ["varhaptag", "warmup", "methstat",
                                 "bam2cram"])
def test_unported_subcommands_exit_2(cmd, capsys):
    """The subcommands the port once refused are parsed now: without their
    inputs they exit 2 with argparse's usage error, not as unknown."""
    with pytest.raises(SystemExit) as e:
        port_main([cmd])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "the following arguments are required" in err
    assert "invalid choice" not in err


_REPORT_ARGS = ["-c", "50", "--chunk-size", "40000", "--chunk-stride",
                "30000"]  # tests/test_cli_extra.py's report run


@pytest.fixture(scope="module")
def host_report(host_runs):
    """pomfret_tpu report --engine host on the cis two-block scenario:
    (bam, vcf, .report.tsv bytes)."""
    bam, vcf, p_h = host_runs[False]
    prefix = p_h + "_rep"
    assert tpu_main(["report", "-o", prefix, "--engine", "host",
                     *_REPORT_ARGS, "--vcf", vcf, bam]) == 0
    with open(prefix + ".report.tsv", "rb") as f:
        return bam, vcf, f.read()


@pytest.mark.parametrize("engine,gen", [("torch", "3"), ("torch", "2"),
                                        ("host", "3")])
def test_report_matches_host(host_report, tmp_path, monkeypatch, engine,
                             gen):
    bam, vcf, ref = host_report
    monkeypatch.setenv("POMFRET_FUSED_GEN", gen)
    prefix = str(tmp_path / "rep")
    n0 = DISPATCH_STATS["n_dispatches"]
    assert port_main(["report", "-o", prefix, "--engine", engine,
                      *_REPORT_ARGS, "--vcf", vcf, bam]) == 0
    # the device path ran for --engine torch, and only for it
    assert (DISPATCH_STATS["n_dispatches"] > n0) == (engine == "torch")
    with open(prefix + ".report.tsv", "rb") as f:
        got = f.read()
    assert got == ref
    assert b"correct" in got


def test_report_needs_vcf(host_runs, tmp_path):
    bam, _, p_h = host_runs[False]
    assert port_main(["report", "-o", str(tmp_path / "x"), "--engine",
                      "torch", "--gtf", p_h + ".mp.gtf", bam]) == 1


def test_engine_choice(monkeypatch):
    """auto, host and torch stay explicit choices; auto is cuda only with a
    card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("auto") == ("host", None)
    assert resolve_device("host") == ("host", None)
    assert resolve_device("torch") == ("torch", torch.device("cpu"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        resolve_device("cuda")
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_device("jax")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("auto") == ("cuda", torch.device("cuda"))
    with pytest.raises(ValueError, match="cannot run on device"):
        resolve_device("cuda", "cpu")


@pytest.mark.parametrize("cmd", ["methphase", "report", "warmup"])
def test_engine_default_is_cuda(cmd):
    """The engine subcommands run the CUDA kernels unless the caller names
    another engine."""
    from pomfret_tpu_torch.cli import _parser
    from pomfret_tpu_torch.pipeline import CliOpt
    a = _parser().parse_args([cmd, "x.bam"])
    assert a.engine == "cuda"
    assert CliOpt().engine == "cuda"


def test_methphase_without_engine_needs_a_card(host_runs, tmp_path,
                                               monkeypatch):
    """No GPU and no --engine: methphase raises resolve_device("cuda")'s
    error instead of carrying on on the CPU."""
    bam, vcf, _ = host_runs[False]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n0 = DISPATCH_STATS["n_dispatches"]
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        port_main(["methphase", "-o", str(tmp_path / "x"), "-c", "50",
                   "--vcf", vcf, bam])
    assert DISPATCH_STATS["n_dispatches"] == n0
    assert not os.path.exists(str(tmp_path / "x") + ".mp.vcf")
