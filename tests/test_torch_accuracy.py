"""The accuracy datasets and the dense shape, the port against the JAX
package on the CPU.

- testing.scale_params, trans_params and dense_params build the dicts that
  bench.py (build_scale_dataset) and tools/accuracy_scale.py (main_trans,
  main_noise) build, read from their source with ast and run; the cache
  keys (.bench_data/<key>/) are equal too.
- on a small dense chromosome (read stagger 180, ~200x, noise and nocall
  0.05, 3 blocks) with coverage-derived parameters (n_cand = cov // 4 + 1,
  the windows in the R >= 1792 bucket), the port's run_jobs_batched
  (engine "torch", CPU tensors) gives the decisions and per-read tag maps
  of the JAX package's run_jobs_batched (its vmapped XLA body on the CPU);
- on the same chromosome `pomfret-tpu-torch report --engine torch` writes
  the .report.tsv of `pomfret-tpu report --engine jax`, byte for byte, at
  chunk size 50 kb and stride 20 kb (4 windows, R 2048).
Tolerance: exact.

The two JAX runs stay in this one file, one after the other: at these
shapes each takes 12-14 GiB of RSS on the CPU (the JAX body's seed
table), too much for two test workers at once.
"""
import ast
import hashlib
import json
import os

import pytest
import torch

from pomfret_tpu_torch import testing
from torch_accuracy_cases import REPO, heap_returned, jax_tool, small_dense

torch.set_num_threads(1)


def _frozen(path, func, bind, loop=False):
    """(params, key) as function `func` of the frozen file `path` builds
    them, with the names in `bind` set: its statements (those of its first
    for loop with loop=True) run up to the assignment of `key`, skipping
    any assignment to a name in `bind`."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    body = (next(n for n in fn.body if isinstance(n, ast.For)).body if loop
            else fn.body)
    keep = []
    for stmt in body:
        name = (stmt.targets[0].id if isinstance(stmt, ast.Assign)
                and isinstance(stmt.targets[0], ast.Name) else None)
        if name in bind:
            continue
        keep.append(stmt)
        if name == "key":
            break
    # what the frozen files import at their top or before the loop
    ns = dict(bind, hashlib=hashlib, json=json)
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns["params"], ns["key"]


@pytest.mark.parametrize("frozen, port", [
    (("bench.py", "build_scale_dataset", {"scale": 1}),
     lambda: testing.scale_params(1)),
    (("bench.py", "build_scale_dataset", {"scale": 2}),
     lambda: testing.scale_params(2)),
    (("bench.py", "build_scale_dataset", {"scale": 5}),
     lambda: testing.scale_params(5)),
    (("tools/accuracy_scale.py", "main_trans", {"scale": 3}),
     lambda: testing.trans_params(3)),
    (("tools/accuracy_scale.py", "main_noise", {"noise": 0.05}, True),
     lambda: testing.dense_params(0.05)),
    (("tools/accuracy_scale.py", "main_noise", {"noise": 0.25}, True),
     lambda: testing.dense_params(0.25)),
], ids=["scale1", "scale2", "scale5", "trans3", "dense0.05", "dense0.25"])
def test_dataset_params_match_the_jax_package(frozen, port):
    params, key = _frozen(*frozen)
    assert port() == params
    assert testing.dataset_key(port()) == key


@pytest.fixture(scope="module")
def dense_set(tmp_path_factory):
    return small_dense(tmp_path_factory.mktemp("dense"))


def test_run_jobs_batched_dense_matches_jax(dense_set, monkeypatch):
    from pomfret_tpu.kernels.engine_jax import run_jobs_batched as jax_run
    from pomfret_tpu.pipeline import _derive_chrom_params as jax_derive
    from pomfret_tpu.pipeline import estimate_read_coverage_cached
    from pomfret_tpu_torch.io.bam import BamReader
    from pomfret_tpu_torch.kernels.engine_torch import run_jobs_batched
    from pomfret_tpu_torch.parallel.batch import DISPATCH_STATS
    from pomfret_tpu_torch.tools import accuracy_scale as tool

    monkeypatch.setenv("POMFRET_NO_MESH", "1")
    bam, vcf, n_gaps, _ = dense_set
    _, st = tool.load_gap_storage(bam, vcf)
    jobs = tool.gap_jobs(bam, st)
    cov = estimate_read_coverage_cached(bam, 2)["chr1"]
    assert cov >= 180                       # the dense shape, ~200x
    assert [j["n_cand"] for j in jobs] == [cov // 4 + 1]
    DISPATCH_STATS["shapes"].clear()
    with heap_returned():
        got = run_jobs_batched(st, BamReader(bam), jobs, engine="torch",
                               device=torch.device("cpu"))
    assert [s[1] for s in DISPATCH_STATS["shapes"]] == [1792]

    # the JAX tool's storage and its jobs (tools/accuracy_scale.py
    # main_trans), through the JAX package's own helpers
    from pomfret_tpu.core.readset import MmrConfig
    jbam, jst = jax_tool()._load_gap_storage(bam, vcf)
    jjobs = []
    for i, rg in enumerate(jst.ranges):
        cfg, n_cand = jax_derive(MmrConfig(), 14, cov, jst.ref_names[i])
        jjobs.append(dict(ref_name=jst.ref_names[i], rg=rg, cfg=cfg,
                          n_cand=n_cand, indices=list(range(len(rg.starts))),
                          perm_key_base=i * 1_000_003))
    ref = jax_run(jst, jbam, jjobs)
    assert got == ref
    assert sum(len(j["indices"]) for j in jobs) == n_gaps
    assert list(got[0][0].values()).count(0) == n_gaps   # every gap joined
    assert all(got[0][1].values())


def test_report_dense_matches_jax(dense_set, tmp_path, monkeypatch):
    from pomfret_tpu.cli import main as tpu_main
    from pomfret_tpu_torch.cli import main as port_main
    from pomfret_tpu_torch.parallel.batch import DISPATCH_STATS

    monkeypatch.setenv("POMFRET_NO_MESH", "1")
    bam, vcf, _, _ = dense_set
    args = ["--chunk-size", "50000", "--chunk-stride", "20000", "--vcf", vcf,
            bam]
    port, jax = (str(tmp_path / name) for name in ("port", "jax"))
    DISPATCH_STATS["shapes"].clear()
    with heap_returned():
        assert port_main(["report", "-o", port, "--engine", "torch",
                          *args]) == 0
    assert [s[1] for s in DISPATCH_STATS["shapes"]] == [2048]
    assert tpu_main(["report", "-o", jax, "--engine", "jax", *args]) == 0
    with open(port + ".report.tsv", "rb") as f1, \
            open(jax + ".report.tsv", "rb") as f2:
        got, ref = f1.read(), f2.read()
    assert got == ref
    verdicts = [line.split(b"\t")[3] for line in got.splitlines()]
    assert verdicts == [b"correct"] * 4, verdicts
