#!/usr/bin/env python3
"""The benchmark of pomfret_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The cell (BENCHMARK.json `workloads`) names
a configuration (`configs`: its file under benchmark/configs/ holds the
set's sizes) and a traffic mix (benchmark/traffic/<traffic>.json: the
subcommand, methphase, and its flags). Per-layer metrics are read by
benchmark/metrics/<metric>.py. Nothing here names a cell, a
configuration, a mix or a metric: adding one is adding files and entries.

Set-up: the set is made from the seed in a process of its own
(pbench/maker.py; kept under benchmark/.cache/sets/<config>/<seed>/), the
port is imported and one whole warm pass is run. The window then runs
whole CLI passes in this process, as a user's run of one genome each
(`pomfret_tpu_torch.cli.main([subcommand, ...])`, each with an empty
POMFRET_SPOOL_DIR, so each pays the coverage scan), until --seconds have
passed; the log gives each pass's wall, CPU and the host's steal
(pbench/host.py). Once it has closed, the plain reference
(pbench/oracle.py, driven by pbench/check.py) judges the passes' outputs.
With --trace 1 the window runs under
torch.profiler and the per-layer metrics are printed in place of the
end-to-end ones. The last line of standard output is the result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from contextlib import contextmanager  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):  # the port at the checkout's root, pbench here
    if _p not in sys.path:
        sys.path.insert(0, _p)

from pbench import rss  # noqa: E402  (first: it reads the inherited peak)
from pbench import check, host  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pomfret_tpu")
CACHE = os.path.join(HERE, ".cache")
KEEP_SETS = 12  # sets kept a configuration: a check draws 6 seeds a cell


def log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def load_spec(root: str, workload: str) -> dict:
    """The cell, its configuration, its traffic and its per-layer metrics,
    from BENCHMARK.json at `root`."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"]
                                  in names else [])]
    return dict(cell=cell, config=config, config_file=os.path.join(
        root, conf["file"]), traffic=traffic, end_to_end=e2e, per_layer=layer)


def make_set(spec: dict, seed: int, cache: str) -> dict:
    """The cell's set for `seed`, made in a process of its own unless the
    cache holds it (benchmark/.cache/sets/<config>/<seed>/, the newest
    KEEP_SETS of a configuration kept): its BAM, VCF, the maker's record
    of every read, each chromosome's (pos, end, haplotype) rows and its
    length."""
    import numpy as np
    from pbench import maker
    top = os.path.join(cache, "sets", spec["cell"]["config"])
    d = os.path.join(top, str(seed))
    made = os.path.join(d, "made.json")
    if not os.path.exists(made):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.join(HERE, "pbench",
                                                     "maker.py"),
                        spec["config_file"], str(seed), d], check=True,
                       stdout=sys.stderr)
        os.sync()  # its pages written back before the window, not in it
        log(f"made the set of seed {seed} in "
            f"{time.perf_counter() - t0:.2f} s")
        old = sorted((os.path.getmtime(os.path.join(top, x)), x)
                     for x in os.listdir(top) if x != str(seed))
        for _, x in old[:max(0, len(old) - (KEEP_SETS - 1))]:
            shutil.rmtree(os.path.join(top, x), ignore_errors=True)
    else:
        log(f"the set of seed {seed} is cached")
    with np.load(os.path.join(d, "reads.npz")) as z:
        reads = [z[f"arr_{i}"] for i in range(len(z.files))]
    p = spec["config"]["set"]
    ref_len, _ = maker.block_layout(p["n_blocks"], p["block_len"],
                                    p["gap_len"])
    return dict(bam=os.path.join(d, maker.BAM_NAME),
                vcf=os.path.join(d, maker.VCF_NAME),
                truth=os.path.join(d, maker.TRUTH_NAME), ref_len=ref_len,
                reads={f"chr{i + 1}": r for i, r in enumerate(reads)})


@contextmanager
def into(path: str):
    """Standard output and error of this process (the port's logs) go to
    `path` while the block runs."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = os.dup(1), os.dup(2)
    with open(path, "ab") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
        try:
            yield
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os.dup2(saved[0], 1)
            os.dup2(saved[1], 2)
            os.close(saved[0])
            os.close(saved[1])


def load_metric(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "pbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(args, spec: dict, *, cpu: bool = False, cache: str = CACHE,
        ref_procs: int = 0) -> int:
    """One run of the cell. cpu: skip the look for a card and run the
    port's plain torch loop on the CPU (the harness's own tests)."""
    cell, traffic = spec["cell"], spec["traffic"]
    chips = int(cell.get("chips", 1))
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        os.environ[k] = os.path.join(cache, k.lower())
    os.environ["USE_FLAX"] = "0"

    sampler = rss.RssSampler()
    sampler.__enter__()
    import torch
    if not cpu:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            log(f"needs {chips} CUDA device(s), sees {have}")
            return 2
        torch.zeros(1, device="cuda")
        log(f"card: {power_limit()}")
    got = make_set(spec, args.seed, cache)
    from pbench import oracle
    wins = oracle.windows(got["vcf"])
    per_pass = oracle.pass_reads(wins, got["reads"])
    log(f"{len(wins)} windows a pass, {per_pass} window reads")

    from pomfret_tpu_torch import cli
    from pomfret_tpu_torch.parallel import batch
    from pomfret_tpu_torch.utils import stats

    work_dir = tempfile.mkdtemp(prefix="pbench-")
    plog = os.path.join(work_dir, "port.log")
    sub = traffic["subcommand"]
    if sub != "methphase":
        raise SystemExit(f"traffic {cell['traffic']!r}: the harness drives "
                         "methphase alone")
    flags = list(traffic.get("args", []))
    engine = ["--engine", "torch", "--device", "cpu"] if cpu else \
        ["--engine", "cuda"]

    def one_pass(name: str) -> str:
        d = os.path.join(work_dir, name)
        os.makedirs(os.path.join(d, "spool"))
        os.environ["POMFRET_SPOOL_DIR"] = os.path.join(d, "spool")
        prefix = os.path.join(d, "out")
        rc = None
        try:
            with into(plog):
                rc = cli.main([sub, "-o", prefix, "--vcf", got["vcf"],
                               *flags, *engine, got["bam"]])
        finally:
            if rc != 0:
                with open(plog, errors="replace") as f:
                    log(f"pass {name} failed; the port's log ends:\n"
                        + f.read()[-6000:])
        if rc != 0:
            raise RuntimeError(f"pass {name} exited {rc}")
        return prefix

    try:
        r0 = batch.DISPATCH_STATS["window_reads"]
        shutil.rmtree(os.path.dirname(one_pass("warm")))
        log(f"warm pass: the port counted "
            f"{batch.DISPATCH_STATS['window_reads'] - r0} window reads")
        stats.reset_stages()
        if args.trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            from pbench import devtrace, roofline
            stats.record_stage_events(True)
            loop = roofline.LoopBytes(batch.run_batch_fused3)
            batch.run_batch_fused3 = loop
            acts = [ProfilerActivity.CPU] + (
                [] if cpu else [ProfilerActivity.CUDA])
            prof = profile(activities=acts)
            prof.__enter__()
            t_mark = time.perf_counter()
            marker = record_function(devtrace.MARKER)
            marker.__enter__()
        t0 = time.perf_counter()
        setup_s = t0 - T_START
        r0 = batch.DISPATCH_STATS["window_reads"]
        prefixes, ends = [], []
        probe = host.PassProbe(stats.STAGE_SECONDS)
        while True:
            prefixes.append(one_pass(f"p{len(prefixes)}"))
            t1 = time.perf_counter()
            ends.append(t1)
            probe.mark()
            if t1 - t0 >= args.seconds:
                break
        if not cpu:
            torch.cuda.synchronize()
        window_s = t1 - t0
        port_reads = batch.DISPATCH_STATS["window_reads"] - r0
        sampler.__exit__(None, None, None)
        peak_mib = rss.run_peak_mib(sampler)
        n = len(prefixes)
        log(f"window: {n} passes in {window_s:.3f} s; the port counted "
            f"{port_reads} window reads, the benchmark {n * per_pass}")
        log("pass walls (s): " + " ".join(
            f"{b - a:.3f}" for a, b in zip([t0] + ends, ends)))
        for line in probe.lines():
            log(line)
        log("stage seconds over the window: " + json.dumps(
            {k: round(v, 3) for k, v in sorted(stats.STAGE_SECONDS.items())}))
        device = dict(platform="cpu" if cpu else "gpu",
                      kind="cpu" if cpu else torch.cuda.get_device_name(0),
                      count=chips,
                      memory_peak_bytes=0 if cpu else int(
                          torch.cuda.max_memory_reserved()))
        breakdown = None
        if args.trace:
            marker.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            batch.run_batch_fused3 = loop.fn
            ivs = devtrace.device_events(prof, t_mark)
            del prof
            events = stats.STAGE_EVENTS
            stats.record_stage_events(False)
            busy = devtrace.busy_s(ivs, t0, t1)
            rec = dict(
                window_s=window_s, passes=n, window_reads=n * per_pass,
                stage_s=dict(stats.STAGE_SECONDS), busy_s=busy,
                loop_kernel=dict(
                    launches=len(loop.counts), bytes=loop.total_bytes(),
                    device_s=sum(t - s for s, t, name in ivs
                                 if "loop_kernel" in name)),
                hbm_bytes_per_s=roofline.hbm_bytes_per_s(device["kind"]))
            metrics = {}
            for m in spec["per_layer"]:
                v = load_metric(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
            device.update(busy_s=busy, window_s=window_s)
            breakdown = dict(device_ops=devtrace.top_ops(ivs, t0, t1),
                             idle_gaps=devtrace.idle_by_stage(
                                 ivs, events, t0, t1))
            del ivs, events
        else:
            values = dict(window_reads_per_s=n * per_pass / window_s,
                          peak_rss_mib=peak_mib, setup_s=setup_s)
            metrics = {m["name"]: dict(value=values[m["name"]],
                                       unit=m["unit"])
                       for m in spec["end_to_end"]}
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        ref_prefix = os.path.join(work_dir, "ref")
        procs = ref_procs or max(1, min((os.cpu_count() or 2) - 1, 7))
        ref = check.reference(got["truth"], got["ref_len"], wins, procs)
        check.write_outputs(got["vcf"], wins, ref["windows"], ref_prefix)
        nums = check.compare(prefixes, wins, ref, ref_prefix)
        correct, checked = check.report(nums)
        log(f"reference: {len(wins)} windows in {procs} processes, "
            f"{time.perf_counter() - t_ref:.2f} s")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    bad = forbidden_loaded(list(sys.modules))
    if bad:
        log(f"modules loaded that the benchmark must not load: {bad}")
        return 3
    for k, v in checked.items():
        sys.stderr.write(f"{k} {v['value']} limit {v['limit']}\n")
    sys.stderr.flush()
    res = dict(correct=correct, attempted=n, failed=0, metrics=metrics,
               device=device)
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["check"] = checked
    sys.stdout.write(json.dumps(res) + "\n")
    sys.stdout.flush()
    return 0


def forbidden_loaded(modules) -> list:
    """The top-level names among `modules` that the benchmark must not
    load, each compared whole (pomfret_tpu_torch is not pomfret_tpu)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    return run(args, load_spec(ROOT, args.workload))


if __name__ == "__main__":
    sys.exit(main())
