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
(pbench/host.py). Where the configuration names `procs` P > 1, each pass
(the warm pass too) is one of a gloo group of P ranks on this host, this
process rank 0 and P - 1 started at set-up (pbench/ranks.py): a pass ends
when its last rank ends, and the peaks are the sums of the ranks'. Once
the window has closed, the plain reference (pbench/oracle.py, driven by
pbench/check.py) judges the passes' outputs.
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
from pbench import check, host, ranks  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pomfret_tpu")
CACHE = os.path.join(HERE, ".cache")
KEEP_SETS = 12  # sets kept a configuration: a check draws 6 seeds a cell
# a group pass's deadline (procs > 1): the warm pass, which may build the
# kernels, WARM_DEADLINE_S; a window pass the larger of DEADLINE_FLOOR_S
# and DEADLINE_WARM_TIMES times the warm pass's wall
WARM_DEADLINE_S = 1200.0
DEADLINE_FLOOR_S = 300.0
DEADLINE_WARM_TIMES = 10.0


def log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def load_spec(root: str, workload: str) -> dict:
    """The cell, its configuration, its traffic, its per-layer metrics and
    its ranks (the configuration's `procs`, 1 where it names none), from
    BENCHMARK.json at `root`."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    procs = config.get("procs", 1)
    if type(procs) is not int or procs < 1:
        raise SystemExit(f"{conf['file']}: procs {procs!r} is not a count")
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"]
                                  in names else [])]
    return dict(cell=cell, config=config, config_file=os.path.join(
        root, conf["file"]), traffic=traffic, end_to_end=e2e, per_layer=layer,
        procs=procs)


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
        ref_procs: int = 0, prelude=()) -> int:
    """One run of the cell. cpu: skip the look for a card and run the
    port's plain torch loop on the CPU (the harness's own tests). With
    spec's procs P > 1, every pass is a pass of a gloo group of P ranks on
    this host (pbench/ranks.py), this process rank 0; `prelude` is handed
    to the other ranks (ranks.Group)."""
    cell, traffic = spec["cell"], spec["traffic"]
    chips = int(cell.get("chips", 1))
    n_ranks = spec.get("procs", 1)
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
    from pomfret_tpu_torch.parallel import batch, distributed
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

    group = None
    own_walls: list = []

    def one_pass(name: str, deadline_s: float = WARM_DEADLINE_S,
                 window: bool = False) -> tuple:
        """(the pass's output prefix, the other ranks' answers)."""
        d = os.path.join(work_dir, name)
        os.makedirs(os.path.join(d, "spool"))
        os.environ["POMFRET_SPOOL_DIR"] = os.path.join(d, "spool")
        prefix = os.path.join(d, "out")
        argv = [sub, "-o", prefix, "--vcf", got["vcf"], *flags, *engine,
                got["bam"]]

        def own() -> None:
            rc = None
            t = time.perf_counter()
            try:
                with into(plog):
                    rc = cli.main(argv)
            finally:
                if rc != 0:
                    with open(plog, errors="replace") as f:
                        log(f"pass {name} failed; the port's log ends:\n"
                            + f.read()[-6000:])
            if rc != 0:
                raise RuntimeError(f"pass {name} exited {rc}")
            if window:
                own_walls.append(time.perf_counter() - t)

        if group is None:
            own()
            return prefix, []
        return prefix, group.run_pass(
            name, argv, os.environ["POMFRET_SPOOL_DIR"], own, deadline_s)

    try:
        if n_ranks > 1:
            group = ranks.Group(
                n_ranks, work_dir, cpu=cpu, prelude=prelude,
                cleanup=lambda: shutil.rmtree(work_dir, ignore_errors=True))
        r0 = batch.DISPATCH_STATS["window_reads"]
        t_warm = time.perf_counter()
        prefix, others = one_pass("warm")
        warm_s = time.perf_counter() - t_warm
        shutil.rmtree(os.path.dirname(prefix))
        warm_reads = batch.DISPATCH_STATS["window_reads"] - r0 + sum(
            a["window_reads"] for a in others)
        log(f"warm pass: the port counted {warm_reads} window reads")
        deadline_s = max(DEADLINE_FLOOR_S, DEADLINE_WARM_TIMES * warm_s)
        if group is not None:
            log(f"group of {n_ranks} ranks: warm pass {warm_s:.3f} s, "
                f"rank walls " + " ".join(f"{a['wall']:.3f}"
                                          for a in others)
                + f"; a window pass's deadline {deadline_s:.1f} s")
            group.open_window(bool(args.trace), deadline_s)
        stats.reset_stages()
        dist0 = dict(distributed.DIST_STATS)
        trace = ranks.WindowTrace(cpu) if args.trace else None
        t0 = time.perf_counter()
        setup_s = t0 - T_START
        r0 = batch.DISPATCH_STATS["window_reads"]
        prefixes, ends = [], []
        probe = host.PassProbe(stats.STAGE_SECONDS)
        while True:
            prefixes.append(one_pass(f"p{len(prefixes)}", deadline_s,
                                     window=True)[0])
            t1 = time.perf_counter()
            ends.append(t1)
            probe.mark()
            if t1 - t0 >= args.seconds:
                break
        if not cpu:
            torch.cuda.synchronize()
        if group is not None:
            group.request_end()
        window_s = t1 - t0
        n = len(prefixes)
        every = [ranks.closing(0, sampler, trace, dict(dist=dist0, reads=r0),
                               own_walls, cpu)]
        if group is not None:
            every += group.collect_end(deadline_s)
        # each a sum over the ranks; with one rank, that rank's reading
        peak_mib = sum(r["peak_rss_mib"] for r in every)
        port_reads = sum(r["window_reads"] for r in every)
        device = dict(platform="cpu" if cpu else "gpu",
                      kind="cpu" if cpu else torch.cuda.get_device_name(0),
                      count=chips, memory_peak_bytes=sum(
                          r["memory_peak_bytes"] for r in every))
        log(f"window: {n} passes in {window_s:.3f} s; the port counted "
            f"{port_reads} window reads, the benchmark {n * per_pass}")
        log("pass walls (s): " + " ".join(
            f"{b - a:.3f}" for a, b in zip([t0] + ends, ends)))
        for line in probe.lines():
            log(line)
        log("stage seconds over the window: " + json.dumps(
            {k: round(v, 3) for k, v in sorted(stats.STAGE_SECONDS.items())}))
        if group is not None:
            for r in every:
                log(f"rank {r['rank']}: " + json.dumps(dict(
                    peak_rss_mib=r["peak_rss_mib"],
                    memory_peak_bytes=r["memory_peak_bytes"],
                    window_reads=r["window_reads"], dist=r["dist"],
                    walls=[round(w, 3) for w in r["walls"]],
                    stage_s={k: round(v, 3)
                             for k, v in sorted(r["stage_s"].items())})))
            log(f"peak_rss_mib: the sum of the {n_ranks} ranks' peaks; "
                "memory_peak_bytes: the sum of their reserved peaks")
        breakdown = None
        if trace is not None:
            from pbench import devtrace, roofline
            ivs, busy, loop_kernel, by_rank = ranks.union(every, t0, t1)
            rec = dict(
                window_s=window_s, passes=n, window_reads=n * per_pass,
                stage_s=dict(stats.STAGE_SECONDS), busy_s=busy,
                loop_kernel=loop_kernel,
                hbm_bytes_per_s=roofline.hbm_bytes_per_s(device["kind"]),
                ranks=by_rank)
            metrics = {}
            for m in spec["per_layer"]:
                v = load_metric(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
            device.update(busy_s=busy, window_s=window_s)
            breakdown = dict(device_ops=devtrace.top_ops(ivs, t0, t1),
                             idle_gaps=devtrace.idle_by_stage(
                                 ivs, trace.events, t0, t1))
            if group is not None:
                log(f"breakdown: device_ops and idle time from the union of "
                    f"the {n_ranks} ranks' device operations; idle_gaps by "
                    "rank 0's stage events")
                log("busy_s by rank: " + " ".join(
                    f"{r['busy_s']!r}" for r in by_rank)
                    + f"; union {busy!r}")
            del ivs, trace
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
        if group is not None:
            group.close()
        shutil.rmtree(work_dir, ignore_errors=True)

    bad = forbidden_loaded(list(sys.modules))
    if bad:
        log(f"modules loaded that the benchmark must not load: {bad}")
        return 3
    for r in every[1:]:
        bad = forbidden_loaded(r.get("modules", []))
        if bad:
            log(f"modules loaded in rank {r['rank']} that the benchmark must "
                f"not load: {bad}")
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
