#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pomfret_tpu_torch) once on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one line:
 1. card: the GPU's name and power limit (nvidia-smi);
 2. build: nvcc builds the loop kernel from pomfret_tpu_torch/kernels/csrc;
 3. kernel vs plain: run_batch_fused3 (the loop kernel) against loop_plain
    (plain PyTorch) on the card, on a 10-trial random sweep (testing.
    fuzz_args: the CPU tests' 8 trials, a dense R=1792/D=8/NC=64 window
    and int32 ids), on the crafted near-tie lanes (testing.near_tie_args)
    and on the bench-shape batch (G=256 lanes, D=4, R=512, S=1536); hp and
    stats must be equal (exact). On the same fixtures the per-iteration
    engines run whole loops, gen 1 (run_batch_fused, score kernel) and gen
    2 (run_batch_fused2, score-commit kernel), with every kernel step held
    against its plain version on the same inputs (testing.checked_step,
    exact); their hp and stats must equal the loop kernel's. Prints the
    loop kernel's and the plain loop's time, each step kernel's time
    against its plain version's, and the whole-loop times of gens 1, 2, 3
    at the bench shape (CUDA events);
 4. main path: `pomfret-tpu-torch methphase --engine cuda` on the 200-gap
    scale dataset of bench.py (generated once into .bench_data/), then
    `--engine torch --device cuda` on the same card; .mp.vcf/.mp.gtf must
    be byte-identical and the loop kernel must have run; prints wall and
    reads/s;
 4b. profile: one more warm `--engine cuda` run under torch.profiler;
    prints the device busy time and idle share of its wall;
 4c. generations: the same `methphase --engine cuda` under
    POMFRET_FUSED_GEN=1, then =2; outputs byte-identical to gen 3's, the
    score kernel (gen 1) or the score-commit kernel (gen 2) launched and
    the loop kernel not; prints wall and reads/s of each;
 5. parity: `--engine cuda` against the host oracle (`--engine host`) on a
    2-chromosome x 6-gap scenario and a trans two-block scenario;
    .mp.vcf/.mp.gtf/.mp.tsv must be byte-identical;
 6. report: `pomfret-tpu-torch report --engine cuda` under gens 3 and 2
    against `report --engine host` on the cis two-block scenario;
    .report.tsv must be byte-identical.
Then a JSON line of the kernels, and last {"ok": true, "device": {...}}.
Any failure raises: the exit code is non-zero and the last line is absent.
Longer output (per-phase stage seconds) goes to chiprun_out/chip_smoke.json.
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCALE_PARAMS = dict(  # bench.py build_scale_dataset at BENCH_SCALE=1
    n_blocks=51, block_len=60_000, gap_len=30_000,
    per_chrom=[
        {"read_stagger": 700, "cpg_every": 100, "read_len": 20_000},
        {"read_stagger": 1000, "cpg_every": 120, "read_len": 20_000,
         "noise": 0.02, "nocall": 0.02},
        {"read_stagger": 1400, "cpg_every": 160, "read_len": 20_000},
        {"read_stagger": 2000, "cpg_every": 200, "read_len": 20_000,
         "noise": 0.03, "nocall": 0.03},
    ])


def check(ok, msg):
    """A failed phase raises (assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_vs_plain(dev):
    import numpy as np
    import torch
    from pomfret_tpu_torch.kernels import engine_fused as f12
    from pomfret_tpu_torch.kernels import engine_fused3 as f3
    from pomfret_tpu_torch.parallel.batch import batch_args
    from pomfret_tpu_torch.testing import (N_FUZZ_CARD, bench_gap_batch,
                                           checked_step, fuzz_args,
                                           near_tie_args)

    score = checked_step(f12.score_candidates_batch, f12.score_plain)
    step = checked_step(f12.step_fused2, f12.score_commit_plain,
                        in_place=(3, 4))

    def run_both(args, D, nc_cap):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
        hk, sk = f3.run_batch_fused3(*t, D=D, nc_cap=nc_cap)
        hpl, spl = f3.loop_plain(*t, D=D, nc_cap=nc_cap)
        torch.cuda.synchronize()
        err = int((hk.long() - hpl.long()).abs().max())
        if not (torch.equal(hk, hpl) and torch.equal(sk, spl)):
            bad = (hk != hpl).any(dim=1).nonzero().flatten().tolist()
            raise RuntimeError(f"kernel != plain (lanes {bad[:10]}, "
                                 f"max |hp diff| {err}); stats kernel "
                                 f"{sk[bad[:3]].tolist()} plain "
                                 f"{spl[bad[:3]].tolist()}")
        # gens 1 and 2, every kernel step checked against its plain version
        for gen, out in (
                ("1", f12.run_batch_fused(*t, D=D, nc_cap=nc_cap,
                                          score=score)),
                ("2", f12.run_batch_fused2(*t, D=D, nc_cap=nc_cap,
                                           step=step))):
            check(torch.equal(out[0], hk) and torch.equal(out[1], sk),
                  f"gen {gen} loop != loop kernel (hp or stats)")
        return t, hk, sk, err

    max_err = 0
    for trial in range(N_FUZZ_CARD):
        _, _, _, err = run_both(*fuzz_args(trial))
        max_err = max(max_err, err)
    _, _, _, err = run_both(*near_tie_args()[:3])
    max_err = max(max_err, err)
    score.first = step.first = None  # time the steps at the bench shape
    batch, n_reads = bench_gap_batch(G=256)
    G, R, S = batch.shape3
    args = batch_args(batch, 2 * R + 64)
    t, hk, sk, err = run_both(args, batch.D, batch.nc_cap)
    max_err = max(max_err, err)
    tagged = int((hk <= 1).sum())
    check(tagged > 0, "the kernel tagged no read at the bench shape")
    check(score.calls > 0 and step.calls > 0, "no step was checked")
    kw = dict(D=batch.D, nc_cap=batch.nc_cap)
    ms = cuda_ms(lambda: f3.run_batch_fused3(*t, **kw), 5)
    plain_ms = cuda_ms(lambda: f3.loop_plain(*t, **kw), 1)
    gen_ms = {"1": cuda_ms(lambda: f12.run_batch_fused(*t, **kw), 2),
              "2": cuda_ms(lambda: f12.run_batch_fused2(*t, **kw), 2),
              "3": ms}
    # one step at the bench shape: the first iteration's inputs (the
    # score-commit step updates its copies in place from call to call)
    sa, skw = score.first
    ca, ckw = step.first
    steps = {
        "score_kernel": (
            cuda_ms(lambda: f12.score_candidates_batch(*sa, **skw), 50),
            cuda_ms(lambda: f12.score_plain(*sa, **skw), 50)),
        "score_commit_kernel": (
            cuda_ms(lambda: f12.step_fused2(*ca, **ckw), 50),
            cuda_ms(lambda: f12.score_commit_plain(*ca, **ckw), 50))}
    iters = int(sk[:, 0].max())
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                fuzz_trials=N_FUZZ_CARD, G=G, R=R, S=S, D=batch.D,
                nc_cap=batch.nc_cap, iters=iters, tagged=tagged,
                reads=G * n_reads, gen_loop_ms=gen_ms,
                step_ms={k: v[0] for k, v in steps.items()},
                step_plain_ms={k: v[1] for k, v in steps.items()},
                step_max_abs_err={"score_kernel": score.max_abs_err,
                                  "score_commit_kernel": step.max_abs_err},
                steps_checked={"score_kernel": score.calls,
                               "score_commit_kernel": step.calls})


def phase_profile(base):
    """Device busy time and idle share of one warm `methphase --engine
    cuda` run under torch.profiler: the union of the device events'
    intervals against the run's wall, and the device time by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pomfret_tpu_torch.kernels import engine_fused3 as f3

    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_prof_"), "p")
    n0 = f3.run_batch_fused3.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        methphase(["-o", out, "--engine", "cuda", *base])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ivs, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end  # microseconds
        ivs.append((s, t))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    check(ivs, "torch.profiler recorded no device event")
    ivs.sort()
    busy_us, cur_s, cur_e = 0.0, ivs[0][0], ivs[0][1]
    for s, t in ivs[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, t)
    busy_us += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_s=wall, launches=f3.run_batch_fused3.launches - n0,
                device_events=len(ivs), device_busy_s=busy_us / 1e6,
                device_idle_share=1 - busy_us / 1e6 / wall,
                loop_kernel_s=sum(us for n, us in by_name.items()
                                  if "loop_kernel" in n) / 1e6,
                top_device_s={n: us / 1e6 for n, us in top})


def scale_dataset():
    """bench.py's 200-gap scale dataset, cached under .bench_data/ (same key
    as bench.py, so either can reuse the other's copy)."""
    key = hashlib.sha1(json.dumps(SCALE_PARAMS, sort_keys=True)
                       .encode()).hexdigest()[:12]
    d = os.path.join(ROOT, ".bench_data", key)
    bam = os.path.join(d, "scale.bam")
    vcf = os.path.join(d, "multichrom.vcf.gz")
    if not all(os.path.exists(p) for p in (bam, vcf, bam + ".bai")):
        from pomfret_tpu.testing import make_multichrom_multigap_scenario
        os.makedirs(d, exist_ok=True)
        make_multichrom_multigap_scenario(
            d, bam_threads=max(2, os.cpu_count() or 2), bam_name="scale.bam",
            **SCALE_PARAMS)
    n_gaps = len(SCALE_PARAMS["per_chrom"]) * (SCALE_PARAMS["n_blocks"] - 1)
    return bam, vcf, n_gaps


def methphase(args):
    from pomfret_tpu_torch.cli import main
    t0 = time.perf_counter()
    rc = main(["methphase", *args])
    wall = time.perf_counter() - t0
    check(rc == 0, f"methphase {' '.join(args)} exited {rc}")
    return wall


def methreport(args):
    from pomfret_tpu_torch.cli import main
    rc = main(["report", *args])
    check(rc == 0, f"report {' '.join(args)} exited {rc}")


def zero_counts():
    """Every kernel's launch counts to 0: the wrappers' and DISPATCH_STATS'."""
    from pomfret_tpu_torch.parallel.batch import DISPATCH_STATS, KERNELS
    for name, fn in KERNELS.items():
        fn.launches = 0
        DISPATCH_STATS["kernel_launches"][name] = 0


def read_counts():
    """Launches of each kernel since zero_counts(), by name; the dispatch
    layer must have counted the same."""
    from pomfret_tpu_torch.parallel.batch import DISPATCH_STATS, KERNELS
    n = {name: fn.launches for name, fn in KERNELS.items()}
    check(n == DISPATCH_STATS["kernel_launches"],
          f"launch counts: wrappers {n}, dispatch "
          f"{DISPATCH_STATS['kernel_launches']}")
    return n


def same_outputs(p1, p2, exts):
    for ext in exts:
        with open(p1 + ext, "rb") as f1, open(p2 + ext, "rb") as f2:
            a, b = f1.read(), f2.read()
        check(a == b, f"{p1}{ext} and {p2}{ext} differ")
        check(len(a) > 0, f"{p1}{ext} is empty")


def decisions(prefix):
    with open(prefix + ".mp.manifest.jsonl") as f:
        return [json.loads(line)["decision"] for line in f if line.strip()]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    os.environ["POMFRET_NO_HOST_FALLBACK"] = "1"
    sys.path.insert(0, ROOT)
    import pomfret_tpu_torch  # noqa: F401  (absent beside a lone script)
    from pomfret_tpu_torch.kernels import _build
    from pomfret_tpu_torch.parallel.batch import DISPATCH_STATS
    from pomfret_tpu.utils.stats import reset_stages, stage_report

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    say("card", f"{card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.get_lib()
    report["build_s"] = time.perf_counter() - t0
    say("build", f"{os.path.relpath(lib, ROOT)} in {report['build_s']:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")

    kv = phase_kernel_vs_plain(dev)
    report["kernel_vs_plain"] = kv
    say("kernel", f"kernel == plain on {kv['fuzz_trials']} fuzz trials, the "
        f"near-tie lanes and the bench shape G={kv['G']} R={kv['R']} S={kv['S']} D={kv['D']} "
        f"nc={kv['nc_cap']} ({kv['iters']} iterations max): kernel "
        f"{kv['ms']:.3f} ms, plain {kv['plain_ms']:.3f} ms on {card}")
    sm, spm, n = kv["step_ms"], kv["step_plain_ms"], kv["steps_checked"]
    gm = kv["gen_loop_ms"]
    say("kernel", f"gens 1 and 2 == loop kernel (hp, stats) on the same "
        f"fixtures; every step == its plain version ({n['score_kernel']} "
        f"score and {n['score_commit_kernel']} score-commit steps); one "
        f"bench-shape step: score_kernel {sm['score_kernel']:.4f} ms, "
        f"score_plain {spm['score_kernel']:.4f} ms, score_commit_kernel "
        f"{sm['score_commit_kernel']:.4f} ms, score_commit_plain "
        f"{spm['score_commit_kernel']:.4f} ms; whole loop at the bench shape: "
        f"gen 1 {gm['1']:.2f} ms, gen 2 {gm['2']:.2f} ms, gen 3 "
        f"{gm['3']:.3f} ms; {card}")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.perf_counter()
    bam, vcf, n_gaps = scale_dataset()
    report["dataset_s"] = time.perf_counter() - t0
    p_c, p_c2, p_t = (os.path.join(work, n) for n in ("cuda", "cuda2",
                                                       "torch"))
    base = ["--vcf", vcf, bam]
    methphase(["-o", p_c2, "--engine", "cuda", *base])  # cold: first use
    # the main path, counted from zero: only its launches count
    zero_counts()
    reads0 = DISPATCH_STATS["window_reads"]
    reset_stages()
    wall_c = methphase(["-o", p_c, "--engine", "cuda", *base])
    counts = read_counts()
    reads = DISPATCH_STATS["window_reads"] - reads0
    report["e2e_cuda"] = dict(wall_s=wall_c, window_reads=reads,
                              kernel_launches=counts,
                              stages=stage_report(3))
    check(counts["loop_kernel"] > 0,
          "the main path did not launch the loop kernel")
    check(reads > 0, "the main path loaded no window reads")
    dec = decisions(p_c)
    check(dec.count(1) == 0 and dec.count(0) > 0,
          f"decisions on the all-cis dataset: {dec}")
    # two more warm runs give the spread of the e2e wall
    report["e2e_cuda"]["repeat_walls_s"] = [
        methphase(["-o", p_c2, "--engine", "cuda", *base]) for _ in range(2)]
    reset_stages()
    wall_t = methphase(["-o", p_t, "--engine", "torch", "--device", "cuda",
                        *base])
    report["e2e_torch"] = dict(wall_s=wall_t, stages=stage_report(3))
    same_outputs(p_c, p_t, (".mp.vcf", ".mp.gtf"))
    same_outputs(p_c, p_c2, (".mp.vcf", ".mp.gtf"))
    say("main", f"methphase --engine cuda on {n_gaps} gaps, {reads} window "
        f"reads: {wall_c:.2f} s = {reads / wall_c:.0f} reads/s (repeats "
        f"{', '.join(f'{w:.2f}' for w in report['e2e_cuda']['repeat_walls_s'])}"
        f" s), "
        f"{counts['loop_kernel']} loop-kernel launches, {dec.count(0)}/"
        f"{len(dec)} gaps joined; "
        f"--engine torch "
        f"{wall_t:.2f} s; outputs identical; {card}")

    pr = phase_profile(base)
    report["profile"] = pr
    check(pr["launches"] > 0, "the profiled run launched no loop kernel")
    say("profile", f"warm methphase --engine cuda under torch.profiler: "
        f"wall {pr['wall_s']:.2f} s, device busy "
        f"{pr['device_busy_s'] * 1e3:.1f} ms in {pr['device_events']} "
        f"events (idle {100 * pr['device_idle_share']:.1f}%), "
        f"loop_kernel {pr['loop_kernel_s'] * 1e3:.2f} ms; {card}")

    # 4c: the per-iteration engines on the same path, each counted from zero
    gens = {}
    for gen, kernel in (("1", "score_kernel"), ("2", "score_commit_kernel")):
        p_g = os.path.join(work, f"gen{gen}")
        os.environ["POMFRET_FUSED_GEN"] = gen
        try:
            zero_counts()
            reads0 = DISPATCH_STATS["window_reads"]
            reset_stages()
            wall = methphase(["-o", p_g, "--engine", "cuda", *base])
        finally:
            del os.environ["POMFRET_FUSED_GEN"]
        n = read_counts()
        greads = DISPATCH_STATS["window_reads"] - reads0
        gens[gen] = dict(wall_s=wall, window_reads=greads,
                         kernel_launches=n, stages=stage_report(3))
        check(n[kernel] > 0, f"gen {gen} did not launch {kernel}")
        check(n["loop_kernel"] == 0, f"gen {gen} launched the loop kernel")
        same_outputs(p_c, p_g, (".mp.vcf", ".mp.gtf"))
    report["e2e_gens"] = gens
    say("gens", "methphase --engine cuda, outputs identical to gen 3's: "
        + "; ".join(f"POMFRET_FUSED_GEN={g} {v['wall_s']:.2f} s = "
                    f"{v['window_reads'] / v['wall_s']:.0f} reads/s, "
                    f"{v['kernel_launches'][k]} {k} launches"
                    for (g, v), k in zip(gens.items(),
                                         ("score_kernel",
                                          "score_commit_kernel")))
        + f" (gen 3 {wall_c:.2f} s); {card}")

    from pomfret_tpu.testing import (make_multichrom_multigap_scenario,
                                     make_two_block_scenario)
    d1, d2 = os.path.join(work, "multi"), os.path.join(work, "trans")
    os.makedirs(d1)
    os.makedirs(d2)
    bam1, vcf1, _ = make_multichrom_multigap_scenario(d1, n_chroms=2,
                                                      n_blocks=7)
    bam2, vcf2, _ = make_two_block_scenario(d2, trans=True)
    walls = {}
    for d, b, v in ((d1, bam1, vcf1), (d2, bam2, vcf2)):
        for eng in ("cuda", "host"):
            walls[(d, eng)] = methphase(
                ["-o", os.path.join(d, eng), "--engine", eng, "-c", "50",
                 "--output-tsv", "--vcf", v, b])
        same_outputs(os.path.join(d, "cuda"), os.path.join(d, "host"),
                     (".mp.vcf", ".mp.gtf", ".mp.tsv"))
    check(decisions(os.path.join(d2, "cuda")) == [1], "trans gap not found")
    report["parity_s"] = {f"{os.path.basename(d)}_{e}": w
                          for (d, e), w in walls.items()}
    say("parity", "cuda == host oracle (.mp.vcf/.mp.gtf/.mp.tsv) on 2 chroms "
        "x 6 gaps and the trans two-block scenario")

    d3 = os.path.join(work, "report")
    os.makedirs(d3)
    bam3, vcf3, _ = make_two_block_scenario(d3)
    rargs = ["-c", "50", "--chunk-size", "40000", "--chunk-stride", "30000",
             "--vcf", vcf3, bam3]
    methreport(["-o", os.path.join(d3, "host"), "--engine", "host",
                *rargs])
    for gen in ("3", "2"):
        os.environ["POMFRET_FUSED_GEN"] = gen
        try:
            before = read_counts()
            methreport(["-o", os.path.join(d3, f"cuda{gen}"), "--engine",
                        "cuda", *rargs])
        finally:
            del os.environ["POMFRET_FUSED_GEN"]
        kernel = "loop_kernel" if gen == "3" else "score_commit_kernel"
        check(read_counts()[kernel] > before[kernel],
              f"report gen {gen} did not launch {kernel}")
        same_outputs(os.path.join(d3, f"cuda{gen}"), os.path.join(d3, "host"),
                     (".report.tsv",))
    say("report", "report --engine cuda (gens 3 and 2) == --engine host "
        "(.report.tsv) on the cis two-block scenario")

    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.",
                                                   "pomfret_tpu.kernels",
                                                   "pomfret_tpu.parallel")))
    check(not loaded, f"JAX-side modules loaded: {loaded}")

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    csrc = "pomfret_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        {"name": "loop_kernel", "route": "cuda",
         "source": csrc + "loop_kernel.cu",
         "replaces": "pomfret_tpu/kernels/engine_fused3.py:126",
         "launches": counts["loop_kernel"], "max_abs_err": kv["max_abs_err"],
         "ms": kv["ms"], "plain_ms": kv["plain_ms"]}] + [
        {"name": name, "route": "cuda", "source": csrc + f"{name}.cu",
         "replaces": f"pomfret_tpu/kernels/engine_fused.py:{line}",
         "launches": gens[gen]["kernel_launches"][name],
         "max_abs_err": kv["step_max_abs_err"][name],
         "ms": kv["step_ms"][name], "plain_ms": kv["step_plain_ms"][name]}
        for name, line, gen in (("score_kernel", 80, "1"),
                                ("score_commit_kernel", 273, "2"))]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
