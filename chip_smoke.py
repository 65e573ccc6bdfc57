#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pomfret_tpu_torch) once on one GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only-kernels   # card, build and phase 3 only
                                           # (no result line)
    python3 chip_smoke.py --only-probes    # card, build and phase 3b only
    python3 chip_smoke.py --turns DIR      # phase 3b and methphase's walls
                                           # of DIR's tree (P) and this one
                                           # (C) in turns P C C P P C C P
    python3 chip_smoke.py --v3-lanes       # card, build and v3_loop at 1,
                                           # 2, 4 and 8 lanes a block
    python3 chip_smoke.py --only-dense     # card, build and phase 10 only
                                           # (no result line)

Phases, each printing one line:
 1. card: the GPU's name and power limit (nvidia-smi);
 2. build: nvcc builds the seven kernels from pomfret_tpu_torch/kernels/csrc
    while g++ builds the port's native IO library (io/native); the script
    fails unless both load;
 3. kernel vs plain: run_batch_fused3 (the loop kernel) against loop_plain
    (plain PyTorch) on the card, on an 11-trial random sweep (testing.
    fuzz_args: the CPU tests' 8 trials, a dense R=1792/D=8/NC=64 window,
    int32 ids with a table too large for shared memory, an S=100 window
    whose rows are copied with loads), on the crafted near-tie lanes
    (testing.near_tie_args), the crafted candidate-set lanes (testing.
    crafted_args), two wide candidate sets (testing.wide_args: nc_cap 528,
    and 1040, whose slot arrays stay in global memory) and on the
    bench-shape batch (G=256 lanes, D=4, R=512, S=1536); hp and stats must
    be equal (exact), and the fixtures must take both placements (all in
    shared memory; some buffers global), both slot placements and both row
    copies (bulk; loads), and each step kernel both of its placements
    (table, sums and slots' sums shared; the table global). On the same
    fixtures the per-iteration
    engines run whole loops, gen 1 (run_batch_fused, score kernel) and gen
    2 (run_batch_fused2, score-commit kernel), with every kernel step held
    against its plain version on the same inputs (testing.checked_step,
    exact); their hp and stats must equal the loop kernel's. Prints the
    loop kernel's and the plain loop's time, each step kernel's time
    against its plain version's, and the whole-loop times of gens 1, 2, 3
    at the bench shape (CUDA events). The loop kernel's time three ways:
    (a) the whole run_batch_fused3 call, (b) _seed_count_table_b alone,
    (c) the kernel alone on the device (queued behind a spin kernel), with
    its per-phase clock cycles (phase_cycles); the step kernels' device
    times the same way, each beside its bound and its share of it;
 3b. probes: the 45 entries of pomfret_tpu_torch.tools.probes (every
    variant of tools/probe_*.py) on the four probe kernels, launches counted
    from zero; each result equal to the probe's oracle, each kernel's
    outputs equal to its plain version's on the same inputs (exact, the
    ratio sums bit for bit, row_copy's staged buffer too); each entry timed
    as the entry point calls it (CUDA events: back to back,
    and queued behind a spin kernel for the device time alone), and the
    stile ratio sum's full-S and tiled-S times at (32,16,1536), range
    [128,640), with the wrapper's quotient and with __fdiv_rn (equal),
    and its device time per iteration at S = 128-2048; each entry's
    launch floor (floor_ms: the empty kernel at its grid, block and
    cluster shape, as often as the entry launches); then two row_copy and
    two v3_loop launches in flight on two streams at once, 20 times, each
    equal to its plain version; and the v3 loop's device time per
    iteration (100 -> 400 iterations at L=8, R=1024, NC=4, S = 256 and
    1536) by bulk copy and by the warp's loads;
 4a. warmup: `pomfret-tpu-torch warmup --engine cuda` on the 200-gap scale
    dataset of bench.py (generated once into .bench_data/ by the port's
    testing.py): one loop-kernel launch at max_iters=0 per packed shape;
    prints its time and the shape count;
 4. main path: `pomfret-tpu-torch methphase --engine cuda` on that dataset,
    then
    `--engine torch --device cuda` on the same card; .mp.vcf/.mp.gtf must
    be byte-identical and the loop kernel must have run; prints wall and
    reads/s;
 4b. profile: one more warm `--engine cuda` run under torch.profiler;
    prints the device busy time and idle share of its wall;
 4c. generations: the same `methphase --engine cuda` under
    POMFRET_FUSED_GEN=1, then =2; outputs byte-identical to gen 3's, the
    score kernel (gen 1) or the score-commit kernel (gen 2) launched and
    the loop kernel not; prints wall and reads/s of each;
 4d. warmup's worth: on two fresh copies of the package (nothing built,
    an empty coverage cache each), one process after another: copy a runs
    methphase --engine cuda twice, copy b warmup then methphase (outputs
    equal to copy a's); prints each process's wall;
 5. parity: `--engine cuda` against the host oracle (`--engine host`) on a
    2-chromosome x 6-gap scenario and a trans two-block scenario;
    .mp.vcf/.mp.gtf/.mp.tsv must be byte-identical;
 5b. host subcommands: varhaptag and methstat on both parity scenarios,
    bam2cram on the trans one, each exits 0 with outputs not empty; then
    `methphase --engine cuda` on that CRAM writes the .mp.vcf/.mp.gtf/
    .mp.tsv of the run on the BAM;
 5c. `methphase --profile --engine cuda` on the trans scenario: the
    torch.profiler trace under <prefix>.profile/ holds a loop_kernel CUDA
    event, and the outputs equal the run without --profile;
 6. report: `pomfret-tpu-torch report --engine cuda` under gens 3 and 2
    against `report --engine host` on the cis two-block scenario;
    .report.tsv must be byte-identical;
 7. run_gap: the single-gap engine (kernels.engine_torch.run_gap) with
    engine "cuda" against engine "torch" on the CPU and the host oracle,
    gap by gap on the parity scenarios (n_permutations 1, and 5 on each
    chromosome's first gap): decisions and per-read tags equal, and the
    loop kernel's launches, counted from zero, equal to the directions the
    cuda runs dispatched (run_gap.dispatched);
 8. processes: `methphase --engine cuda` on the 200-gap dataset in one
    fresh process, then in two processes of one gloo group sharing this
    card (POMFRET_COORDINATOR on a free loopback port,
    POMFRET_NUM_PROCS=2, POMFRET_PROC_ID=0|1; testing.run_processes):
    all exit 0, process 0's .mp.vcf/.mp.gtf are byte-identical to phase
    4's, each of the two processes launched the loop kernel; then `report
    --engine cuda` in two processes, .report.tsv == phase 6's; prints each
    process's imports, wall and stage seconds, gaps, loop-kernel launches
    and all-gather seconds and bytes;
 9. mesh: make_gap_mesh([cuda:0, cuda:0]) splits every batch into two
    shards on this card, each on a stream of its own: run_gap_batch with
    and without it on the fuzz, wide and bench-shape batches (hp and stats
    equal, one loop-kernel launch a shard), and methphase's
    run_jobs_batched call over the scale dataset run again with the mesh
    (decisions and tag maps equal; counted from zero); with several GPUs,
    production_mesh too; prints the times.
 10. dense: the dense ~220x chromosome of 36 blocks at noise 0.05
    (testing.dense_params, the first row of the JAX record's
    noise_ramp_dense; made in a spawned process while the scale dataset
    is made, after phase 3b, and waited for before phase 4a, so that no
    timed phase shares the host with it; its making time printed apart):
    `report --chunk-size 50000 --chunk-stride 15000` and then
    `methphase`, each --engine cuda against --engine torch --device cuda
    and each in a spawned process of its own (its peak RSS is its
    own run's), .report.tsv and .mp.vcf/.mp.gtf byte-identical; no
    switch, methphase cis or fail only; the correct/switch/fail counts
    beside the JAX record's (printed, not checked); one more warm
    methphase under torch.profiler (device busy time, idle share); fails
    unless a batch
    of R 1792, S 1536, D >= 32 and nc_cap 64 was packed and the loop
    kernel ran at that shape with its count table in global memory; each
    run's wall, stage seconds, window reads, packed shapes, loop-kernel
    lanes by placement and row route, peak RSS and launches, counted from
    zero; run_gap cuda == the host oracle on the first dense gap (the
    oracle's wall); the loop kernel alone on methphase's own batch (every
    gap packed as methphase packs them, checked to be the shape it
    packed), == loop_plain, its device time, iterations, loop_bound and
    its launches at that shape in the runs above.
The script then checks that no jax, pomfret_tpu or pomfret_tpu.* module
was loaded. Then a JSON line of the kernels (with each one's bound: the
larger of its bytes over the HBM rate and its operations over the f32
rate, counted from this run's inputs), and last {"ok": true, "device":
{...}}.
Any failure raises: the exit code is non-zero and the last line is absent.
Longer output (per-phase stage seconds) goes to chiprun_out/chip_smoke.json.
"""
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


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


# published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM3
# rate and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(nbytes, ops):
    """{bound_ms, bound_by, bytes, ops}: bound_ms is the larger of the
    bytes over the HBM rate and the operations over the f32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    if by_bytes >= by_ops:
        return dict(bound_ms=by_bytes, bound_by="bytes", bytes=nbytes, ops=ops)
    return dict(bound_ms=by_ops, bound_by="operations", bytes=nbytes, ops=ops)


# Operations per (candidate slot, site) scored where the slot's read holds
# a mer: one f32 ratio and one add for each of the two haplotypes.
OPS_PER_SLOT_SITE = 4


def loop_bound(t, work, stats, D):
    """Bound of one loop-kernel batch (`t`: the engines' tensors in order),
    counted from what this run's data needs (`work`, from loop_plain on the
    same inputs): the ids cells the kernel must read, each once (the
    seeded rows over their lane's sites for the seed table; per candidate
    row, the sites of the ranges it was scored over, or its whole row once
    committed), each lane's has_mmr, seed_ok and hp_init rows read once,
    hp and stats written once (the count table is made and kept on chip);
    two ratios and two adds for every (valid candidate slot, site) of its
    lane's range [lo, hi) of that iteration where the slot's read holds a
    mer (work["mer_slot_sites"]; a site without one takes no ratio)."""
    ids, has_mmr, hp_init, seed_ok = t[0], t[1], t[2], t[3]
    n_reads, n_sites = t[4].long(), t[5].long()
    seeded = (seed_ok & has_mmr & (hp_init >= 0) & (hp_init <= 1)).sum(dim=1)
    nbytes = ((work["id_cells"] + (seeded * n_sites).sum())
              * ids.element_size()
              + n_reads.sum() * (has_mmr.element_size()
                                 + seed_ok.element_size()
                                 + 2 * hp_init.element_size())
              + stats.numel() * 4 + ids.shape[0] * 8 * 4)  # scal
    ops = work["mer_slot_sites"] * OPS_PER_SLOT_SITE
    return bound(int(nbytes), int(ops))


def score_bound(args, kw):
    """Bound of one score-kernel step: cnt, sums and cids over each lane's
    site range [min_i, max_i), the ranges, and the (G, 8, NC) rows
    written; every slot scored over its lane's range."""
    cnt, sums, cids, min_i, max_i = args
    G, NC, S = cids.shape
    span = (max_i.long() - min_i.long()).clamp(min=0).sum()
    nbytes = (span * (2 * kw["D"] * 4 + 2 * 4 + NC * cids.element_size())
              + G * 2 * 4 + G * 8 * NC * 4)
    return bound(int(nbytes), int(span * NC * OPS_PER_SLOT_SITE))


def score_commit_bound(args, kw):
    """Bound of one score-commit step: the whole count table (its site
    sums give the range), cids over the range (from the same sums, by
    the plain helper), scal, cmeta, the candidates' hp read and written
    and the flags; the sums, then every slot scored over its range."""
    from pomfret_tpu_torch.kernels.engine_fused import _range_from_seed_b
    scal, cmeta, cids, cnt, hp = args
    G, NC, S = cids.shape
    D = kw["D"]
    tot = cnt.view(G, D, 2, S).sum(dim=(1, 2))
    lo, hi = _range_from_seed_b(tot, scal[:, 2], scal[:, 0], scal[:, 1],
                                scal[:, 3])
    span = (hi.long() - lo.long()).clamp(min=0).sum()
    nbytes = (cnt.numel() * 4 + span * NC * cids.element_size()
              + scal.numel() * 4 + cmeta.numel() * 4 + 2 * G * NC * 4
              + G * 8 * 4)
    return bound(int(nbytes), int(cnt.numel() + span * NC * OPS_PER_SLOT_SITE))


def phase_kernel_vs_plain(dev):
    import numpy as np
    import torch
    from pomfret_tpu_torch.kernels import engine_fused as f12
    from pomfret_tpu_torch.kernels import engine_fused3 as f3
    from pomfret_tpu_torch.parallel.batch import batch_args
    from pomfret_tpu_torch.testing import (N_FUZZ_CARD, bench_gap_batch,
                                           checked_step, crafted_args,
                                           fuzz_args, near_tie_args,
                                           wide_args)

    score = checked_step(f12.score_candidates_batch, f12.score_plain)
    step = checked_step(f12.step_fused2, f12.score_commit_plain,
                        in_place=(3, 4))

    def run_both(args, D, nc_cap, work=None):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
        hk, sk = f3.run_batch_fused3(*t, D=D, nc_cap=nc_cap)
        hpl, spl = f3.loop_plain(*t, D=D, nc_cap=nc_cap, work=work)
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
    for fn in (f3.run_batch_fused3.placements, f3.run_batch_fused3.row_routes,
               f12.score_candidates_batch.placements,
               f12.step_fused2.placements):
        fn.update({k: 0 for k in fn})
    for trial in range(N_FUZZ_CARD):
        _, _, _, err = run_both(*fuzz_args(trial))
        max_err = max(max_err, err)
    # nc_cap 528 (slot arrays shared) and 1040 (slot arrays global; both
    # step kernels at NC 1040)
    for fixture in (near_tie_args, crafted_args, lambda: wide_args(520),
                    lambda: wide_args(1030)):
        _, _, _, err = run_both(*fixture()[:3])
        max_err = max(max_err, err)
    score.first = step.first = None  # time the steps at the bench shape
    batch, n_reads = bench_gap_batch(G=256)
    G, R, S = batch.shape3
    args = batch_args(batch, 2 * R + 64)
    work = {}
    t, hk, sk, err = run_both(args, batch.D, batch.nc_cap, work)
    max_err = max(max_err, err)
    tagged = int((hk <= 1).sum())
    check(tagged > 0, "the kernel tagged no read at the bench shape")
    placements = dict(f3.run_batch_fused3.placements)
    row_routes = dict(f3.run_batch_fused3.row_routes)
    check(placements["shared"] and placements["mixed"]
          and placements["slots_shared"] and placements["slots_global"]
          and row_routes["bulk"] and row_routes["loads"],
          f"the fixtures did not take both placements, both slot placements "
          f"and both row copies: lanes by placement {placements}, by row "
          f"route {row_routes}")
    step_placements = {
        "score_kernel": dict(f12.score_candidates_batch.placements),
        "score_commit_kernel": dict(f12.step_fused2.placements)}
    check(all(p["shared"] and p["mixed"] for p in step_placements.values()),
          f"the step kernels did not take both placements: lanes by "
          f"placement {step_placements}")
    check(score.calls > 0 and step.calls > 0, "no step was checked")
    kw = dict(D=batch.D, nc_cap=batch.nc_cap)
    ms = cuda_ms(lambda: f3.run_batch_fused3(*t, **kw), 5)
    # (b) the seed table alone, (c) the kernel alone on the device, and the
    # kernel's phase breakdown
    seed_args = (t[0], t[2], t[3], t[1], batch.D)
    seed_ms = cuda_ms(lambda: f12._seed_count_table_b(*seed_args), 5)
    seed_device_ms = queued_ms(lambda: f12._seed_count_table_b(*seed_args), 5)
    device_ms = loop_kernel_device_ms(t, kw, 5)
    cycles = torch.zeros((G, 6), dtype=torch.int64, device=dev)
    f3.run_batch_fused3(*t, **kw, phase_cycles=cycles)
    torch.cuda.synchronize()
    by_phase = cycles.sum(dim=0).tolist()
    lane_iters = int(sk[:, 0].long().sum())
    phases = dict(
        cycles=dict(zip(PHASES, by_phase)),
        share={p: c / max(sum(by_phase), 1) for p, c in zip(PHASES, by_phase)},
        cycles_per_iteration=(sum(by_phase) - by_phase[0]) / max(lane_iters, 1),
        lane_iterations=lane_iters,
        max_lane_cycles=int(cycles.sum(dim=1).max()))
    plain_ms = cuda_ms(lambda: f3.loop_plain(*t, **kw), 1)
    gen_ms = {"1": cuda_ms(lambda: f12.run_batch_fused(*t, **kw), 2),
              "2": cuda_ms(lambda: f12.run_batch_fused2(*t, **kw), 2),
              "3": ms}
    # one step at the bench shape: the first iteration's inputs (the
    # score-commit step updates its copies in place from call to call)
    sa, skw = score.first
    ca, ckw = step.first
    bounds = {"loop_kernel": loop_bound(t, work, sk, batch.D),
              "score_kernel": score_bound(sa, skw),
              "score_commit_kernel": score_commit_bound(ca, ckw)}
    steps = {
        "score_kernel": (
            cuda_ms(lambda: f12.score_candidates_batch(*sa, **skw), 50),
            cuda_ms(lambda: f12.score_plain(*sa, **skw), 50),
            queued_ms(lambda: f12.score_candidates_batch(*sa, **skw), 50)),
        "score_commit_kernel": (
            cuda_ms(lambda: f12.step_fused2(*ca, **ckw), 50),
            cuda_ms(lambda: f12.score_commit_plain(*ca, **ckw), 50),
            queued_ms(lambda: f12.step_fused2(*ca, **ckw), 50))}
    iters = int(sk[:, 0].max())
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bounds=bounds,
                seed_ms=seed_ms, seed_device_ms=seed_device_ms,
                device_ms=device_ms, phases=phases, placements=placements,
                row_routes=row_routes, step_placements=step_placements,
                step_device_ms={k: v[2] for k, v in steps.items()},
                fuzz_trials=N_FUZZ_CARD, G=G, R=R, S=S, D=batch.D,
                nc_cap=batch.nc_cap, iters=iters, tagged=tagged,
                reads=G * n_reads, gen_loop_ms=gen_ms,
                step_ms={k: v[0] for k, v in steps.items()},
                step_plain_ms={k: v[1] for k, v in steps.items()},
                step_max_abs_err={"score_kernel": score.max_abs_err,
                                  "score_commit_kernel": step.max_abs_err},
                steps_checked={"score_kernel": score.calls,
                               "score_commit_kernel": step.calls})


PHASES = ("prologue", "range", "candidates", "scoring", "decide", "commit")


def loop_kernel_device_ms(t, kw, reps):
    """(c): the loop kernel alone on the device: the run_batch_fused3 call
    queued behind a spin kernel, less the queued time of the one torch op
    it launches besides the kernel (the stack of the per-lane scalars; its
    outputs are torch.empty)."""
    import torch
    from pomfret_tpu_torch.kernels import engine_fused3 as f3
    scal = [t[7], t[8], t[9], t[5], t[4], t[6], t[10], t[11]]
    return (queued_ms(lambda: f3.run_batch_fused3(*t, **kw), reps)
            - queued_ms(lambda: torch.stack(scal, dim=1), reps))


def queued_ms(fn, reps):
    """Mean device milliseconds of fn() over reps runs queued behind a
    spin kernel of ~25 ms, so the card runs them back to back while the
    host enqueues (cuda_ms also counts the host's launch cost, which is
    most of a small kernel's time). CUDA events."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# each probe kernel's TPU counterparts, the pallas_call sites it covers
PROBE_SITES = {
    "probe_row_copy": ["tools/probe_dma.py:54", "tools/probe_dma2.py:39",
                       "tools/probe_dma2.py:67", "tools/probe_dma3.py:38",
                       "tools/probe_dma4.py:36", "tools/probe_dma4.py:69",
                       "tools/probe_dma5.py:67", "tools/probe_dma6.py:56",
                       "tools/probe_v3_parts.py:106"],
    "probe_lane_vec": ["tools/probe_v3_parts.py:35", "tools/probe_v3_parts.py:55",
                       "tools/probe_v3_parts.py:75",
                       "tools/probe_v3_parts.py:132"],
    "probe_v3_loop": ["tools/probe_v3_feasibility.py:84"],
    "probe_stile": ["tools/probe_stile.py:80", "tools/probe_stile2.py:82"]}
# the entry each probe kernel is timed and bounded at in the kernels line
# (one launch each; probe_stile2's full-S launch of its two)
PROBE_AT = {"probe_row_copy": ("probe_dma2", "full3d"),
            "probe_lane_vec": ("probe_v3_parts", "whileloop"),
            "probe_v3_loop": ("probe_v3_feasibility", "main"),
            "probe_stile": ("probe_stile2", "main")}


def probe_bound(p, inputs):
    """Bound of one probe entry's launch(es) on these inputs: each input
    byte the function needs read once, each output byte written once; one
    operation per element summed or compared, two per ratio (divide, add)
    per iteration. K1: the rows copied, the row and slot of each lane, the
    lane sums and the total (no probe returns the staged buffer, so the
    timed call does not write it back)."""
    import numpy as np
    kw = p.kw
    if p.kernel == "probe_row_copy":
        src, rows = inputs["src"], inputs["rows"]
        L, R, S = src.shape
        W, NB = kw["W"], kw["NB"]
        copied = int(((rows >= 0) & (rows <= R - W)).sum())
        nbytes = copied * W * S * src.itemsize + 8 * L + 4 * L + 4
        return bound(nbytes, L * (W if kw["sum_stage"] else NB) * S)
    if p.kernel == "probe_lane_vec":
        L, Rh = inputs["hp"].shape
        return bound(L * Rh * 4 + L * 4, max(kw["n_iter"], 1) * L * Rh)
    if p.kernel == "probe_v3_loop":
        ids, hp = inputs["ids"], inputs["hp"]
        L, R, S = ids.shape
        q = np.arange(R)
        rows = {(l, min(list(q[(hp[l] == 2) & (q >= 2 * it)]) + [R - 1]))
                for it in range(kw["n_iter"]) for l in range(L)}
        return bound(hp.nbytes + len(rows) * S * 4 + L * 4,
                     kw["n_iter"] * (L * R + L * kw["NC"] * S))
    cnt, cids, ranges = inputs["cnt"], inputs["cids"], inputs["ranges"]
    B, D2, S = cnt.shape
    NC = cids.shape[1]
    span = int((ranges[:, 1] - ranges[:, 0]).clip(min=0).sum())
    site = np.arange(S)
    ok = (cids >= 0) & (cids < D2 // 2)
    c0 = np.take_along_axis(cnt[:, 0::2], np.where(ok, cids, 0), axis=1)
    keep = int((ok & (c0 > 0) & ((site >= ranges[:, :1]) &
                                 (site < ranges[:, 1:]))[:, None, :]).sum())
    nbytes = span * (NC + D2 // 2) * 4 + ranges.nbytes + B * NC * 4
    return bound(nbytes, 2 * kw["n_iter"] * keep)


def probe_times(pb, name):
    """ms, plain_ms, bound_ms and bound_by of one launch of a probe kernel
    at its PROBE_AT entry (probe_stile: the full-S launch)."""
    e = pb["entries"][" ".join(PROBE_AT[name])]
    out = {k: e[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "floor_ms")}
    if name == "probe_stile":
        st = pb["stile"][f"{PROBE_AT[name][0]} full"]
        out.update(ms=st["us_per_call"] / 1e3,
                   plain_ms=st["plain_us_per_call"] / 1e3)
    return out


def phase_probes(dev):
    """The tools/ probes on the card: every registry entry through the
    entry point's run_probe (launches counted from zero), each result
    against the probe's oracle, then each kernel's raw outputs against its
    plain version on the same inputs (exact; bit for bit for the ratio
    sums; K1's staged buffer too), the times of every entry as the entry
    point calls it beside its launch floor, the stile full-S/tiled-S times
    by either quotient, K1 and K3 on two streams at once, and K3's time
    per iteration by either row copy."""
    import numpy as np
    import torch
    from pomfret_tpu_torch.kernels import probes as kp
    from pomfret_tpu_torch.testing import (row_copy_two_streams,
                                           v3_loop_two_streams)
    from pomfret_tpu_torch.tools import probes as tp

    for fn in kp.PROBE_KERNELS.values():
        fn.launches = 0
    runs = {}
    for key, p in tp.PROBES.items():
        inputs, raw, _, ok, msg = tp.run_probe(p, dev)
        check(ok, f"{p.stem} {p.variant}: {msg}")
        runs[key] = (inputs, raw)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kp.PROBE_KERNELS.items()}
    check(all(launches.values()), f"probe kernels not launched: {launches}")

    max_err = {name: 0.0 for name in kp.PROBE_KERNELS}
    entries = {}
    for key, (inputs, _) in runs.items():
        p = tp.PROBES[key]
        t = tp.tensors(inputs, dev)
        kernel, plain_fn = tp.compared(p)
        for a, b in zip(p.call(kernel, t), p.call(plain_fn, t)):
            check(a.dtype == b.dtype and a.shape == b.shape
                  and torch.equal(a, b),
                  f"{p.stem} {p.variant}: {p.kernel} != its plain version")
            if a.numel():                # K1's buffer is empty at NB=0
                err = float((a.double() - b.double()).abs().max())
                max_err[p.kernel] = max(max_err[p.kernel], err)
        heavy = p.kernel == "probe_stile"
        fn, plain_fn = kp.PROBE_KERNELS[p.kernel], kp.PROBE_PLAIN[p.kernel]
        # the floor: the empty kernel at the entry's launch shape, as many
        # times as one call launches the kernel (stile's entries: twice)
        shape = tp.launch_shape(p, inputs)
        n0 = fn.launches
        p.call(fn, t)
        n_launch = fn.launches - n0

        def floor():
            for _ in range(n_launch):
                kp.launch_floor(dev, *shape)
        entries[f"{p.stem} {p.variant}"] = dict(
            kernel=p.kernel,
            ms=cuda_ms(lambda: p.call(fn, t), 5 if heavy else 50),
            device_ms=queued_ms(lambda: p.call(fn, t), 5 if heavy else 50),
            floor_ms=queued_ms(floor, 50),
            launch_shape=shape,
            launches_per_call=n_launch,
            plain_ms=cuda_ms(lambda: p.call(plain_fn, t), 2 if heavy else 10),
            **probe_bound(p, inputs))

    # tiled-S against full-S, each alone, at probe_stile's shape; and the
    # quotient by __fdiv_rn against the wrapper's (the same bits)
    stile = {}
    for stem in ("probe_stile", "probe_stile2"):
        p = tp.PROBES[(stem, "main")]
        t = tp.tensors(p.make(), dev)
        n_iter = p.kw["n_iter"]
        for tiled in (False, True):
            args = (t["cnt"], t["cids"], t["ranges"])

            def fn():
                return kp.stile(*args, tiled=tiled, n_iter=n_iter)

            def fdiv():
                return kp.stile_divided(*args, tiled=tiled, n_iter=n_iter,
                                        rcp=False)
            check(torch.equal(fn(), fdiv()), f"{stem}: stile with __fdiv_rn "
                  "!= stile")
            reps = 200 if n_iter == 1 else 5
            ms, dms = cuda_ms(fn, reps), queued_ms(fn, reps)
            stile[f"{stem} {'tiled' if tiled else 'full'}"] = dict(
                n_iter=n_iter, us_per_call=ms * 1e3,
                device_us_per_call=dms * 1e3,
                device_us_per_iter=dms * 1e3 / n_iter,
                fdiv_device_us_per_iter=queued_ms(fdiv, reps) * 1e3 / n_iter,
                plain_us_per_call=cuda_ms(
                    lambda: kp.stile_plain(*args, tiled=tiled, n_iter=n_iter),
                    20 if n_iter == 1 else 2) * 1e3)
    # the ratio sum's device time per iteration against the sites it
    # visits (full-S, every site in range, S = 128-2048 at B=32, NC=16):
    # the slope between 100 and 400 iterations, no launch in it
    r = np.random.default_rng(0)
    sweep = {}
    for S in (128, 512, 1024, 1536, 2048):
        args = (torch.from_numpy(r.integers(0, 5, size=(32, 8, S)).astype(
                    np.float32)).to(dev),
                torch.from_numpy(r.integers(-1, 4, size=(32, 16, S)).astype(
                    np.int32)).to(dev),
                torch.tensor([[0, S]] * 32, dtype=torch.int32, device=dev))
        us = [queued_ms(lambda: kp.stile(*args, tiled=False, n_iter=n), 5)
              * 1e3 for n in (100, 400)]
        sweep[S] = (us[1] - us[0]) / 300
    bad = row_copy_two_streams(dev, trials=20)
    check(not bad, f"row_copy on two streams at once: trials {bad} differ "
          "from the plain version")
    bad = v3_loop_two_streams(dev, trials=20)
    check(not bad, f"v3_loop on two streams at once: trials {bad} differ "
          "from the plain version")
    return dict(launches=launches, max_abs_err=max_err, entries=entries,
                stile=stile, stile_us_per_iter_by_S=sweep,
                v3_loop_us_per_iter=v3_slopes(dev), two_stream_trials=20)


def v3_slopes(dev):
    """The v3 loop's device us per iteration, the slope between 100 and 400
    iterations at (L=8, R=1024, NC=4), S = 256 and 1536, by bulk copy (the
    wrapper's) and by the warp's loads: the latency of the chain of pick,
    row copy, wait and sum; each equal to the plain version."""
    import torch
    from pomfret_tpu_torch.kernels import probes as kp
    from pomfret_tpu_torch.testing import v3_inputs
    from pomfret_tpu_torch.tools import probes as tp
    slope = {}
    for S in (256, 1536):
        c = tp.tensors(v3_inputs(8, 1024, S, S), dev)
        for route, fn in (("bulk", kp.v3_loop), ("loads", kp.v3_loop_loaded)):
            check(torch.equal(fn(c["ids"], c["hp"], NC=4, n_iter=400),
                              kp.v3_loop_plain(c["ids"], c["hp"], NC=4,
                                               n_iter=400)),
                  f"v3_loop by {route} at S={S} != its plain version")
            us = [queued_ms(lambda: fn(c["ids"], c["hp"], NC=4, n_iter=n),
                            10) * 1e3 for n in (100, 400)]
            slope[f"S={S} {route}"] = (us[1] - us[0]) / 300
    return slope


def v3_lanes(dev, order=(1, 2, 4, 8, 8, 4, 2, 1)):
    """v3_loop at 1, 2, 4 and 8 lanes a block (the plan's V3_LOOP_WARPS
    set for the run, in the given order, each reading the mean of its
    turns): the registry entry's device us a launch, equal to its plain
    version, and the chain's slopes as v3_slopes reads them."""
    import torch
    from pomfret_tpu_torch.kernels import probes as kp
    from pomfret_tpu_torch.tools import probes as tp
    p = tp.PROBES[PROBE_AT["probe_v3_loop"]]
    t = tp.tensors(p.make(), dev)
    want = p.call(kp.v3_loop_plain, t)
    keep, got = kp.V3_LOOP_WARPS, {}
    try:
        for wpb in order:
            kp.V3_LOOP_WARPS = wpb
            kp.v3_loop_plan.cache_clear()
            for a, b in zip(p.call(kp.v3_loop, t), want):
                check(torch.equal(a, b), f"v3_loop at {wpb} lanes a block "
                      "!= its plain version")
            r = dict(registry_device_us=queued_ms(
                lambda: p.call(kp.v3_loop, t), 50) * 1e3, **v3_slopes(dev))
            got.setdefault(wpb, []).append(r)
    finally:
        kp.V3_LOOP_WARPS = keep
        kp.v3_loop_plan.cache_clear()
    return {w: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
            for w, rs in got.items()}


def phase_run_gap(scenarios, runs=("host", "torch_cpu", "cuda"),
                  first_gap=False):
    """run_gap(engine="cuda") against run_gap(engine="torch") on the CPU
    and the host oracle (`runs`, any of them), gap by gap over the
    scenarios: every gap with one seed; the first gap of each chromosome
    with 5 permutations (per-gap srand48 streams); with first_gap, the
    first scenario's first gap alone, one seed. Decisions and per-read tags
    equal; returns the counts, the directions the cuda runs dispatched and
    the walls."""
    from pomfret_tpu_torch.core.engine_host import Drand48, haplotag_region
    from pomfret_tpu_torch.core.intervals import (Storage,
                                                  merge_close_intervals,
                                                  store_raw_intervals)
    from pomfret_tpu_torch.core.methmer import get_methmer_sites_and_ranges
    from pomfret_tpu_torch.core.readset import (READBACK, MmrConfig,
                                                load_reads_given_interval)
    from pomfret_tpu_torch.io.bam import BamReader
    from pomfret_tpu_torch.io.intervals_loader import (
        IS_VCF, load_intervals_from_file)
    from pomfret_tpu_torch.kernels.engine_torch import run_gap
    from pomfret_tpu_torch.pipeline import (_derive_chrom_params,
                                            estimate_read_coverage_cached)

    walls = dict.fromkeys(runs, 0.0)
    n_runs = joined = cuda_directions = 0
    last = 1 if first_gap else None
    for bam_path, vcf in scenarios[:last]:
        st = Storage()
        load_intervals_from_file(vcf, IS_VCF, st)
        cov = estimate_read_coverage_cached(bam_path, 2)
        bam = BamReader(bam_path)
        for j, (rg, ref) in enumerate(list(zip(st.ranges,
                                               st.ref_names))[:last]):
            store_raw_intervals(rg)
            merge_close_intervals(rg, READBACK)
            cfg, n_cand = _derive_chrom_params(MmrConfig(), 14,
                                               cov.get(ref, 0), ref)
            for i in range(len(rg.starts))[:last]:
                for n_perm in ((1, 5) if i == 0 and not first_gap else (1,)):
                    got = {}
                    for run in walls:
                        rs = load_reads_given_interval(
                            bam, ref, rg.starts[i], rg.ends[i], READBACK,
                            cfg)
                        f = get_methmer_sites_and_ranges(rs, cfg, 0)
                        b = get_methmer_sites_and_ranges(rs, cfg, 1)
                        rng = Drand48.from_srand48(j * 1_000_003 + i)
                        t0 = time.perf_counter()
                        if run == "host":
                            dec = haplotag_region(rs, f, b, n_cand,
                                                  cfg.cov_for_runtime,
                                                  n_perm, rng)
                        else:
                            d0 = run_gap.dispatched
                            dec = run_gap(
                                rs, f, b, n_cand, cfg.cov_for_runtime,
                                n_perm, rng,
                                engine="torch" if run == "torch_cpu"
                                else "cuda",
                                device="cpu" if run == "torch_cpu" else None)
                            if run == "cuda":
                                cuda_directions += run_gap.dispatched - d0
                        walls[run] += time.perf_counter() - t0
                        got[run] = (dec, [r.hp for r in rs.reads])
                    check(all(v == got["cuda"] for v in got.values()),
                          f"run_gap {ref}:{rg.starts[i]}-{rg.ends[i]} "
                          f"n_permutations={n_perm}: decisions "
                          f"{ {k: v[0] for k, v in got.items()} } or tags "
                          "differ")
                    n_runs += 1
                    joined += got["cuda"][0] >= 0
    return dict(gap_runs=n_runs, joined=joined,
                cuda_directions=cuda_directions, walls_s=walls)


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


def phase_warmup_worth(base):
    """What warmup leaves for a later process. Two fresh copies of the
    package (nothing built) with an empty coverage cache each, every step
    a fresh process: copy a runs `methphase --engine cuda` twice, copy b
    runs `warmup --engine cuda` and then `methphase`. Walls of each process
    in seconds."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cold_")
    walls = {}
    for name, steps in (("a", ("methphase", "methphase")),
                        ("b", ("warmup", "methphase"))):
        tree, spool = (os.path.join(tmp, name + x) for x in ("", "_spool"))
        shutil.copytree(os.path.join(ROOT, "pomfret_tpu_torch"),
                        os.path.join(tree, "pomfret_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        os.makedirs(spool)
        env = dict(os.environ, PYTHONPATH=tree, POMFRET_SPOOL_DIR=spool)
        for i, cmd in enumerate(steps):
            argv = [sys.executable, "-m", "pomfret_tpu_torch.cli", cmd, "-o",
                    os.path.join(tmp, f"{name}{i}"), "--engine", "cuda", *base]
            t0 = time.perf_counter()
            p = subprocess.run(argv, cwd=tree, env=env, capture_output=True,
                               text=True, timeout=600)
            check(p.returncode == 0, f"{' '.join(argv)} exited "
                  f"{p.returncode}: {p.stderr[-2000:]}")
            walls[f"{name}{i + 1}_{cmd}"] = time.perf_counter() - t0
    same_outputs(os.path.join(tmp, "a1"), os.path.join(tmp, "b1"),
                 (".mp.vcf", ".mp.gtf"))
    return walls


def nonempty(*paths):
    for p in paths:
        check(os.path.getsize(p) > 0, f"{p} is empty")


def phase_host_subcommands(scenarios):
    """varhaptag and methstat on each (dir, bam, vcf) scenario, bam2cram on
    the last one, then methphase --engine cuda on its CRAM against the
    parity phase's run on its BAM (<dir>/cuda). Returns seconds by step."""
    secs = {}

    def timed(name, argv):
        t0 = time.perf_counter()
        rc = cli_main(argv)
        check(rc == 0, f"{' '.join(argv)} exited {rc}")
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0

    for d, bam, vcf in scenarios:
        out = os.path.join(d, "vh.bam")
        timed("varhaptag", ["varhaptag", "-o", out, vcf, bam])
        nonempty(out, out + ".bai", out + ".varhaptag.tsv")
        out = os.path.join(d, "ms")
        timed("methstat", ["methstat", "-o", out, "-c", "50", "--vcf", vcf,
                           bam])
        nonempty(out + ".methstat.tsv")
    cram = os.path.join(d, "x.cram")
    timed("bam2cram", ["bam2cram", bam, cram])
    nonempty(cram, cram + ".crai")
    timed("methphase_cram", ["methphase", "-o", os.path.join(d, "cram"),
                             "--engine", "cuda", "-c", "50", "--output-tsv",
                             "--vcf", vcf, cram])
    same_outputs(os.path.join(d, "cram"), os.path.join(d, "cuda"),
                 (".mp.vcf", ".mp.gtf", ".mp.tsv"))
    return secs


def phase_profile_flag(d, bam, vcf):
    """methphase --profile --engine cuda: its Chrome trace must hold a
    loop_kernel CUDA event, its outputs those of the parity phase's run
    without --profile (<d>/cuda)."""
    prefix = os.path.join(d, "prof")
    methphase(["-o", prefix, "--profile", "--engine", "cuda", "-c", "50",
               "--output-tsv", "--vcf", vcf, bam])
    trace = os.path.join(prefix + ".profile", "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    n_loop = sum("loop_kernel" in e.get("name", "") for e in kernels)
    check(n_loop > 0, f"{trace} holds no loop_kernel event "
          f"({len(kernels)} kernel events)")
    same_outputs(prefix, os.path.join(d, "cuda"),
                 (".mp.vcf", ".mp.gtf", ".mp.tsv"))
    return dict(trace=os.path.basename(trace), kernel_events=len(kernels),
                loop_kernel_events=n_loop)


def phase_processes(p_c, base, d3, rargs):
    """Several processes: `methphase --engine cuda` in two processes of
    one gloo group on this card (testing.run_processes) on the scale
    dataset, process 0's .mp.vcf/.mp.gtf against phase 4's one-process
    run (`p_c`), and in one fresh process the same way, for its walls;
    then `report --engine cuda` in two processes on phase 6's scenario
    against its one-process .report.tsv (<d3>/cuda3). Each process reports
    its imports, wall, stage seconds, gaps, launches and all-gathers."""
    from pomfret_tpu_torch.testing import run_processes
    t0 = time.perf_counter()
    one = run_processes(["methphase", "-o", p_c + "_one", "--engine", "cuda",
                         *base], 1, timeout=600)
    out = {"one_process": dict(wall_s=time.perf_counter() - t0,
                               processes=one)}
    same_outputs(p_c + "_one", p_c, (".mp.vcf", ".mp.gtf"))
    for name, argv, ref, exts in (
            ("methphase", ["methphase", "-o", p_c + "_two", "--engine",
                           "cuda", *base], p_c, (".mp.vcf", ".mp.gtf")),
            ("report", ["report", "-o", os.path.join(d3, "two"), "--engine",
                        "cuda", *rargs], os.path.join(d3, "cuda3"),
             (".report.tsv",))):
        t0 = time.perf_counter()
        procs = run_processes(argv, 2, timeout=600)
        wall = time.perf_counter() - t0
        for rank, o in enumerate(procs):
            check(o["loaded"] == [], f"{name} process {rank} loaded "
                  f"{o['loaded']}")
            check(o["dist"]["n_allgathers"] > 0,
                  f"{name} process {rank} gathered nothing: {o['dist']}")
        same_outputs(argv[2], ref, exts)
        out[name] = dict(wall_s=wall, processes=procs)
    for rank, o in enumerate(out["methphase"]["processes"]):
        check(o["kernel_launches"]["loop_kernel"] > 0 and o["gaps_decided"],
              f"methphase process {rank} launched no loop kernel: {o}")
    return out


def phase_mesh(dev, base, p_c):
    """Several devices: make_gap_mesh([cuda:0, cuda:0]) splits each batch
    into two shards on this card. run_gap_batch with and without the mesh
    on the fuzz fixtures, the wide ones and the bench-shape batch (gen 3):
    hp and stats equal, two loop-kernel launches per split batch. Then one
    `methphase --engine cuda` (no mesh) whose run_jobs_batched call is
    run again with the mesh: decisions and tag maps equal; the outputs
    equal phase 4's. Where the process sees several GPUs, production_mesh
    too. Walls in seconds."""
    import numpy as np
    import torch
    from pomfret_tpu_torch.kernels import engine_fused3 as f3
    from pomfret_tpu_torch.kernels import engine_torch as et
    from pomfret_tpu_torch.parallel.batch import (make_gap_mesh,
                                                  production_mesh,
                                                  run_gap_batch_async)
    from pomfret_tpu_torch.testing import (N_FUZZ_CARD, args_batch,
                                           bench_gap_batch, fuzz_args,
                                           wide_args)

    meshes = {"two_shards": make_gap_mesh([dev, dev])}
    if torch.cuda.device_count() > 1:
        meshes["production"] = production_mesh(torch.device("cuda"))
    out = {"batch_walls_s": {}, "jobs": {}}
    batches = [args_batch(*fuzz_args(t)) for t in range(N_FUZZ_CARD)]
    batches += [args_batch(*wide_args(n)) for n in (520, 1030)]
    bench, _ = bench_gap_batch(G=256)
    batches.append((bench, 2 * bench.shape3[1] + 64))

    def timed(batch, max_iters, **kw):
        n0 = f3.run_batch_fused3.launches
        t0 = time.perf_counter()
        res = run_gap_batch_async(batch, max_iters, engine="cuda", **kw)
        hp = np.asarray(res)
        return hp, res.stats(), time.perf_counter() - t0, \
            f3.run_batch_fused3.launches - n0

    for mname, mesh in meshes.items():
        for k, (batch, max_iters) in enumerate(batches):
            hp, st, w1, n1 = timed(batch, max_iters, device=dev)
            hp2, st2, w2, n2 = timed(batch, max_iters, mesh=mesh)
            check(np.array_equal(hp, hp2) and np.array_equal(st, st2),
                  f"{mname}: split batch {k} != unsplit (hp or stats)")
            check((n1, n2) == (1, len(mesh)), f"{mname}: batch {k} launched "
                  f"the loop kernel {n1} and {n2} times")
        out["batch_walls_s"][mname] = dict(bench_whole=w1, bench_split=w2)

    real = et.run_jobs_batched

    def both(st, bam, jobs, *a, **kw):
        """The pipeline's call, then the same call split over each mesh."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = real(st, bam, jobs, *a, **kw)
        out["jobs"]["no_mesh_s"] = time.perf_counter() - t0
        for mname, mesh in meshes.items():
            n0 = f3.run_batch_fused3.launches
            t0 = time.perf_counter()
            got = real(st, bam, jobs, *a, **dict(kw, mesh=mesh))
            out["jobs"][mname] = dict(
                wall_s=time.perf_counter() - t0,
                launches=f3.run_batch_fused3.launches - n0)
            check(got == ref, f"run_jobs_batched over the {mname} mesh: "
                  "decisions or tag maps differ")
        out["jobs"]["gaps"] = sum(len(j["indices"]) for j in jobs)
        return ref

    os.environ["POMFRET_NO_MESH"] = "1"  # the pipeline's own call: no mesh
    et.run_jobs_batched = both
    try:
        methphase(["-o", p_c + "_mesh", "--engine", "cuda", *base])
    finally:
        et.run_jobs_batched = real
        del os.environ["POMFRET_NO_MESH"]
    same_outputs(p_c + "_mesh", p_c, (".mp.vcf", ".mp.gtf"))
    return out


# phase 10: the dense chromosome at the first noise level of the JAX
# record's noise_ramp_dense
DENSE_NOISE = 0.05


def is_dense(s):
    """A packed or launched shape of the dense windows' buckets."""
    return (s["R"], s["S"], s["nc_cap"]) == (1792, 1536, 64) and s["D"] >= 32


def shape_key(s):
    return s["G"], s["R"], s["S"], s["D"], s["nc_cap"]


def _dense_run(dev, cmd, args):
    from pomfret_tpu_torch.tools.accuracy_scale import counted
    zero_counts()
    rc, wall, row = counted(lambda: cli_main([cmd, *args]), dev)
    check(rc == 0, f"{cmd} {' '.join(args)} exited {rc}")
    return dict(row, wall_s=wall, kernel_launches=read_counts())


def dense_run(dev, cmd, args):
    """One CLI run in a spawned process of its own (its peak RSS is the
    run's own), counted from zero there (tools.accuracy_scale.counted): its
    wall, stage seconds, window reads, packed shapes, loop-kernel lanes
    and shapes, peak RSS, and each kernel's launches."""
    from pomfret_tpu_torch.testing import Spawned
    return Spawned(_dense_run, dev, cmd, args).result(timeout=600)


def dense_batch(bam_path, vcf, dev):
    """Every gap of the dense chromosome packed as methphase packs them
    (coverage-derived parameters, one group): the loop's tensors on `dev`
    (ids densified), D and nc_cap, and the part's layout."""
    import torch
    from pomfret_tpu_torch.core.methmer import get_methmer_sites_and_ranges
    from pomfret_tpu_torch.core.readset import (READBACK,
                                                load_reads_given_interval)
    from pomfret_tpu_torch.kernels.engine_torch import pack_group
    from pomfret_tpu_torch.parallel.batch import (_LOOP_KEYS, densify_runs,
                                                  upload_gap_batch)
    from pomfret_tpu_torch.tools.accuracy_scale import (load_gap_storage,
                                                        gap_jobs)
    bam, st = load_gap_storage(bam_path, vcf)
    job = gap_jobs(bam_path, st)[0]
    rg, cfg = job["rg"], job["cfg"]
    loaded = []
    for i in job["indices"]:
        rs = load_reads_given_interval(bam, job["ref_name"], rg.starts[i],
                                       rg.ends[i], READBACK, cfg)
        loaded.append((i, rs, get_methmer_sites_and_ranges(rs, cfg, 0),
                       get_methmer_sites_and_ranges(rs, cfg, 1)))
    _, parts, _ = pack_group(loaded, cfg, job["n_cand"])
    check(len(parts) == 1, f"the dense gaps packed {len(parts)} batches")
    batch = parts[0][1]
    t = upload_gap_batch(batch, device=dev)
    ids = t["ids"] if "ids" in t else densify_runs(
        t["blk"], t["b0"], batch.S,
        torch.int8 if batch.D <= 127 else torch.int32)
    return ([ids] + [t[k] for k in _LOOP_KEYS], batch.D, batch.nc_cap,
            "dense" if batch.blk is None else "runs")


def phase_dense(dev, made, work):
    """Phase 10 on the dense chromosome (`made`: bam, vcf, gaps, making
    seconds): report, then methphase, --engine cuda against --engine torch
    on the card, each run in a process of its own, byte for byte; no
    switch, methphase cis or fail only; a batch of the dense buckets
    packed and run by the loop kernel with its count table in global
    memory; run_gap cuda == the host oracle on the first gap; the loop
    kernel alone on methphase's own batch, == loop_plain, with its device
    time, iterations, bound and its launches at that shape in the runs; a
    warm methphase under torch.profiler."""
    import torch
    from pomfret_tpu_torch.kernels import engine_fused3 as f3
    from pomfret_tpu_torch.tools.accuracy_scale import report_counts

    bam, vcf, n_gaps, made_s = made
    d = os.path.join(work, "dense")
    os.makedirs(d)
    runs = {}
    for cmd, args, exts in (
            ("report", ["--chunk-size", "50000", "--chunk-stride", "15000"],
             (".report.tsv",)),
            ("methphase", [], (".mp.vcf", ".mp.gtf"))):
        for eng in (["cuda"], ["torch", "--device", "cuda"]):
            runs[f"{cmd}_{eng[0]}"] = dense_run(dev, cmd, [
                "-o", os.path.join(d, f"{cmd}_{eng[0]}"), "--engine", *eng,
                *args, "--vcf", vcf, bam])
        same_outputs(os.path.join(d, f"{cmd}_cuda"),
                     os.path.join(d, f"{cmd}_torch"), exts)
    counts, _ = report_counts(os.path.join(d, "report_cuda.report.tsv"))
    check(counts["switch"] == 0, f"dense report: {counts}")
    dec = decisions(os.path.join(d, "methphase_cuda"))
    check(set(dec) <= {0, -1} and 0 in dec,
          f"dense methphase decisions on an all-cis set: {dec}")
    cuda = [runs["report_cuda"], runs["methphase_cuda"]]
    packed = [s for r in cuda for s in r["packed_shapes"] if is_dense(s)]
    launched = [s for r in cuda for s in r["loop_kernel"]["shapes"]
                if is_dense(s) and "table" not in s["shared"]]
    check(packed and launched, "no batch of the dense buckets (R 1792, S "
          "1536, D >= 32, nc_cap 64) was packed and run with the count "
          "table in global memory: packed " + str(
              [r["packed_shapes"] for r in cuda]) + ", launched " + str(
              [r["loop_kernel"]["shapes"] for r in cuda]))
    prof = phase_profile(["--vcf", vcf, bam])
    check(prof["launches"] > 0, "the profiled dense run launched no loop "
          "kernel")
    rg = phase_run_gap(((bam, vcf),), runs=("host", "cuda"), first_gap=True)

    t, D, nc_cap, layout = dense_batch(bam, vcf, dev)
    kw = dict(D=D, nc_cap=nc_cap)
    G, R, S = t[0].shape
    key = (G, R, S, D, nc_cap)
    check(key in {shape_key(s)
                  for s in runs["methphase_cuda"]["packed_shapes"]},
          f"the dense gaps packed {key}, methphase "
          f"{runs['methphase_cuda']['packed_shapes']}")
    hk, sk = f3.run_batch_fused3(*t, **kw)
    need = {}  # what these inputs need of the kernel, for its bound
    hpl, spl = f3.loop_plain(*t, **kw, work=need)
    check(torch.equal(hk, hpl) and torch.equal(sk, spl),
          "loop kernel != loop_plain on the dense batch")
    kernel = dict(G=G, R=R, S=S, D=D, nc_cap=nc_cap, layout=layout,
                  launches=sum(s["launches"] for r in cuda
                               for s in r["loop_kernel"]["shapes"]
                               if shape_key(s) == key),
                  shape=f3.run_batch_fused3.shapes[(G, R, S, D, nc_cap)],
                  iters=int(sk[:, 0].max()),
                  lane_iterations=int(sk[:, 0].long().sum()),
                  ms=cuda_ms(lambda: f3.run_batch_fused3(*t, **kw), 3),
                  device_ms=loop_kernel_device_ms(t, kw, 3),
                  plain_ms=cuda_ms(lambda: f3.loop_plain(*t, **kw), 1),
                  **loop_bound(t, need, sk, D))
    return dict(dataset_s=made_s, gaps=n_gaps, runs=runs,
                report_counts=counts,
                methphase_decisions={k: dec.count(k) for k in (0, 1, -1)},
                profile=prof, run_gap=rg, kernel=kernel)


def say_dense(dn, card):
    from pomfret_tpu_torch.tools.accuracy_scale import jax_record
    rec = {r["noise"]: r for r in jax_record().get(
        "noise_ramp_dense", {}).get("rows", [])}.get(DENSE_NOISE)
    c = dn["report_counts"]
    say("dense", f"dense chromosome (dense_params({DENSE_NOISE}), "
        f"{dn['gaps']} gaps) made in {dn['dataset_s']:.1f} s "
        "(0 when cached); report --engine cuda == --engine torch "
        f"--device cuda (.report.tsv): {sum(c.values())} windows, "
        f"{c['correct']} correct, {c['switch']} switch, {c['fail']} fail"
        + ("" if rec is None else
           f" (JAX engine's record: {rec['windows']} / {rec['correct']} / "
           f"{rec['switch']} / {rec['fail']})")
        + f"; methphase cuda == torch (.mp.vcf/.mp.gtf), decisions "
        f"{dn['methphase_decisions']}; {card}")
    for name, r in dn["runs"].items():
        say("dense", f"{name}: wall {r['wall_s']:.2f} s, "
            f"{r['window_reads']} window reads, peak RSS "
            f"{r['peak_rss_mib']:.0f} MiB, loop-kernel launches "
            f"{r['kernel_launches']['loop_kernel']}, packed "
            + ", ".join(f"{s['batches']} x ({s['G']},{s['R']},{s['S']}) "
                        f"D={s['D']} nc={s['nc_cap']} {s['layout']}"
                        for s in r["packed_shapes"])
            + f"; loop kernel lanes by placement "
            f"{r['loop_kernel']['placements']}, by row route "
            f"{r['loop_kernel']['row_routes']}, shapes "
            + ", ".join(f"({s['G']},{s['R']},{s['S']}) D={s['D']} "
                        f"nc={s['nc_cap']} x{s['launches']} shared "
                        f"{'+'.join(s['shared']) or 'none'}"
                        for s in r["loop_kernel"]["shapes"])
            + f"; stages {r['stages']}; {card}")
    pr = dn["profile"]
    say("dense", f"warm methphase --engine cuda on the dense chromosome "
        f"under torch.profiler: wall {pr['wall_s']:.2f} s, device busy "
        f"{pr['device_busy_s'] * 1e3:.1f} ms in {pr['device_events']} "
        f"events (idle {100 * pr['device_idle_share']:.1f}%), loop_kernel "
        f"{pr['loop_kernel_s'] * 1e3:.2f} ms; {card}")
    rg, k = dn["run_gap"], dn["kernel"]
    say("dense", f"run_gap cuda == host oracle (decisions, tags) on the "
        f"first dense gap: walls " + ", ".join(
            f"{n} {w:.1f} s" for n, w in rg["walls_s"].items())
        + f"; {card}")
    say("dense", f"loop kernel alone on methphase's batch (every gap): "
        f"({k['G']},{k['R']},{k['S']}) D={k['D']} nc={k['nc_cap']} "
        f"{k['layout']}, shared {'+'.join(k['shape']['shared'])}, "
        f"{k['launches']} launch(es) at this shape in the runs; == "
        f"loop_plain; {k['iters']} iterations max, {k['lane_iterations']} "
        f"lane iterations; whole call {k['ms']:.3f} ms, device "
        f"{k['device_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms "
        f"({k['bound_by']}), {100 * k['bound_ms'] / k['device_ms']:.2f}% "
        f"of the device time; loop_plain {k['plain_ms']:.1f} ms; {card}")


def scale_dataset():
    """bench.py's 200-gap scale dataset (testing.scale_params(1)), cached
    under .bench_data/ (same key as bench.py, so either can reuse the
    other's copy)."""
    from pomfret_tpu_torch.testing import cached_dataset, scale_params
    return cached_dataset(ROOT, scale_params(1), "scale.bam")[:3]


def dense_dataset(beside=lambda: None):
    """(bam, vcf, n_gaps, making seconds) of the dense chromosome, made in
    a spawned process while beside() runs here; returns beside()'s result
    too."""
    from pomfret_tpu_torch.testing import (Spawned, cached_dataset,
                                           dense_params)
    maker = Spawned(cached_dataset, ROOT, dense_params(DENSE_NOISE),
                    "dense_noise.bam")
    try:
        here = beside()
        return maker.result(timeout=900), here
    finally:
        maker.stop()


def cli_main(argv):
    from pomfret_tpu_torch.cli import main
    return main(argv)


def methphase(args):
    t0 = time.perf_counter()
    rc = cli_main(["methphase", *args])
    wall = time.perf_counter() - t0
    check(rc == 0, f"methphase {' '.join(args)} exited {rc}")
    return wall


def methreport(args):
    rc = cli_main(["report", *args])
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


def write_report(report, name):
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(report, f, indent=1, default=str)


def say_probes(pb, seconds, card):
    st = pb["stile"]
    say("probes", f"{len(pb['entries'])} tools/ probe entries == their "
        f"oracles and == the plain versions (max |d| "
        f"{max(pb['max_abs_err'].values())}); launches {pb['launches']}; "
        "stile at (32,16,1536), range [128,640), per call full-S / tiled-S: "
        + "; ".join(
            f"{stem} {st[stem + ' full']['us_per_call']:.1f} / "
            f"{st[stem + ' tiled']['us_per_call']:.1f} us (device "
            f"{st[stem + ' full']['device_us_per_call']:.1f} / "
            f"{st[stem + ' tiled']['device_us_per_call']:.1f} us, "
            f"{st[stem + ' full']['device_us_per_iter']:.3f} / "
            f"{st[stem + ' tiled']['device_us_per_iter']:.3f} us per "
            "iteration; by __fdiv_rn "
            f"{st[stem + ' full']['fdiv_device_us_per_iter']:.3f} / "
            f"{st[stem + ' tiled']['fdiv_device_us_per_iter']:.3f})"
            for stem in ("probe_stile", "probe_stile2"))
        + f"; {seconds:.1f} s; {card}")
    say("probes", "stile device us per iteration by S (full-S, all sites "
        "kept, B=32, NC=16): " + ", ".join(
            f"{S} {us:.4f}" for S, us in pb["stile_us_per_iter_by_S"].items())
        + f"; {card}")
    k1 = {k: e["device_ms"] * 1e3 for k, e in pb["entries"].items()
          if e["kernel"] == "probe_row_copy"}
    say("probes", "device us a launch / its launch floor (the empty "
        "kernel at the entry's grid, block and cluster shape), by kernel: "
        + "; ".join(
            f"{name[6:]} " + ", ".join(
                f"{k.split(' ', 1)[1]} {e['device_ms'] * 1e3:.2f}/"
                f"{e['floor_ms'] * 1e3:.2f}"
                for k, e in pb["entries"].items() if e["kernel"] == name)
            for name in PROBE_SITES) + f"; {card}")
    say("probes", f"row_copy: {len(k1)} entries, device "
        f"{min(k1.values()):.2f}-{max(k1.values()):.2f} us a launch "
        f"({PROBE_AT['probe_row_copy'][1]} "
        f"{k1[' '.join(PROBE_AT['probe_row_copy'])]:.2f}); two launches in "
        f"flight on two streams, {pb['two_stream_trials']} times: each "
        f"kept its own lane sums and total; {card}")
    say("probes", "v3_loop device us per "
        "iteration (slope 100 -> 400 iterations, L=8, R=1024, NC=4): "
        + ", ".join(f"{k} {v:.4f}"
                    for k, v in pb["v3_loop_us_per_iter"].items())
        + "; two v3_loop launches on two streams, "
        f"{pb['two_stream_trials']} times, each kept its own sums; {card}")


# One turn of `--turns`, run by a fresh process from the root of a tree
# (this one or another commit's, whose chip_smoke.py has phase_probes and
# methphase): the probe phase, then methphase --engine cuda on the given
# dataset once cold and `runs` times warm; one TURN line.
_TURN_MAIN = r"""
import json, os, shutil, sys, tempfile, time
sys.path.insert(0, os.getcwd())
os.environ["POMFRET_NO_HOST_FALLBACK"] = "1"
import torch
import chip_smoke as cs
bam, vcf, runs = sys.argv[1], sys.argv[2], int(sys.argv[3])
t0 = time.perf_counter()
pb = cs.phase_probes(torch.device("cuda"))
probe_s = time.perf_counter() - t0
work = tempfile.mkdtemp(prefix="turn_")
base = ["--engine", "cuda", "--vcf", vcf, bam]
cs.methphase(["-o", os.path.join(work, "cold"), *base])
walls = [cs.methphase(["-o", os.path.join(work, f"w{i}"), *base])
         for i in range(runs)]
shutil.rmtree(work)
print("TURN " + json.dumps({
    "probe_s": probe_s, "walls_s": walls,
    "entries": {k: e["device_ms"] * 1e3 for k, e in pb["entries"].items()},
    "calls": {k: e["ms"] * 1e3 for k, e in pb["entries"].items()},
    "floors": {k: e["floor_ms"] * 1e3 for k, e in pb["entries"].items()
               if "floor_ms" in e},
    "stile": {k: v["device_us_per_iter"] for k, v in pb["stile"].items()}}),
    flush=True)
"""


def turns(parent, order="PCCPPCCP", runs=3):
    """The probe phase and methphase's warm walls of this tree (C) and of
    another tree (P, e.g. the parent commit unpacked by git archive), each
    turn a fresh process, in the given order; per tree the median of each
    entry's device us, of stile's device us per iteration and of the
    walls. Writes chiprun_out/chip_turns.json."""
    import statistics
    bam, vcf, _ = scale_dataset()
    trees = {"P": os.path.abspath(parent), "C": ROOT}
    got = {"P": [], "C": []}
    for tag in order:
        p = subprocess.run([sys.executable, "-c", _TURN_MAIN, bam, vcf,
                            str(runs)], cwd=trees[tag], capture_output=True,
                           text=True, timeout=1500)
        line = [x for x in p.stdout.splitlines() if x.startswith("TURN ")]
        check(p.returncode == 0 and line, f"turn {tag} in {trees[tag]} "
              f"exited {p.returncode}: {p.stderr[-3000:]}")
        got[tag].append(json.loads(line[-1][5:]))
        say("turns", f"{tag}: probes {got[tag][-1]['probe_s']:.1f} s, "
            f"methphase walls {got[tag][-1]['walls_s']}")
    med = {}
    for tag, runs_ in got.items():
        walls = sorted(w for r in runs_ for w in r["walls_s"])
        med[tag] = dict(
            walls_s=statistics.median(walls),
            walls_quartiles=statistics.quantiles(walls, n=4)[::2],
            entries={k: statistics.median(r["entries"][k] for r in runs_)
                     for k in runs_[0]["entries"]},
            calls={k: statistics.median(r["calls"][k] for r in runs_)
                   for k in runs_[0]["calls"]},
            floors={k: statistics.median(r["floors"][k] for r in runs_)
                    for k in runs_[0].get("floors", {})},
            stile={k: statistics.median(r["stile"][k] for r in runs_)
                   for k in runs_[0]["stile"]})
    write_report(dict(order=order, trees=trees, turns=got, medians=med,
                      card=card_line()), "chip_turns.json")
    return med


def main(argv=()):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if "--turns" in argv:  # parent and this tree in turns, no result line
        med = turns(argv[argv.index("--turns") + 1])
        card = card_line()
        sys.path.insert(0, ROOT)
        from pomfret_tpu_torch.tools.probes import PROBES
        by_kernel = {}
        for k in med["C"]["entries"]:
            by_kernel.setdefault(PROBES[tuple(k.split())].kernel, []).append(k)
        for tag in ("P", "C"):
            m = med[tag]
            say("turns", f"{tag} medians: methphase {m['walls_s']:.3f} s "
                f"(quartiles {m['walls_quartiles'][0]:.3f}-"
                f"{m['walls_quartiles'][1]:.3f}); stile device us/iteration "
                + ", ".join(f"{k} {v:.4f}" for k, v in m["stile"].items())
                + "".join(
                    f"; {name[6:]} device us " + ", ".join(
                        f"{k} {m['entries'][k]:.2f}" for k in by_kernel[name])
                    for name in ("probe_row_copy", "probe_lane_vec",
                                 "probe_v3_loop"))
                + f"; {card}")
        say("turns", "whole calls, medians P / C (us): " + ", ".join(
            f"{k} {med['P']['calls'][k]:.1f} / {med['C']['calls'][k]:.1f}"
            for name in ("probe_lane_vec", "probe_v3_loop")
            for k in by_kernel[name]) + f"; {card}")
        say("turns", "C launch floors (us): " + ", ".join(
            f"{k} {v:.2f}" for k, v in med["C"]["floors"].items())
            + f"; {card}")
        return 0
    os.environ["POMFRET_NO_HOST_FALLBACK"] = "1"
    sys.path.insert(0, ROOT)
    import pomfret_tpu_torch  # noqa: F401  (absent beside a lone script)
    from pomfret_tpu_torch.io import native
    from pomfret_tpu_torch.kernels import _build
    from pomfret_tpu_torch.parallel.batch import DISPATCH_STATS
    from pomfret_tpu_torch.utils.stats import reset_stages, stage_report

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    say("card", f"{card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")

    t0 = time.perf_counter()
    # g++ builds the native IO library while nvcc builds the kernels
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        native_lib = ex.submit(native.get_lib)
        lib = _build.build()
        _build.get_lib()
        native_lib = native_lib.result()
    report["build_s"] = time.perf_counter() - t0
    check(native_lib is not None, "the port's native IO library did not "
          "build or load (host IO would run on its Python fallbacks)")
    native_path = os.path.relpath(native_lib._name, ROOT)
    check(native_path.startswith(os.path.join("pomfret_tpu_torch", "io",
                                              "native", "_build")),
          f"native IO library loaded from {native_path}")
    report["native_lib"] = native_path
    say("build", f"{os.path.relpath(lib, ROOT)} (nvcc "
        f"{' '.join(_build.NVCC_FLAGS)}) and {native_path} (g++) in "
        f"{report['build_s']:.1f} s")

    if "--only-dense" in argv:  # phase 10 alone, no result line
        report["dense"] = dn = phase_dense(
            dev, dense_dataset()[0], tempfile.mkdtemp(prefix="chip_smoke_"))
        say_dense(dn, card)
        write_report(report, "chip_smoke_dense.json")
        return 0
    if "--only-probes" in argv:  # phase 3b alone, for quick chip calls
        t0 = time.perf_counter()
        report["probes"] = pb = phase_probes(dev)
        say_probes(pb, time.perf_counter() - t0, card)
        write_report(report, "chip_smoke_probes.json")
        return 0
    if "--v3-lanes" in argv:  # v3_loop's lanes a block, no result line
        report["v3_lanes"] = got = v3_lanes(dev)
        for wpb, r in sorted(got.items()):
            say("v3-lanes", f"{wpb} lanes a block: registry device "
                f"{r['registry_device_us']:.3f} us, per iteration "
                + ", ".join(f"{k} {v:.4f}" for k, v in r.items()
                            if k != "registry_device_us") + f"; {card}")
        write_report(report, "chip_smoke_v3_lanes.json")
        return 0

    kv = phase_kernel_vs_plain(dev)
    report["kernel_vs_plain"] = kv
    say("kernel", f"kernel == plain on {kv['fuzz_trials']} fuzz trials, the "
        f"near-tie and crafted lanes and the bench shape G={kv['G']} R={kv['R']} S={kv['S']} D={kv['D']} "
        f"nc={kv['nc_cap']} ({kv['iters']} iterations max): whole call "
        f"{kv['ms']:.3f} ms, plain {kv['plain_ms']:.3f} ms on {card}")
    ph = kv["phases"]
    say("kernel", f"loop kernel at the bench shape: (a) whole "
        f"run_batch_fused3 call {kv['ms']:.4f} ms, (b) _seed_count_table_b "
        f"alone {kv['seed_ms']:.4f} ms (device {kv['seed_device_ms']:.4f} "
        f"ms), (c) the kernel alone on the device {kv['device_ms']:.4f} ms "
        f"over {kv['iters']} iterations max, {ph['cycles_per_iteration']:.0f} "
        f"cycles per lane iteration; phase shares "
        + ", ".join(f"{p} {100 * v:.1f}%" for p, v in ph["share"].items())
        + f"; lanes by placement {kv['placements']}, by row route "
        f"{kv['row_routes']}; {card}")
    sm, spm, n = kv["step_ms"], kv["step_plain_ms"], kv["steps_checked"]
    gm = kv["gen_loop_ms"]
    say("kernel", f"gens 1 and 2 == loop kernel (hp, stats) on the same "
        f"fixtures; every step == its plain version ({n['score_kernel']} "
        f"score and {n['score_commit_kernel']} score-commit steps); one "
        f"bench-shape step: score_kernel {sm['score_kernel']:.4f} ms (device "
        f"{kv['step_device_ms']['score_kernel']:.4f} ms), "
        f"score_plain {spm['score_kernel']:.4f} ms, score_commit_kernel "
        f"{sm['score_commit_kernel']:.4f} ms (device "
        f"{kv['step_device_ms']['score_commit_kernel']:.4f} ms), "
        "score_commit_plain "
        f"{spm['score_commit_kernel']:.4f} ms; whole loop at the bench shape: "
        f"gen 1 {gm['1']:.2f} ms, gen 2 {gm['2']:.2f} ms, gen 3 "
        f"{gm['3']:.3f} ms; {card}")
    for name in ("score_kernel", "score_commit_kernel"):
        b, dms = kv["bounds"][name], kv["step_device_ms"][name]
        say("kernel", f"{name}, one bench-shape step: whole call "
            f"{sm[name]:.4f} ms, device {dms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} bytes), "
            f"{100 * b['bound_ms'] / dms:.1f}% of the device time, "
            f"{100 * b['bound_ms'] / sm[name]:.1f}% of the call; lanes by "
            f"placement over the fixtures {kv['step_placements'][name]}; "
            f"{card}")
    if "--only-kernels" in argv:  # phase 3 alone, for quick chip calls
        write_report(report, "chip_smoke_kernels.json")
        return 0

    t0 = time.perf_counter()
    report["probes"] = pb = phase_probes(dev)
    say_probes(pb, time.perf_counter() - t0, card)

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.perf_counter()
    # both sets made at once, and no phase after this one timed beside a
    # maker
    dense, (bam, vcf, n_gaps) = dense_dataset(scale_dataset)
    report["dataset_s"] = time.perf_counter() - t0
    p_c, p_c2, p_t = (os.path.join(work, n) for n in ("cuda", "cuda2",
                                                       "torch"))
    base = ["--vcf", vcf, bam]
    n0 = DISPATCH_STATS["n_dispatches"]
    zero_counts()  # phase 3 called the wrappers outside the dispatch layer
    t0 = time.perf_counter()
    rc = cli_main(["warmup", "-o", os.path.join(work, "warmup"), "--engine",
                   "cuda", *base])
    check(rc == 0, f"warmup exited {rc}")
    wu = dict(wall_s=time.perf_counter() - t0,
              shapes=DISPATCH_STATS["n_dispatches"] - n0,
              loop_kernel_launches=read_counts()["loop_kernel"])
    report["warmup"] = wu
    check(wu["shapes"] > 0 and wu["loop_kernel_launches"] == wu["shapes"],
          f"warmup: {wu}")
    say("warmup", f"warmup --engine cuda on {n_gaps} gaps: {wu['wall_s']:.2f} "
        f"s, {wu['shapes']} packed shape(s), one loop-kernel launch each at "
        f"max_iters=0; {card}")
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

    report["warmup_worth"] = ww = phase_warmup_worth(base)
    say("warmup", "fresh processes on unbuilt copies of the package, empty "
        "coverage cache: " + ", ".join(f"{k} {v:.2f} s" for k, v in ww.items())
        + f"; {card}")

    from pomfret_tpu_torch.testing import (make_multichrom_multigap_scenario,
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

    report["host_subcommands_s"] = hs = phase_host_subcommands(
        ((d1, bam1, vcf1), (d2, bam2, vcf2)))
    say("host", "varhaptag, methstat (both parity scenarios) and bam2cram "
        "(trans) exit 0 with outputs; methphase --engine cuda on the CRAM == "
        "on the BAM (.mp.vcf/.mp.gtf/.mp.tsv); "
        + ", ".join(f"{k} {v:.1f} s" for k, v in hs.items()))

    report["profile_trace"] = pt = phase_profile_flag(d2, bam2, vcf2)
    say("trace", f"methphase --profile --engine cuda: {pt['trace']} holds "
        f"{pt['loop_kernel_events']} loop_kernel CUDA event(s) among "
        f"{pt['kernel_events']} kernel events; outputs == the run without "
        "--profile")

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

    # 7: the single-gap engine on the parity scenarios, counted from zero
    zero_counts()
    rg = phase_run_gap(((bam1, vcf1), (bam2, vcf2)))
    rg["kernel_launches"] = read_counts()
    report["run_gap"] = rg
    # one loop-kernel launch for each direction a cuda run dispatched
    check(0 < rg["cuda_directions"] == rg["kernel_launches"]["loop_kernel"],
          f"run_gap: {rg['kernel_launches']} for {rg['cuda_directions']} "
          f"directions dispatched in {rg['gap_runs']} gap runs")
    say("run_gap", f"run_gap --engine cuda == torch on the CPU == host "
        f"oracle (decisions and tags) on {rg['gap_runs']} gap runs "
        f"({rg['joined']} joined; n_permutations 1, and 5 on each "
        f"chromosome's first gap), {rg['kernel_launches']['loop_kernel']} "
        f"loop-kernel launches for {rg['cuda_directions']} directions "
        f"dispatched; walls "
        + ", ".join(f"{k} {v:.1f} s" for k, v in rg["walls_s"].items())
        + f"; {card}")

    # 8: two processes of one gloo group on this card
    report["processes"] = pp = phase_processes(p_c, base, d3, rargs)
    o1 = pp["one_process"]["processes"][0]
    say("processes", "methphase --engine cuda in two processes on "
        f"{n_gaps} gaps: {pp['methphase']['wall_s']:.2f} s (one fresh "
        f"process: {pp['one_process']['wall_s']:.2f} s, imports "
        f"{o1['import_s']:.2f} s, wall {o1['wall_s']:.2f} s, window_load "
        f"{o1['stages'].get('window_load', 0):.2f} s), outputs == phase "
        "4's; " + "; ".join(
            f"process {r}: imports {o['import_s']:.2f} s, wall "
            f"{o['wall_s']:.2f} s (window_load "
            f"{o['stages'].get('window_load', 0):.2f}, pack "
            f"{o['stages'].get('pack', 0):.2f}, dispatch "
            f"{o['stages'].get('dispatch', 0):.2f}, device_wait "
            f"{o['stages'].get('device_wait', 0):.2f} s), "
            f"{o['gaps_decided']} gaps, "
            f"{o['kernel_launches']['loop_kernel']} loop-kernel "
            f"launches, all-gathers {o['dist']['n_allgathers']} in "
            f"{o['dist']['allgather_s']:.4f} s, "
            f"{o['dist']['allgather_bytes']} bytes"
            for r, o in enumerate(pp["methphase"]["processes"]))
        + f"; report --engine cuda in two processes "
        f"{pp['report']['wall_s']:.2f} s, .report.tsv == phase 6's; {card}")

    # 9: two shards of each batch on this card, counted from zero
    zero_counts()
    report["mesh"] = mp = phase_mesh(dev, base, p_c)
    mp["kernel_launches"] = read_counts()
    check(mp["kernel_launches"]["loop_kernel"] > 0,
          "the mesh phase launched no loop kernel")
    say("mesh", "two shards a batch on one card (make_gap_mesh([cuda:0, "
        "cuda:0])): split == unsplit (hp, stats) on the fuzz, wide and "
        "bench-shape batches, one loop-kernel launch a shard; bench shape "
        + "; ".join(f"{m} whole {w['bench_whole'] * 1e3:.2f} ms, split "
                    f"{w['bench_split'] * 1e3:.2f} ms"
                    for m, w in mp["batch_walls_s"].items())
        + f"; run_jobs_batched on {mp['jobs']['gaps']} gaps: no mesh "
        f"{mp['jobs']['no_mesh_s']:.2f} s, "
        + ", ".join(f"{m} {mp['jobs'][m]['wall_s']:.2f} s "
                    f"({mp['jobs'][m]['launches']} launches)"
                    for m in mp["batch_walls_s"])
        + f", decisions and tags equal; methphase outputs == phase 4's; "
        f"{card}")

    # 10: the dense chromosome, each run counted from zero
    report["dense"] = dn = phase_dense(dev, dense, work)
    say_dense(dn, card)

    loaded = sorted(m for m in sys.modules
                    if m in ("jax", "pomfret_tpu")
                    or m.startswith(("jax.", "pomfret_tpu.")))
    check(not loaded, f"the JAX package or jax was loaded: {loaded}")

    write_report(report, "chip_smoke.json")
    csrc = "pomfret_tpu_torch/kernels/csrc/"
    bnd = kv["bounds"]
    # library_ms is null for each: no single PyTorch call computes a greedy
    # loop, a masked ratio-sum over gathered count rows, a score-and-commit
    # step, a row copy with placement and sums, the lane-vector moves, or
    # the pick-copy-place-sum loop
    print(json.dumps({"kernels": [
        {"name": "loop_kernel", "route": "cuda",
         "source": csrc + "loop_kernel.cu",
         "replaces": "pomfret_tpu/kernels/engine_fused3.py:126",
         "launches": counts["loop_kernel"], "max_abs_err": kv["max_abs_err"],
         "ms": kv["ms"], "device_ms": kv["device_ms"],
         "plain_ms": kv["plain_ms"],
         "bound_ms": bnd["loop_kernel"]["bound_ms"],
         "bound_by": bnd["loop_kernel"]["bound_by"], "library_ms": None,
         "dense": {k: dn["kernel"][k] for k in (
             "G", "R", "S", "D", "nc_cap", "iters", "launches", "ms",
             "device_ms", "plain_ms", "bound_ms", "bound_by")}}] + [
        {"name": name, "route": "cuda", "source": csrc + f"{name}.cu",
         "replaces": f"pomfret_tpu/kernels/engine_fused.py:{line}",
         "launches": gens[gen]["kernel_launches"][name],
         "max_abs_err": kv["step_max_abs_err"][name],
         "ms": kv["step_ms"][name], "device_ms": kv["step_device_ms"][name],
         "plain_ms": kv["step_plain_ms"][name],
         "bound_ms": bnd[name]["bound_ms"], "bound_by": bnd[name]["bound_by"],
         "library_ms": None}
        for name, line, gen in (("score_kernel", 80, "1"),
                                ("score_commit_kernel", 273, "2"))] + [
        {"name": name, "route": "cuda", "source": csrc + "probe_kernels.cu",
         "replaces": ", ".join(PROBE_SITES[name]),
         "at": " ".join(PROBE_AT[name]), "launches": pb["launches"][name],
         "max_abs_err": pb["max_abs_err"][name], **probe_times(pb, name),
         "library_ms": None}
        for name in PROBE_SITES]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
