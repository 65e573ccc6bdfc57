"""Accuracy at scale on the port's engines (tools/accuracy_scale.py's
counterpart).

Three modes, each with the JAX tool's row fields; name any of them
(--cis, --trans, --noise; --cis alone when none is named). Their datasets
are all made at once, and then the modes run one after another (noise,
trans, cis):
- --cis: `report`, the reference's own accuracy benchmark
  (main_methreport, blockjoin.c:4908-5097), over the BENCH_SCALE=N
  dataset (testing.scale_params(N)): probe windows inside the phased
  blocks, each re-joined and scored correct / switch / fail;
- --trans: every gap's truth is a trans join (testing.trans_params(N));
  run_jobs_batched decides each gap, and a cis decision is a switch error;
- --noise: one dense ~220x chromosome of 36 blocks (testing.dense_params)
  per noise level, `report` at chunk size 50 kb, stride 15 kb.

Each row adds what the run did, counted from zero: the engine and device,
the dataset's making seconds (0 when cached), window reads, the packed
batches by (G, R, S, D, nc_cap, layout), the loop kernel's launches,
lanes by placement and row route and launches by shape, the stage
seconds, the peak RSS of the run's process (VmHWM, or ru_maxrss where
the kernel has no VmHWM: testing.peak_rss_mib), and the card's name
and power limit (nvidia-smi) when the run was on one. Beside each row the
JAX engine's record (the root ACCURACY_SCALE.json, read and never
written) is printed as context.

Datasets are made by testing.make_datasets under <data-root>/.bench_data/
(the key bench.py and tools/accuracy_scale.py use), all at once, their
chromosomes in one pool of spawned workers. No row runs until every set
is made, and each row
runs in a spawned process of its own: its wall is taken on a host no
maker shares, and its peak RSS is its own run's. Rows merge into --out,
by default chiprun_out/accuracy_scale.json of the checkout; each
report's .report.tsv stays beside it (accuracy_scale_cis_scale<N>.report.tsv,
accuracy_scale_noise<level>.report.tsv).

    python -m pomfret_tpu_torch.tools.accuracy_scale [--scale N]
        [--chunk-stride 40000]
    python -m pomfret_tpu_torch.tools.accuracy_scale --trans [--scale N]
    python -m pomfret_tpu_torch.tools.accuracy_scale --noise
        [--levels 0.05,0.15,0.25]
    python -m pomfret_tpu_torch.tools.accuracy_scale --cis --trans --noise
        --scale 2
    ... --engine torch --device cpu --blocks 3   # the CPU, a small set
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from .. import testing

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX_RECORD = os.path.join(ROOT, "ACCURACY_SCALE.json")


def card_line():
    """The card's `name, power limit` from nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0]


def ready(device):
    """The card's context made and the kernels' library built and loaded
    before a run is timed: a spawned process starts with neither."""
    if device is not None and device.type == "cuda":
        import torch
        from ..kernels import _build
        torch.zeros(1, device=device)
        _build.get_lib()


def counted(run, device):
    """run() with the dispatch, kernel and stage counters from zero, the
    card made ready first; returns (run's result, wall seconds, the row's
    added fields)."""
    from ..kernels.engine_fused3 import run_batch_fused3 as loop
    from ..parallel.batch import DISPATCH_STATS
    from ..utils.stats import reset_stages, stage_report

    ready(device)
    DISPATCH_STATS["shapes"].clear()
    loop.placements.update({k: 0 for k in loop.placements})
    loop.row_routes.update({k: 0 for k in loop.row_routes})
    loop.shapes.clear()
    launches0, reads0 = loop.launches, DISPATCH_STATS["window_reads"]
    reset_stages()
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0
    on_card = device is not None and device.type == "cuda"
    return out, wall, dict(
        device=None if device is None else str(device),
        window_reads=DISPATCH_STATS["window_reads"] - reads0,
        packed_shapes=[dict(G=g, R=r, S=s, D=d, nc_cap=nc, layout=lay,
                            batches=n)
                       for (g, r, s, d, nc, lay), n in sorted(
                           DISPATCH_STATS["shapes"].items())],
        loop_kernel=dict(
            launches=loop.launches - launches0,
            placements=dict(loop.placements), row_routes=dict(loop.row_routes),
            shapes=[dict(G=g, R=r, S=s, D=d, nc_cap=nc, **v)
                    for (g, r, s, d, nc), v in sorted(loop.shapes.items())]),
        stages=stage_report(3),
        peak_rss_mib=testing.peak_rss_mib(),
        card=card_line() if on_card else None)


def report_counts(path):
    """({correct, switch, fail}, per chromosome) of a .report.tsv (no
    header: chrom, start, end, verdict)."""
    counts = {"correct": 0, "switch": 0, "fail": 0}
    per_chrom = {}
    with open(path) as f:
        for line in f:
            parts = line.split("\t")
            if len(parts) < 4:
                continue
            chrom, dec = parts[0], parts[3].strip()
            counts[dec] = counts.get(dec, 0) + 1
            pc = per_chrom.setdefault(chrom, {"correct": 0, "switch": 0,
                                              "fail": 0})
            pc[dec] = pc.get(dec, 0) + 1
    return counts, per_chrom


def run_report(bam, vcf, engine, device, chunk_stride, prefix):
    """`report -o prefix` at chunk size 50 kb: (counts, per chromosome,
    wall, added fields)."""
    from ..pipeline import CliOpt, main_methreport
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    opt = CliOpt(fn_vcf=vcf, fn_bam=bam, output_prefix=prefix, engine=engine,
                 chunk_size=50_000, chunk_stride=chunk_stride)
    rc, wall, extra = counted(lambda: main_methreport(opt, device=device),
                              device)
    if rc != 0:
        raise RuntimeError(f"report exited {rc}")
    counts, per_chrom = report_counts(prefix + ".report.tsv")
    return counts, per_chrom, wall, dict(extra,
                                         report_tsv=prefix + ".report.tsv")


def report_prefix(a, name):
    """Where a run's report goes: beside --out, named for its mode."""
    return os.path.join(os.path.dirname(os.path.abspath(a.out)),
                        f"accuracy_scale_{name}")


def _pct(a, b):
    return round(100.0 * a / max(b, 1), 3)


def dataset_specs(a, modes):
    """{name: (params, bam name, trans_alternate)} of the modes' datasets,
    cut to --blocks blocks a chromosome where given."""
    def cut(params):
        return dict(params, n_blocks=a.blocks) if a.blocks else params
    specs = {}
    if "cis" in modes:
        specs["cis"] = (cut(testing.scale_params(a.scale)), "scale.bam", False)
    if "trans" in modes:
        specs["trans"] = (cut(testing.trans_params(a.scale)),
                          "scale_trans.bam", True)
    for noise in a.levels if "noise" in modes else ():
        specs[noise] = (cut(testing.dense_params(noise)), "dense_noise.bam",
                        False)
    return specs


def cis_row(a, params, made, engine, device):
    bam, vcf, n_gaps, made_s = made
    counts, per_chrom, wall, extra = run_report(
        bam, vcf, engine, device, a.chunk_stride,
        report_prefix(a, f"cis_scale{a.scale}"))
    correct, switch, fail = (counts["correct"], counts["switch"],
                             counts["fail"])
    n = correct + switch + fail
    return {"bench_scale": a.scale, "n_blocks": params["n_blocks"],
            "dataset_gaps": n_gaps, "chunk_stride": a.chunk_stride,
            "wall_s": round(wall, 1), "windows": n, "correct": correct,
            "switch": switch, "fail": fail,
            "correct_over_decided": _pct(correct, correct + switch),
            "correct_over_n": _pct(correct, n), "per_chrom": per_chrom,
            "engine": engine, "dataset_s": made_s, **extra}


def main_cis(a, specs, data, engine, device):
    row = testing.Spawned(cis_row, a, specs["cis"][0], data["cis"], engine,
                          device).result()
    rec = jax_record()
    if "windows" in rec:
        say(f"JAX engine's record (BENCH_SCALE={rec['bench_scale']}, "
            f"stride {rec['chunk_stride']}): {rec['windows']} windows, "
            f"{rec['correct']} correct, {rec['switch']} switch, "
            f"{rec['fail']} fail")
    return row, [row]


def load_gap_storage(bam_path, vcf):
    """(BamReader, Storage) with each chromosome's gaps as its intervals
    (tools/accuracy_scale.py _load_gap_storage)."""
    from ..core.intervals import (Storage, merge_close_intervals,
                                  store_raw_intervals)
    from ..core.readset import READBACK
    from ..io.bam import BamReader
    from ..io.intervals_loader import IS_VCF, load_intervals_from_file
    bam = BamReader(bam_path)
    st = Storage()
    load_intervals_from_file(vcf, IS_VCF, st)
    for rg in st.ranges:
        store_raw_intervals(rg)
        merge_close_intervals(rg, READBACK)
        rg.decisions = [-1] * len(rg.starts)
    return bam, st


def gap_jobs(bam_path, st):
    """methphase's gap jobs with coverage-derived parameters
    (tools/accuracy_scale.py main_trans)."""
    from ..core.readset import MmrConfig
    from ..pipeline import _derive_chrom_params, estimate_read_coverage_cached
    name2cov = estimate_read_coverage_cached(bam_path,
                                             max(2, os.cpu_count() or 2))
    jobs = []
    for job_i, rg in enumerate(st.ranges):
        ref_name = st.ref_names[job_i]
        cfg, n_cand = _derive_chrom_params(
            MmrConfig(), 14, name2cov.get(ref_name, 0), ref_name)
        jobs.append(dict(ref_name=ref_name, rg=rg, cfg=cfg, n_cand=n_cand,
                         indices=list(range(len(rg.starts))),
                         perm_key_base=job_i * 1_000_003))
    return jobs


def decide_gaps(st, bam, jobs, engine, device):
    """Each job's decisions by gap index: run_jobs_batched on a device
    engine, haplotag_region_given_bam gap by gap on the host oracle."""
    if engine != "host":
        from ..kernels.engine_torch import run_jobs_batched
        return [dec for dec, _ in run_jobs_batched(
            st, bam, jobs, engine=engine, device=device)]
    from ..pipeline import haplotag_region_given_bam
    return [{i: haplotag_region_given_bam(
                st, bam, job["ref_name"], job["rg"].starts[i],
                job["rg"].ends[i], job["cfg"], job["n_cand"])[0]
             for i in job["indices"]} for job in jobs]


def trans_tally(jobs, decisions):
    """({trans, cis_switch, fail}, per chromosome) of decisions on a
    trans-truth set: 1 is a correct trans join, 0 a switch error."""
    per_chrom = {}
    tot = {"trans": 0, "cis_switch": 0, "fail": 0}
    for job, dec in zip(jobs, decisions):
        row = {"trans": 0, "cis_switch": 0, "fail": 0}
        for i in job["indices"]:
            k = ("trans" if dec[i] == 1 else "cis_switch" if dec[i] == 0
                 else "fail")
            row[k] += 1
            tot[k] += 1
        per_chrom[job["ref_name"]] = row
    return tot, per_chrom


def trans_row(a, params, made, engine, device):
    bam_path, vcf, n_gaps, made_s = made
    bam, st = load_gap_storage(bam_path, vcf)
    jobs = gap_jobs(bam_path, st)
    decisions, wall, extra = counted(
        lambda: decide_gaps(st, bam, jobs, engine, device), device)
    tot, per_chrom = trans_tally(jobs, decisions)
    return {"bench_scale": a.scale, "n_blocks": params["n_blocks"],
            "gaps": sum(tot.values()), "wall_s": round(wall, 1),
            "decided_trans_correct": tot["trans"],
            "decided_cis_switch_errors": tot["cis_switch"],
            "fail": tot["fail"],
            "correct_over_decided": _pct(tot["trans"],
                                         tot["trans"] + tot["cis_switch"]),
            "per_chrom": per_chrom, "engine": engine, "dataset_s": made_s,
            **extra}


def main_trans(a, specs, data, engine, device):
    row = testing.Spawned(trans_row, a, specs["trans"][0], data["trans"],
                          engine, device).result()
    rec = jax_record().get("trans_sweep")
    if rec:
        say(f"JAX engine's record (BENCH_SCALE={rec['bench_scale']}): "
            f"{rec['gaps']} gaps, {rec['decided_trans_correct']} trans, "
            f"{rec['decided_cis_switch_errors']} cis (switch), "
            f"{rec['fail']} fail")
    return {"trans_sweep": row}, [row]


def noise_row(a, noise, params, made, engine, device):
    bam, vcf, _, made_s = made
    counts, _, wall, extra = run_report(bam, vcf, engine, device, 15_000,
                                        report_prefix(a, f"noise{noise}"))
    return {"noise": noise, "windows": sum(counts.values()), **counts,
            "correct_over_decided": _pct(
                counts["correct"], counts["correct"] + counts["switch"]),
            "wall_s": round(wall, 1), "n_blocks": params["n_blocks"],
            "engine": engine, "dataset_s": made_s, **extra}


def main_noise(a, specs, data, engine, device):
    record = {r["noise"]: r for r in
              jax_record().get("noise_ramp_dense", {}).get("rows", [])}
    rows = []
    for noise in a.levels:
        row = testing.Spawned(noise_row, a, noise, specs[noise][0],
                              data[noise], engine, device).result()
        rows.append(row)
        say(f"noise={noise}: {row['windows']} windows, {row['correct']} "
            f"correct, {row['switch']} switch, {row['fail']} fail, "
            f"{row['wall_s']:.1f} s")
        if noise in record:
            r = record[noise]
            say(f"JAX engine's record at noise={noise}: {r['windows']} "
                f"windows, {r['correct']} correct, {r['switch']} switch, "
                f"{r['fail']} fail")
    blocks = a.blocks or 36
    return {"noise_ramp_dense": {
        "shape": f"one ~220x chromosome (read_stagger=180), {blocks} "
                 "blocks, nocall=0.05, chunk_stride=15k",
        "rows": rows}}, rows


def jax_record():
    """The JAX engine's record (the root ACCURACY_SCALE.json), or {}."""
    if not os.path.exists(JAX_RECORD):
        return {}
    with open(JAX_RECORD) as f:
        return json.load(f)


def merge_out(path, update):
    """Merge `update` into the JSON object at `path` (made if missing)."""
    if os.path.abspath(path) == JAX_RECORD:
        raise ValueError(f"{path} is the JAX engine's record; pick --out")
    cur = {}
    if os.path.exists(path):
        with open(path) as f:
            cur = json.load(f)
    cur.update(update)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cur, f, indent=1)


def say(msg):
    print(f"[acc] {msg}", flush=True)


def main(argv=None) -> int:
    from .. import resolve_device
    ap = argparse.ArgumentParser(
        prog="python -m pomfret_tpu_torch.tools.accuracy_scale",
        description="report's correct/switch/fail at scale on the port's "
                    "engines; the JAX engine's record beside each row.")
    ap.add_argument("--cis", action="store_true",
                    help="the cis report (the default when no mode is "
                         "named)")
    ap.add_argument("--trans", action="store_true",
                    help="the trans-truth sweep")
    ap.add_argument("--noise", action="store_true",
                    help="the noise ramp on the dense chromosome")
    ap.add_argument("--scale", type=int, default=5,
                    help="BENCH_SCALE of the cis and trans sets (default 5)")
    ap.add_argument("--chunk-stride", type=int, default=40_000,
                    help="report's window stride, cis mode (default 40000)")
    ap.add_argument("--levels", default=",".join(map(str,
                                                     testing.NOISE_LEVELS)),
                    help="noise levels, --noise (default %(default)s)")
    ap.add_argument("--blocks", type=int, default=0,
                    help="blocks a chromosome in place of the dataset's "
                         "own (smaller sets for tests)")
    ap.add_argument("--engine", default="cuda",
                    help="cuda (the default), torch or host")
    ap.add_argument("--device", default=None,
                    help="where the torch engine runs (default: the CPU; "
                         "cuda for cuda)")
    ap.add_argument("--data-root", default=ROOT,
                    help="datasets go to <data-root>/.bench_data/ "
                         "(default: the checkout)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "accuracy_scale.json"),
                    help="the JSON the rows merge into (default "
                         "%(default)s)")
    a = ap.parse_args(argv)
    a.levels = [float(x) for x in a.levels.split(",")]
    try:
        engine, device = resolve_device(a.engine, a.device)
    except (RuntimeError, ValueError) as e:
        print(f"accuracy_scale: {e}", file=sys.stderr)
        return 2
    modes = [m for m in ("noise", "trans", "cis") if getattr(a, m)] or ["cis"]
    specs = dataset_specs(a, modes)
    # every dataset made (or found) at once, before any row runs
    made = testing.make_datasets(a.data_root, list(specs.values()))
    data = {name: (m["bam"], m["vcf"], m["n_gaps"], m["seconds"])
            for name, m in zip(specs, made)}
    for mode in modes:
        run = {"cis": main_cis, "trans": main_trans, "noise": main_noise}[mode]
        update, rows = run(a, specs, data, engine, device)
        merge_out(a.out, update)
        for row in rows:
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
