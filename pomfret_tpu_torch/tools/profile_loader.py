"""Window loading alone on a cached set (tools/profile_loader.py's
counterpart).

The stages of the port's loader (kernels/engine_torch.run_jobs_batched's
_load_chunk), chromosome by chromosome over methphase's gap jobs
(coverage-derived parameters, tools.accuracy_scale.gap_jobs):
- src_init: the chromosome's ChromReadSource over the union of its gaps'
  halos (engine_torch.chrom_source);
- window: each gap's window (src.window; load_reads_given_interval where
  the native loader is absent);
- methmer: each window's site selections in both directions
  (get_methmer_sites_and_ranges).
After each stage of each chromosome it reads this process's peak RSS
(testing.peak_rss_mib: VmHWM, or ru_maxrss where the kernel has none)
and VmRSS (the largest seen right after a call of the stage). It prints
the JAX tool's wall / reads / us-per-read line and the stage seconds, and
writes a JSON record (--out, default chiprun_out/profile_loader.json of
the checkout) with the host's core count and, where nvidia-smi answers,
the card's name and power limit. A host tool: it touches no device.

Sets come from testing.cached_dataset (made there first if missing):
--scale N is bench.py's BENCH_SCALE=N set (testing.scale_params), --dense
NOISE the dense ~220x chromosome (testing.dense_params); --blocks K cuts
either to K blocks a chromosome.

    python -m pomfret_tpu_torch.tools.profile_loader [--scale N |
        --dense NOISE] [--blocks K] [--cprofile] [--data-root DIR]
        [--out PATH]
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time

from .. import testing
from .accuracy_scale import ROOT, card_line, gap_jobs, load_gap_storage


def set_args(ap, out):
    """The set and output options both profile tools take."""
    ap.add_argument("--scale", type=int, default=1,
                    help="bench.py's BENCH_SCALE=N set (default 1)")
    ap.add_argument("--dense", type=float, default=None,
                    help="the dense ~220x chromosome at this noise level "
                         "in place of --scale's set")
    ap.add_argument("--blocks", type=int, default=0,
                    help="blocks a chromosome in place of the set's own "
                         "(smaller sets, for the CPU)")
    ap.add_argument("--cprofile", action="store_true",
                    help="run the timed part under cProfile and print the "
                         "35 largest cumulative entries")
    ap.add_argument("--data-root", default=ROOT,
                    help="sets go to <data-root>/.bench_data/ (default: "
                         "the checkout)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", out),
                    help="the JSON record (default %(default)s)")


def load_set(a):
    """(set description, BamReader, gap jobs) of the tool's set, made
    first where missing."""
    if a.dense is not None:
        params, name = testing.dense_params(a.dense), "dense_noise.bam"
    else:
        params, name = testing.scale_params(a.scale), "scale.bam"
    if a.blocks:
        params = dict(params, n_blocks=a.blocks)
    bam_path, vcf, n_gaps, made_s = testing.cached_dataset(a.data_root,
                                                           params, name)
    bam, st = load_gap_storage(bam_path, vcf)
    desc = dict(key=testing.dataset_key(params), bam=bam_path, gaps=n_gaps,
                made_s=made_s, n_blocks=params["n_blocks"],
                scale=None if a.dense is not None else a.scale,
                dense_noise=a.dense)
    return desc, bam, gap_jobs(bam_path, st)


class Marks:
    """Per chromosome and stage: this process's peak RSS after the
    stage's last call and the largest VmRSS read right after one of its
    calls, MiB."""

    def __init__(self):
        self.rows = {}

    def after(self, chrom, stage):
        row = self.rows.setdefault((chrom, stage), dict(
            chrom=chrom, stage=stage, vm_rss_mib=0.0))
        row["vm_rss_mib"] = max(row["vm_rss_mib"],
                                testing.proc_status_mib("VmRSS"))
        row["peak_rss_mib"] = testing.peak_rss_mib()

    def list(self):
        return list(self.rows.values())


def timed(run, cprofile):
    """run()'s result and wall seconds, under cProfile (its 35 largest
    cumulative entries printed) where asked."""
    if not cprofile:
        t0 = time.perf_counter()
        out = run()
        return out, time.perf_counter() - t0
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    out = run()
    pr.disable()
    wall = time.perf_counter() - t0
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(35)
    print(s.getvalue())
    return out, wall


def host():
    """This host's core count, the card's `name, power limit`, and where
    the peak RSS is read from."""
    try:
        testing.proc_status_mib("VmHWM")
        peak_from = "VmHWM"
    except (OSError, RuntimeError):
        peak_from = "ru_maxrss"
    return dict(cores=os.cpu_count(), card=card_line(),
                peak_rss_from=peak_from)


def write_record(path, rec):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def load_windows(bam, jobs, marks, timings, each):
    """Every gap window of every job, as _load_chunk loads it: per job its
    source (src_init), then each window and its two site selections, each
    (i, rs, ms_fwd, ms_bwd) handed to each(job, ...) and then dropped.
    Adds each stage's seconds to `timings`; returns the reads by job."""
    from ..core.methmer import get_methmer_sites_and_ranges
    from ..core.readset import READBACK, load_reads_given_interval
    from ..kernels.engine_torch import chrom_source
    reads = []
    for job in jobs:
        ref_name, rg, cfg = job["ref_name"], job["rg"], job["cfg"]
        t0 = time.perf_counter()
        src = chrom_source(bam, job)
        timings["src_init"] += time.perf_counter() - t0
        marks.after(ref_name, "src_init")
        n = 0
        for i in job["indices"]:
            t0 = time.perf_counter()
            if src is not None:
                rs = src.window(rg.starts[i], rg.ends[i], READBACK, None)
            else:
                rs = load_reads_given_interval(bam, ref_name, rg.starts[i],
                                               rg.ends[i], READBACK, cfg)
            timings["window"] += time.perf_counter() - t0
            marks.after(ref_name, "window")
            t0 = time.perf_counter()
            ms_fwd = get_methmer_sites_and_ranges(rs, cfg, 0)
            ms_bwd = get_methmer_sites_and_ranges(rs, cfg, 1)
            timings["methmer"] += time.perf_counter() - t0
            marks.after(ref_name, "methmer")
            n += rs.n
            each(job, i, rs, ms_fwd, ms_bwd)
        reads.append(n)
        del src
    return reads


def profile(a):
    """The tool's record: the set, the host, the wall, the window count
    and reads (by chromosome too), the stage seconds and the marks."""
    desc, bam, jobs = load_set(a)
    marks = Marks()
    timings = {"src_init": 0.0, "window": 0.0, "methmer": 0.0}
    reads, wall = timed(lambda: load_windows(
        bam, jobs, marks, timings, lambda *_: None), a.cprofile)
    n_reads = sum(reads)
    return dict(tool="profile_loader", set=desc, host=host(),
                wall_s=wall, windows=sum(len(j["indices"]) for j in jobs),
                reads=n_reads, us_per_read=1e6 * wall / max(n_reads, 1),
                reads_by_chrom={j["ref_name"]: n
                                for j, n in zip(jobs, reads)},
                stages_s=timings, memory=marks.list(),
                peak_rss_mib=testing.peak_rss_mib())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pomfret_tpu_torch.tools.profile_loader",
        description="window loading alone (ChromReadSource, windows, site "
                    "selections) on a cached set")
    set_args(ap, "profile_loader.json")
    a = ap.parse_args(argv)
    rec = profile(a)
    print(f"wall {rec['wall_s']:.2f}s  reads {rec['reads']}  "
          f"{rec['us_per_read']:.0f} us/read", flush=True)
    print({k: round(v, 2) for k, v in rec["stages_s"].items()}, flush=True)
    write_record(a.out, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
