"""pack_group alone on a cached set (tools/profile_pack.py's counterpart).

The consumer side of run_jobs_batched: each chromosome's windows are
loaded first, outside the timed part (tools.profile_loader.load_windows,
the port's loader), and grouped as the JAX tool groups them: a window
with no reads or no sites in either direction is left out, and a group
closes at --group windows (default 128) or at the chromosome's end. Then
kernels.engine_torch.pack_group (the native methmer extraction, each
lane's build_gap_device_data and pack_gap_batch) is timed alone, group by
group. The peak RSS and VmRSS are read after each chromosome's loading
and after each of its groups' packing, as profile_loader reads them. It prints the JAX tool's line and writes a
JSON record (--out, default chiprun_out/profile_pack.json of the
checkout): the set, the host's core count and card, the wall, the reads,
the stage seconds, the packed batches by (G, R, S, D, nc_cap, layout),
and the marks. A host tool: it touches no device.

    python -m pomfret_tpu_torch.tools.profile_pack [--scale N |
        --dense NOISE] [--blocks K] [--group N] [--cprofile]
        [--data-root DIR] [--out PATH]
"""
from __future__ import annotations

import argparse
import sys
import time

from .. import testing
from .profile_loader import (Marks, host, load_set, load_windows, set_args,
                             timed, write_record)


def load_groups(bam, jobs, group, marks=None):
    """[(loaded, cfg, n_cand, chromosome)] for pack_group: each job's
    windows with reads and sites in both directions, `group` at most a
    group, in gap order; and the loading's seconds by stage (src_init,
    window, methmer) and in all (load)."""
    marks = marks or Marks()
    timings = {"src_init": 0.0, "window": 0.0, "methmer": 0.0}
    groups = []
    cur = {}

    def keep(job, i, rs, ms_fwd, ms_bwd):
        if rs.n == 0 or ms_fwd.n == 0 or ms_bwd.n == 0:
            return
        loaded = cur.setdefault(job["ref_name"], [])
        loaded.append((i, rs, ms_fwd, ms_bwd))
        if len(loaded) == group:
            groups.append((cur.pop(job["ref_name"]), job["cfg"],
                           job["n_cand"], job["ref_name"]))

    t0 = time.perf_counter()
    for job in jobs:
        load_windows(bam, [job], marks, timings, keep)
        if job["ref_name"] in cur:
            groups.append((cur.pop(job["ref_name"]), job["cfg"],
                           job["n_cand"], job["ref_name"]))
        marks.after(job["ref_name"], "load")
    return groups, dict(timings, load=time.perf_counter() - t0)


def pack_groups(groups, marks, each=None):
    """pack_group on each group in turn: its seconds a group and the
    packed batches counted by shape. each(k, result), where given, sees
    group k's result before the next group is packed (a lane's runs
    arrays are views of the native library's arena, which the next
    pack_group call fills anew)."""
    from ..kernels.engine_torch import pack_group
    seconds, shapes = [], {}
    for k, (loaded, cfg, n_cand, chrom) in enumerate(groups):
        t0 = time.perf_counter()
        res = pack_group(loaded, cfg, n_cand)
        seconds.append(time.perf_counter() - t0)
        for _, b in res[1]:
            key = b.shape3 + (b.D, b.nc_cap,
                              "dense" if b.blk is None else "runs")
            shapes[key] = shapes.get(key, 0) + 1
        marks.after(chrom, "pack")
        if each is not None:
            each(k, res)
    return seconds, shapes


def profile(a):
    """The tool's record (see the module's docstring)."""
    from ..parallel import batch  # noqa: F401  (torch's import, untimed)
    desc, bam, jobs = load_set(a)
    marks = Marks()
    groups, load_s = load_groups(bam, jobs, a.group, marks)
    (seconds, shapes), wall = timed(
        lambda: pack_groups(groups, marks), a.cprofile)
    n_reads = sum(rs.n for g in groups for _, rs, _, _ in g[0])
    return dict(tool="profile_pack", set=desc, host=host(), group=a.group,
                load_stages_s=load_s, wall_s=wall, groups=len(groups),
                lanes=sum(len(g[0]) for g in groups), reads=n_reads,
                us_per_read=1e6 * wall / max(n_reads, 1),
                group_s=seconds,
                packed_shapes=[dict(G=g, R=r, S=s, D=d, nc_cap=nc,
                                    layout=lay, batches=n)
                               for (g, r, s, d, nc, lay), n in sorted(
                                   shapes.items())],
                memory=marks.list(),
                peak_rss_mib=testing.peak_rss_mib())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pomfret_tpu_torch.tools.profile_pack",
        description="pack_group alone on a cached set's windows, loaded "
                    "beforehand")
    set_args(ap, "profile_pack.json")
    ap.add_argument("--group", type=int, default=128,
                    help="windows a group (default 128)")
    a = ap.parse_args(argv)
    rec = profile(a)
    print(f"pack wall {rec['wall_s']:.2f}s  {rec['groups']} groups  "
          f"reads {rec['reads']}  {rec['us_per_read']:.0f} us/read",
          flush=True)
    write_record(a.out, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
