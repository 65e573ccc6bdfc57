#!/usr/bin/env python3
"""The controls of the benchmark's comparison: the plain reference put in
the port's place with one thing changed, judged as a run's passes are
judged.

    python3 benchmark/control.py --workload CELL --control NAME --seeds N...

Controls (CONTROLS): bfloat16, the reference's float32 scores rounded to
bfloat16; readback25k, each window reaching 25 kb on each side of its gap
where the configuration's semantics (blockjoin.c:19) say 50 kb, the step
that would halve the window loading that takes most of a pass. For each
seed it makes the cell's set (as a run does), works out every gap with
the reference as it is and with the control, and prints, as one JSON line
a seed, the numbers check.py compares: the control's decisions, tags and
written lines against the reference's. It needs no card and the
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from pbench import check  # noqa: E402


def manifest_of(wins, got) -> list:
    """The manifest methphase would write for these windows' results."""
    return [dict(ref=c, gap_i=i, start=s, end=e, decision=r["decision"],
                 tags=r["tags"])
            for (c, s, e), r, i in zip(wins, got, _gap_indices(wins))]


def _gap_indices(wins):
    seen = {}
    for c, _, _ in wins:
        seen[c] = seen.get(c, -1) + 1
        yield seen[c]


CONTROLS = {"bfloat16": dict(precision="bfloat16"),
            "readback25k": dict(readback=25_000)}


def control(spec: dict, seed: int, cache: str, procs: int,
            name: str) -> dict:
    """One seed: the control's outputs, written where a pass writes its
    own, judged against the reference's as check.py judges a run."""
    import run as harness
    from pbench import oracle
    got = harness.make_set(spec, seed, cache)
    wins = oracle.windows(got["vcf"])
    out = dict(seed=seed, control=name, windows=len(wins))
    with tempfile.TemporaryDirectory(prefix="pbench-control-") as d:
        sides = {}
        for side, kw in (("reference", {}), ("control", CONTROLS[name])):
            t0 = time.perf_counter()
            sides[side] = check.reference(got["truth"], got["ref_len"],
                                          wins, procs, **kw)
            out[f"{side}_s"] = time.perf_counter() - t0
            check.write_outputs(got["vcf"], wins, sides[side]["windows"],
                                os.path.join(d, side))
        ctl = os.path.join(d, "control")
        with open(ctl + ".mp.manifest.jsonl", "w") as f:
            for e in manifest_of(wins, sides["control"]["windows"]):
                f.write(json.dumps(e) + "\n")
        out.update(check.compare([ctl], wins, sides["reference"],
                                 os.path.join(d, "reference")))
    return out


def main(argv=None) -> int:
    import run as harness
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", choices=sorted(CONTROLS), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--procs", type=int, default=0)
    p.add_argument("--cache", default=None,
                   help="where the sets are kept (default: the harness's)")
    a = p.parse_args(argv)
    spec = harness.load_spec(harness.ROOT, a.workload)
    procs = a.procs or max(1, (os.cpu_count() or 2) - 1)
    for seed in a.seeds:
        res = control(spec, seed, a.cache or harness.CACHE, procs,
                      a.control)
        sys.stdout.write(json.dumps(dict(workload=a.workload, **res)) + "\n")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
