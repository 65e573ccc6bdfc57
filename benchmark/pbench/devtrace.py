"""What a torch.profiler trace of the traced window says about the device.

The busy time is the union of the device events' intervals, as
chip_smoke.py's phase 4b takes it (chip_smoke.py:860-898, copied): the
events sorted by start, overlapping ones merged, the merged lengths
summed. Times are moved onto time.perf_counter()'s clock by a CPU marker
(`MARKER`, a record_function the harness opens at the window's start), so
the device's idle gaps can be set beside the port's stage events
(pomfret_tpu_torch.utils.stats.STAGE_EVENTS, on that clock).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

MARKER = "pbench.window"


def device_events(prof, t_marker: float) -> List[Tuple[float, float, str]]:
    """(start, end, name) of every device event, in seconds on
    perf_counter's clock, given the perf_counter reading taken as the
    marker opened."""
    from torch.autograd import DeviceType
    evs = list(prof.events())
    mark = [e for e in evs if e.name == MARKER
            and e.device_type == DeviceType.CPU]
    if not mark:
        raise RuntimeError(f"the trace has no {MARKER} event")
    off = t_marker - mark[0].time_range.start / 1e6
    return sorted((e.time_range.start / 1e6 + off,
                   e.time_range.end / 1e6 + off, e.name)
                  for e in evs if e.device_type == DeviceType.CUDA
                  and e.name != MARKER)  # the marker's span on the device


def merged(ivs, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the intervals, clipped to [lo, hi], as disjoint
    intervals in order."""
    out: List[List[float]] = []
    for s, t, *_ in sorted(ivs):
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy_s(ivs, lo: float, hi: float) -> float:
    return sum(t - s for s, t in merged(ivs, lo, hi))


def top_ops(ivs, lo: float, hi: float, n: int = 10):
    """The device operations that took most time in [lo, hi]: [[name (its
    first 160 characters), seconds]], at most n, the largest first."""
    by: Dict[str, float] = {}
    for s, t, name in ivs:
        s, t = max(s, lo), min(t, hi)
        if t > s:
            by[name] = by.get(name, 0.0) + (t - s)
    return [[k[:160], v]
            for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_stage(ivs, stage_events, lo: float, hi: float, n: int = 10):
    """The device's idle time in [lo, hi] by what the host was doing: for
    each stage name, the idle seconds that its stage events overlap (stages
    nest and two threads run them, so the names' seconds may add up to
    more than the idle time); "no stage" for idle time that no stage
    overlaps. [[name, seconds]], at most n, the largest first."""
    busy = merged(ivs, lo, hi)
    gaps, cur = [], lo
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = t
    if cur < hi:
        gaps.append((cur, hi))
    if not gaps:
        return []
    ga = np.array([g[0] for g in gaps])
    gb = np.array([g[1] for g in gaps])
    by: Dict[str, float] = {}
    covered = np.zeros(len(gaps), dtype=bool)
    for name, _tag, a, b in stage_events:
        ov = np.minimum(gb, b) - np.maximum(ga, a)
        hit = ov > 0
        if hit.any():
            by[name] = by.get(name, 0.0) + float(ov[hit].sum())
            covered |= hit
    outside = float((gb - ga)[~covered].sum())
    if outside > 0:
        by["no stage"] = outside
    return [[f"idle in {k}", v]
            for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
