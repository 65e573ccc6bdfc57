"""The port's spans and counters (utils.stats), on the CPU.

- spans nest: each carries its thread, its id, its parent (the span open on
  its thread as it began) and the id of the group of gaps it serves, across
  the loader thread and the main thread of run_jobs_batched with prefetch
  on; a span's self time (its length less what its children cover) is
  never negative;
- the readers of STAGE_EVENTS (the benchmark's devtrace.idle_by_stage,
  testing.memory_by_stage) unpack each event as (name, tag, entry, exit);
- with events off and no profiler nothing is kept and no profiler range
  is entered; counters add from many threads without a loss; under torch.profiler, methphase --profile's trace holds a
  CPU range named after every span of the pass, the loader thread's too;
- the native window load counts the records it parses, kept or not
  (over a whole chromosome, every record of it in the file); the
  chromosome source's segment fetch is a span on the segment pipeline's
  worker, with the group of the thread that made the source, and the
  loader's wait for it a span of its own;
- on a tiny methphase pass the counters count what they name: the
  decode's records (at least the distinct reads of the windows), the
  coverage scan's plain bytes (the BGZF blocks' ISIZE from the block the
  header ends in to the file's end), its workers (the cores the process
  may use), its slots (the block table's) and its waits for a slot (no
  more than its slots; its workers are the cores over the group's ranks,
  at least -T), the whole-BAM scans (one a miss of
  the coverage cache, none a hit), and the benchmark's five readers of
  them read a value; one process enters none of the spans and counters
  of several processes' all-gathers and manifest merge;
- the dispatch counters that spans replaced are gone.
"""
import gzip
import importlib.util
import json
import os
import pickle
import struct
import sys
import threading
import time

import pytest
import torch

from pomfret_tpu_torch import testing
from pomfret_tpu_torch.cli import main as port_main
from pomfret_tpu_torch.core.readset import ChromReadSource, MmrConfig
from pomfret_tpu_torch.io.bam import BamReader, scan_workers
from pomfret_tpu_torch.kernels import engine_torch
from pomfret_tpu_torch.parallel import distributed
from pomfret_tpu_torch.parallel.batch import DISPATCH_STATS
from pomfret_tpu_torch.pipeline import estimate_read_coverage_cached
from pomfret_tpu_torch.utils import stats

from test_torch_memory import _jobs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from pbench import devtrace  # noqa: E402

LOADER = {"window_load", "wl_source", "wl_window", "wl_materialize",
          "wl_sites", "slot_wait"}
MAIN = {"group_wait", "pack", "dispatch", "device_wait", "decide"}
# a group's spans, each on its thread
GROUP_SPANS = {"window_load", "group_wait", "pack", "dispatch",
               "device_wait", "decide"}


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """Two chromosomes of three gaps each, in one BAM and VCF."""
    d = str(tmp_path_factory.mktemp("two_chroms"))
    bam, vcf, _ = testing.make_multichrom_multigap_scenario(
        d, n_chroms=2, n_blocks=4, read_stagger=2000)
    return bam, vcf


@pytest.fixture(scope="module")
def traced(scenario):
    """run_jobs_batched over the scenario with events recorded, a gap a
    group (six groups), POMFRET_PREFETCH=2: its events and main thread."""
    bam, vcf = scenario
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("POMFRET_NO_MESH", "1"), ("POMFRET_GAP_GROUP", "1"),
                     ("POMFRET_PREFETCH", "2")):
            mp.setenv(k, v)
        st, jobs = _jobs(vcf)
        stats.record_stage_events()
        try:
            engine_torch.run_jobs_batched(st, BamReader(bam), jobs,
                                          engine="torch",
                                          device=torch.device("cpu"))
            events = list(stats.STAGE_EVENTS)
        finally:
            stats.record_stage_events(False)
    return dict(events=events, main=threading.get_native_id(), groups=6)


def test_spans_nest_with_parent_thread_and_group(traced):
    events, main = traced["events"], traced["main"]
    by_id = {e.span: e for e in events}
    assert len(by_id) == len(events) and 0 not in by_id
    for e in events:
        if e.parent:
            p = by_id[e.parent]
            assert p.thread == e.thread
            assert p[2] <= e[2] <= e[3] <= p[3], (p, e)
        if e[0] in MAIN:
            assert e.thread == main, e
        if e[0] in LOADER:
            assert e.thread != main, e
    names = {e.span: e[0] for e in events}
    parent_of = {e[0]: names.get(e.parent) for e in events}
    assert parent_of["wl_source"] == "window_load"
    assert parent_of["wl_window"] == "window_load"
    assert parent_of["wl_materialize"] == "wl_window"
    assert parent_of["wl_sites"] == "wl_window"
    assert parent_of["window_load"] is None
    # every group's path through both threads carries its id
    groups = {}
    for e in events:
        if e[0] in GROUP_SPANS | {"wl_materialize", "slot_wait"}:
            assert e.group is not None, e
            groups.setdefault(e.group, set()).add(e[0])
    assert len(groups) == traced["groups"]
    for g, seen in groups.items():
        assert GROUP_SPANS <= seen, (g, seen)


def test_self_time_never_negative(traced):
    events = traced["events"]
    children = {}
    for e in events:
        children.setdefault(e.parent, []).append(e)
    for e in events:
        kids = sorted(children.get(e.span, []), key=lambda c: c[2])
        covered, end = 0.0, e[2]
        for c in kids:
            assert c[2] >= end, (e, c)  # a thread's children do not overlap
            covered += c[3] - c[2]
            end = c[3]
        assert (e[3] - e[2]) - covered >= 0, (e, kids)


def test_readers_unpack_the_events(traced):
    events = traced["events"]
    name, tag, a, b = events[0]
    assert json.loads(json.dumps(events[0])) == [name, tag, a, b]
    back = pickle.loads(pickle.dumps(events[0]))
    assert tuple(back) == tuple(events[0])
    assert (back.thread, back.span, back.parent, back.group) == (
        events[0].thread, events[0].span, events[0].parent, events[0].group)
    lo = min(e[2] for e in events)
    hi = max(e[3] for e in events)
    busy = [(lo + 0.25 * (hi - lo), lo + 0.5 * (hi - lo), "k")]
    idle = devtrace.idle_by_stage(busy, events, lo, hi)
    assert idle and all(k.startswith("idle in ") for k, _ in idle)
    samples = [(lo + (hi - lo) * i / 20, 100.0 + i) for i in range(21)]
    mem = testing.memory_by_stage(samples, events, lo)
    assert set(mem["by_stage"]) <= {e[0] for e in events}
    assert mem["peak_mib"] == 120.0


class _Entered:
    """A stand-in for a profiler range that counts its entries."""
    n = 0

    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        _Entered.n += 1
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("events_on", [False, True])
def test_no_profiler_no_range(monkeypatch, events_on):
    import torch.autograd.profiler as ap
    assert not ap._is_profiler_enabled
    _Entered.n = 0
    monkeypatch.setattr(torch.profiler, "record_function", _Entered)
    monkeypatch.setattr(ap, "record_function", _Entered)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Entered)
    stats.record_stage_events(events_on)
    try:
        s0 = stats.STAGE_SECONDS.get("probe_outer", 0.0)
        with stats.stage("probe_outer", "x"):
            with stats.stage("probe_inner"):
                pass
        kept = stats.STAGE_EVENTS
    finally:
        stats.record_stage_events(False)
    assert _Entered.n == 0
    assert stats.STAGE_SECONDS["probe_outer"] > s0
    if events_on:
        assert [e[0] for e in kept] == ["probe_inner", "probe_outer"]
        assert kept[0].parent == kept[1].span and kept[1].parent == 0
    else:
        assert kept is None


def test_counters_add_under_threads():
    """More threads than cores and a short switch interval: no add lost."""
    n_threads, n = 4 * (os.cpu_count() or 2), 500

    def add():
        for _ in range(n):
            stats.count("probe", 1)

    stats.reset_stages()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=add) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert stats.counter_report() == {"probe": n_threads * n}
    stats.reset_stages()
    assert stats.counter_report() == {} and stats.STAGE_SECONDS == {}


def test_profile_trace_holds_every_span(scenario, tmp_path, monkeypatch):
    bam, vcf = scenario
    for k, v in (("POMFRET_NO_MESH", "1"), ("POMFRET_GAP_GROUP", "1"),
                 ("POMFRET_PREFETCH", "2"), ("POMFRET_NO_COV_CACHE", "1")):
        monkeypatch.setenv(k, v)
    prefix = str(tmp_path / "prof")
    stats.record_stage_events()
    try:
        assert port_main(["methphase", "-o", prefix, "--profile",
                          "--engine", "torch", "--vcf", vcf, bam]) == 0
        events = list(stats.STAGE_EVENTS)
    finally:
        stats.record_stage_events(False)
    with open(os.path.join(prefix + ".profile", "trace.json")) as f:
        trace = json.load(f)["traceEvents"]
    ranges = {}
    for e in trace:
        if e.get("ph") == "X":
            ranges.setdefault(e["name"], set()).add(e.get("tid"))
    spans = {e[0] for e in events}
    assert {"coverage_scan", "writers", "window_load", "pack"} <= spans
    assert spans <= set(ranges), spans - set(ranges)
    # the loader thread's spans on a thread of their own in the trace
    assert ranges["window_load"].isdisjoint(ranges["pack"])


def _isizes(path):
    """Each BGZF block's plain size (ISIZE, its last four bytes), read from
    the blocks' headers (BSIZE at bytes 16-17)."""
    with open(path, "rb") as f:
        raw = f.read()
    out, off = [], 0
    while off < len(raw):
        bsize = struct.unpack_from("<H", raw, off + 16)[0] + 1
        out.append(struct.unpack_from("<I", raw, off + bsize - 4)[0])
        off += bsize
    return out


def _header_len(path):
    """The BAM header's plain length: where the first record starts."""
    with open(path, "rb") as f:
        plain = gzip.decompress(f.read())
    assert plain[:4] == b"BAM\1"
    l_text = struct.unpack_from("<i", plain, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", plain, off)[0]
    off += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", plain, off)[0]
        off += 4 + l_name + 4
    return off


@pytest.fixture(scope="module")
def one_pass(scenario, tmp_path_factory):
    """One methphase pass (the coverage scan included) with the counters
    zeroed first and the names of every window's reads kept."""
    bam, vcf = scenario
    prefix = str(tmp_path_factory.mktemp("pass") / "out")
    names = set()
    window = ChromReadSource.window

    def named(self, *a, **kw):
        rs = window(self, *a, **kw)
        names.update(r.qname for r in rs.reads)
        return rs

    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("POMFRET_NO_MESH", "1"), ("POMFRET_PREFETCH", "2"),
                     ("POMFRET_NO_COV_CACHE", "1")):
            mp.setenv(k, v)
        mp.setattr(ChromReadSource, "window", named)
        stats.reset_stages()
        r0 = DISPATCH_STATS["window_reads"]
        t0 = time.perf_counter()
        assert port_main(["methphase", "-o", prefix, "--engine", "torch",
                          "--vcf", vcf, bam]) == 0
        window_s = time.perf_counter() - t0
        counters = stats.counter_report()
        stage_s = dict(stats.STAGE_SECONDS)
    return dict(bam=bam, counters=counters, window_s=window_s,
                stage_s=stage_s, reads=DISPATCH_STATS["window_reads"] - r0,
                names=names)


def test_source_records_cover_the_window_reads(one_pass):
    # the windows overlap here, so a read may count in several of them:
    # every read of a window was decoded, once
    assert one_pass["reads"] >= len(one_pass["names"]) > 0
    assert one_pass["counters"]["source_records"] >= len(one_pass["names"])
    assert one_pass["counters"]["source_plain_bytes"] > 0


def test_scan_plain_bytes_are_the_blocks_after_the_header(one_pass):
    isize = _isizes(one_pass["bam"])
    end, b = _header_len(one_pass["bam"]), 0
    # the block the header ends in: the reader's virtual offset of the
    # first record names it, also where the header fills it to its end
    while end > isize[b]:
        end -= isize[b]
        b += 1
    assert one_pass["counters"]["scan_plain_bytes"] == sum(isize[b:])


def _slots(path, slot_bytes):
    """The scan's slots in `path`: from the block the header ends in, runs
    of consecutive blocks of at most slot_bytes plain bytes, a block at
    least."""
    isize = _isizes(path)
    end, b, n = _header_len(path), 0, 0
    while end > isize[b]:
        end -= isize[b]
        b += 1
    while b < len(isize):
        size, b = isize[b], b + 1
        while b < len(isize) and size + isize[b] <= slot_bytes:
            size, b = size + isize[b], b + 1
        n += 1
    return n


def test_scan_counters_say_how_the_pipeline_engaged(one_pass):
    got = one_pass["counters"]
    # one process, -T 1: the cores it may run on
    assert got["scan_workers"] == len(os.sched_getaffinity(0))
    assert got["scan_slots"] == _slots(one_pass["bam"], BamReader.SCAN_SLOT)
    assert got["scan_slots"] > 1
    assert 0 <= got["scan_slot_waits"] <= got["scan_slots"]


@pytest.mark.parametrize("procs, threads, want", [(1, 1, 8), (4, 1, 2),
                                                   (16, 1, 1), (4, 16, 16)])
def test_scan_workers_share_the_cores_over_the_group(monkeypatch, procs,
                                                     threads, want):
    # 8 cores: the group's ranks share them, -T asks for more
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    monkeypatch.setattr(distributed, "process_count", lambda: procs)
    assert scan_workers(threads) == want


def test_coverage_scans_count_the_cache_misses(one_pass, scenario, tmp_path,
                                               monkeypatch):
    assert one_pass["counters"]["coverage_scans"] == 1
    assert not {"manifest_records", "manifest_records_merged"} & set(
        one_pass["counters"])
    assert not [k for k in one_pass["stage_s"]
                if k.startswith("allgather_") or k == "manifest_merge"]
    bam, _ = scenario
    monkeypatch.setenv("POMFRET_SPOOL_DIR", str(tmp_path))
    monkeypatch.delenv("POMFRET_NO_COV_CACHE", raising=False)
    stats.reset_stages()
    covs = estimate_read_coverage_cached(bam)
    assert stats.counter_report()["coverage_scans"] == 1
    assert estimate_read_coverage_cached(bam) == covs  # from the cache
    assert stats.counter_report()["coverage_scans"] == 1


def _records_by_ref(path):
    """The number of records of each reference id in a BAM, walked from its
    plain bytes."""
    with open(path, "rb") as f:
        plain = gzip.decompress(f.read())
    off, out = _header_len(path), {}
    while off + 8 <= len(plain):
        size, rid = struct.unpack_from("<ii", plain, off)
        out[rid] = out.get(rid, 0) + 1
        off += 4 + size
    return out


@pytest.mark.parametrize("chrom", ["chr1", "chr2"])
def test_window_load_counts_the_records_it_parses(scenario, chrom):
    bam, _ = scenario
    reader = BamReader(bam)
    tid = reader.ref_id(chrom)
    cols, _ = reader.fetch_window_columnar(chrom, 0, reader.ref_lens[tid],
                                           0, 0, 1.0, 100, 156)
    assert cols["n_parsed"] == _records_by_ref(bam)[tid]
    # a window of the chromosome parses fewer, and keeps no more than that
    win, _ = reader.fetch_window_columnar(chrom, 60_000, 90_000, 10, 15000,
                                          0.1, 100, 156)
    assert 0 < win["n"] <= win["n_parsed"] < cols["n_parsed"]


@pytest.mark.parametrize("pipe", [True, False])
def test_segment_fetch_is_a_span_of_the_group(scenario, monkeypatch, pipe):
    """A source in 20 kb segments: each segment's fetch is a wl_src_fetch
    span carrying the group of the thread that made the source, on the
    segment pipeline's worker (the loader's wait for it a wl_src_wait
    span) or, with the pipe off, on that thread itself; the counter
    source_records holds every record of the chromosome at least once."""
    bam, _ = scenario
    monkeypatch.setenv("POMFRET_SEG_PIPE" if pipe else "POMFRET_NO_SEG_PIPE",
                       "1")
    main = threading.get_native_id()
    gid = stats.new_id()
    stats.reset_stages()
    stats.record_stage_events()
    try:
        with stats.group(gid):
            src = ChromReadSource(BamReader(bam), "chr1",
                                  MmrConfig(cov_for_selection=5,
                                            cov_for_runtime=10),
                                  seg_len=20_000)
        events = list(stats.STAGE_EVENTS)
    finally:
        stats.record_stage_events(False)
    assert src.ok and len(src.pos)
    fetch = [e for e in events if e[0] == "wl_src_fetch"]
    wait = [e for e in events if e[0] == "wl_src_wait"]
    assert len(fetch) > 1 and all(e.group == gid for e in fetch)
    if pipe:
        assert len(wait) == len(fetch)
        assert all(e.thread == main and e.group == gid for e in wait)
        assert all(e.thread != main and e.parent == 0 for e in fetch)
    else:
        assert not wait and all(e.thread == main for e in fetch)
    n_chr1 = _records_by_ref(bam)[BamReader(bam).ref_id("chr1")]
    assert stats.counter_report()["source_records"] >= n_chr1 >= len(src.pos)


@pytest.mark.parametrize("metric", [
    "decode_reads_per_window_read", "decode_plain_mib_per_s",
    "scan_plain_mib_per_s", "group_wait_share_pct",
    "decode_plain_kib_per_window_read"])
def test_benchmark_reader_reads_the_pass(one_pass, monkeypatch, metric):
    monkeypatch.setattr(stats, "COUNTERS", dict(one_pass["counters"]))
    spec = importlib.util.spec_from_file_location(
        "m_" + metric, os.path.join(BENCH, "metrics", metric + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rec = dict(window_s=one_pass["window_s"], passes=1,
               window_reads=one_pass["reads"], stage_s=one_pass["stage_s"])
    v = mod.read(rec)
    assert v is not None and v > 0
    assert mod.read(dict(rec, window_reads=0)) is None


@pytest.mark.parametrize("key", [
    "group_intervals", "device_wait_s", "real_lanes", "prefetch_put_wait_s",
    "prefetch_get_wait_s", "prefetch_groups", "prefetch_queue_depth_sum"])
def test_removed_dispatch_keys_are_gone(traced, key):
    assert key not in DISPATCH_STATS
    for d, _, files in os.walk(os.path.join(ROOT, "pomfret_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(d, name)) as f:
                    assert key not in f.read(), os.path.join(d, name)
