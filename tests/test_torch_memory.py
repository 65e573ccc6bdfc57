"""What the port holds in host memory, on the CPU (and one card test).

- run_jobs_batched lets a chromosome's source go before the next one's
  decode starts, and keeps at most POMFRET_PREFETCH + POMFRET_PIPE_DEPTH
  + 1 groups alive at once (DISPATCH_STATS groups_in_flight_max); its
  outputs are held by tests/test_torch_pipeline.py and the parity suite;
- BamReader.scan_columns, whose workers inflate slots of blocks into
  reused buffers while one walker scans them, gives the columns of the
  JAX package's whole-file scan (exact, rec_off included) at any slot
  size and number of workers, records crossing every slot's end, a record
  longer than two blocks too; it stops and gives up where that scan
  does: at a file cut inside a record, at a record shorter than its
  fixed fields, past the record cap;
- the memory timeline (testing.RssTimeline, memory_by_stage) puts each
  read of the resident set under the stages open at its time;
- on the card (marker `cuda`): uploads of the five scale-5 batch shapes in
  turn leave at most twice the largest batch pinned, and each upload
  arrives whole while the next is staged.
"""
import mmap
import struct
import threading
import weakref

import numpy as np
import pytest
import torch

from pomfret_tpu_torch import testing
from pomfret_tpu_torch.core.intervals import (Storage, merge_close_intervals,
                                              store_raw_intervals)
from pomfret_tpu_torch.core.readset import READBACK, MmrConfig
from pomfret_tpu_torch.io import native
from pomfret_tpu_torch.io.bam import BamReader
from pomfret_tpu_torch.io.bam_writer import encode_record
from pomfret_tpu_torch.io.bgzf import BGZF_EOF, BgzfWriter
from pomfret_tpu_torch.io.intervals_loader import (IS_VCF,
                                                   load_intervals_from_file)
from pomfret_tpu_torch.io.records import make_record
from pomfret_tpu_torch.kernels import engine_torch
from pomfret_tpu_torch.parallel import batch as tb
from pomfret_tpu_torch.parallel.batch import DISPATCH_STATS
from pomfret_tpu_torch.utils import stats
import torch_jax_native

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """Two chromosomes of three gaps each, in one BAM and VCF."""
    d = str(tmp_path_factory.mktemp("two_chroms"))
    bam, vcf, _ = testing.make_multichrom_multigap_scenario(
        d, n_chroms=2, n_blocks=4, read_stagger=2000)
    return bam, vcf


def _jobs(vcf, cov=25):
    """methphase's job list for `-c cov` (pipeline._blockjoin_all_chroms)."""
    st = Storage()
    load_intervals_from_file(vcf, IS_VCF, st)
    for rg in st.ranges:
        store_raw_intervals(rg)
        merge_close_intervals(rg, READBACK)
    cfg = MmrConfig(cov_known=cov, cov_for_selection=cov // 10,
                    cov_for_runtime=2 * (cov // 10))
    return st, [dict(job_i=i, ref_name=st.ref_names[i], rg=rg, cfg=cfg,
                     n_cand=cov // 4, indices=list(range(len(rg.starts))),
                     perm_key_base=i * 1_000_003)
                for i, rg in enumerate(st.ranges)]


PREFETCH, PIPE = 2, 2


@pytest.fixture(scope="module")
def pipelined(scenario):
    """run_jobs_batched over the scenario, a gap a group (six groups),
    POMFRET_PREFETCH=2, POMFRET_PIPE_DEPTH=2, each dispatch held back so
    that the producer runs as far ahead as it may: whether each earlier
    chromosome source was alive as each decode began, the groups alive at
    each dispatch, the run's most, the decisions."""
    bam, vcf = scenario
    made, alive_at_decode, seen = [], [], []
    inner_source = engine_torch.chrom_source
    inner_dispatch = tb.run_gap_batch_group_async

    def recording(bam_, job):
        alive_at_decode.append([r() is not None for r in made])
        src = inner_source(bam_, job)
        made.append(weakref.ref(src))
        return src

    def slow(*a, **kw):
        threading.Event().wait(0.05)
        seen.append(DISPATCH_STATS["groups_in_flight"])
        return inner_dispatch(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("POMFRET_NO_MESH", "1"), ("POMFRET_GAP_GROUP", "1"),
                     ("POMFRET_PREFETCH", str(PREFETCH)),
                     ("POMFRET_PIPE_DEPTH", str(PIPE))):
            mp.setenv(k, v)
        mp.setattr(engine_torch, "chrom_source", recording)
        mp.setattr(tb, "run_gap_batch_group_async", slow)
        DISPATCH_STATS["groups_in_flight_max"] = 0
        st, jobs = _jobs(vcf)
        got = engine_torch.run_jobs_batched(
            st, BamReader(bam), jobs, engine="torch",
            device=torch.device("cpu"))
    return dict(jobs=jobs, made=made, alive_at_decode=alive_at_decode,
                seen=seen, most=DISPATCH_STATS["groups_in_flight_max"],
                left=DISPATCH_STATS["groups_in_flight"], got=got)


def test_source_released_before_next_decode(pipelined):
    assert len(pipelined["made"]) == len(pipelined["jobs"]) == 2
    assert pipelined["alive_at_decode"] == [[], [False]]


def test_groups_in_flight_bounded(pipelined):
    seen = pipelined["seen"]
    assert len(seen) == 6
    assert pipelined["most"] <= PREFETCH + PIPE + 1, seen
    assert max(seen) >= 1 + PREFETCH, seen  # the producer did run ahead
    assert pipelined["left"] == 0
    assert [sorted(dec.values()) for dec, _ in pipelined["got"]] == [
        [0, 0, 0], [0, 0, 0]]


def _same_columns(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _jax_scan(bam):
    """The JAX package's whole-file scan of `bam`: its columns, or None."""
    from pomfret_tpu.io.bam import BamReader as JBam
    # here, not as the module is imported: the card runs the module's card
    # test, and the JAX package is not built there
    torch_jax_native.ready()
    return JBam(bam).scan_columns()[0]


# a slot of 1 byte is one block
@pytest.mark.parametrize("workers", [1, 2, 8])
@pytest.mark.parametrize("slot", [1, 50_000, 1 << 20, BamReader.SCAN_SLOT])
def test_scan_columns_chunked_equals_whole(scenario, slot, workers):
    bam, _ = scenario
    ref = _jax_scan(bam)
    got, buf = BamReader(bam).scan_columns(slot_bytes=slot, workers=workers)
    assert buf is None
    assert len(ref["pos"]) > 300
    _same_columns(got, ref)


@pytest.fixture(scope="module")
def long_reads(tmp_path_factory):
    """A BAM of 100 kb reads, each record longer than two BGZF blocks."""
    cfg = testing.SynthConfig(ref_len=330_000, read_len=100_000,
                              read_stagger=100_000)
    region = testing.SynthRegion(cfg)
    bam = str(tmp_path_factory.mktemp("long_reads") / "long.bam")
    region.write_bam(bam, region.make_reads())
    return bam


@pytest.mark.parametrize("workers", [1, 8])
def test_scan_columns_carries_long_records_across_slots(long_reads, workers):
    ref = _jax_scan(long_reads)
    # with one-block slots each record crosses two slot ends or more
    assert min(np.diff(ref["rec_off"])) > 2 * BgzfWriter.BLOCK
    got, _ = BamReader(long_reads).scan_columns(slot_bytes=1, workers=workers)
    _same_columns(got, ref)


def _raw_bam(path, records: bytes) -> str:
    """A BAM of one reference whose plain bytes are its header and then
    `records`, in BGZF blocks of 7,000 plain bytes: the header ends inside
    the first block, and records cross the blocks' ends."""
    name = b"chr1\0"
    hdr = (b"BAM\1" + struct.pack("<ii", 0, 1) + struct.pack("<i", len(name))
           + name + struct.pack("<i", 1_000_000))
    with open(path, "wb") as f:
        f.write(native.bgzf_deflate_all(hdr + records, chunk=7_000))
        f.write(BGZF_EOF)
    return str(path)


def _read(i: int) -> bytes:
    return encode_record(make_record(
        f"r{i}", 0, 100 * i, "ACGT" * 90, [("M", 360)],
        tags=[("HP", "i", 1 + i % 2), ("de", "f", 0.01 * (i % 7))]))


# the record of 37 bytes, under the cap's 40 a record
_TINY = struct.pack("<iiiBBHHHiiii", 33, 0, 7, 1, 60, 0, 0, 0, 0, -1, -1,
                    0) + b"\0"
FALLBACKS = {
    # cut inside its last record: the records before it
    "cut": b"".join(_read(i) for i in range(300))[:-150],
    # a record of 20 bytes, shorter than its fixed fields, ends the scan
    "short": (b"".join(_read(i) for i in range(100)) + struct.pack("<i", 20)
              + bytes(20) + b"".join(_read(i) for i in range(100, 200))),
    # 1,000 records in 37,025 plain bytes, past the cap of 925: no columns
    "cap": _TINY * 1000,
}


@pytest.mark.parametrize("slot", [1, BamReader.SCAN_SLOT])
@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_scan_columns_stops_and_gives_up_as_the_whole_file_scan(
        tmp_path, case, slot):
    bam = _raw_bam(tmp_path / f"{case}.bam", FALLBACKS[case])
    ref = _jax_scan(bam)
    got, _ = BamReader(bam).scan_columns(slot_bytes=slot, workers=2)
    if case == "cap":
        assert ref is None and got is None
        return
    assert len(ref["pos"]) == {"cut": 299, "short": 100}[case]
    _same_columns(got, ref)


def test_memory_by_stage():
    samples = [(t, m) for t, m in ((0.0, 10), (1.0, 50), (2.0, 30),
                                   (3.0, 80), (4.0, 20), (5.0, 5))]
    events = [("wl_source", "chr1", 0.5, 1.5), ("pack", "chr1", 1.8, 2.2),
              ("wl_source", "chr2", 2.5, 3.5), ("window_load", "chr2", 2.4,
                                                3.6),
              ("decide", None, 4.4, 4.6)]
    got = testing.memory_by_stage(samples, events, t0=0.0)
    assert got["peak_mib"] == 80 and got["peak_s"] == 3.0
    assert got["open_at_peak"] == ["window_load:chr2", "wl_source:chr2"]
    assert got["by_stage"] == {"wl_source": [80, 3.0], "pack": [30, 2.0],
                               "window_load": [80, 3.0]}
    assert got["by_chrom"] == {"chr1": 50, "chr2": 80}
    assert got["by_chrom_stage"] == {
        "chr1": {"wl_source": 50, "pack": 30},
        "chr2": {"wl_source": 80, "window_load": 80}}
    assert got["outside_mib"] == 20


def test_rss_timeline_reads_stage_events():
    stats.record_stage_events()
    try:
        with testing.RssTimeline(every=0.01, gauges={"one": lambda: 1}) as tl:
            with stats.stage("hold", "x"):
                # fresh pages, whatever the allocator keeps
                mem = mmap.mmap(-1, 64 << 20)
                block = np.frombuffer(mem, dtype=np.uint8)
                block[:] = 1
                threading.Event().wait(0.2)
                del block
                mem.close()
        rec = tl.record(stats.STAGE_EVENTS)
    finally:
        stats.record_stage_events(False)
    assert rec["fields"] == ["s", "rss_mib", "one"]
    assert all(s[2] == 1 for s in rec["samples"])
    assert rec["events"][0][:2] == ["hold", "x"]
    assert rec["by_stage"]["hold"][0] >= tl.start_mib + 60
    assert rec["by_chrom"]["x"] == rec["by_stage"]["hold"][0]
    assert stats.STAGE_EVENTS is None


# the five packed shapes of methphase on the scale-5 set: (G, R, S, D)
SCALE5_SHAPES = ((256, 256, 1024, 16), (256, 256, 1280, 4),
                 (256, 512, 1536, 16), (256, 512, 1792, 4),
                 (256, 1792, 1536, 8))


def _runs_batch(G, R, S, D, fill):
    """A runs-layout batch of the given shape (CB = S), every field set."""
    z = np.zeros(G, dtype=np.int32)
    return tb.GapBatch(
        ids=None, has_mmr=np.ones((G, R), bool),
        hp_init=np.full((G, R), fill % 3, np.int32),
        seed_ok=np.ones((G, R), bool), perm=np.zeros((G, R), np.int32),
        n_reads=z + R, n_sites=z + S, q_break=z, min0=z, max0=z, cov=z + 30,
        n_cand=z + 16, D=D, nc_cap=16, S=S,
        blk=np.full((G, R, S), fill, np.uint8), b0=np.zeros((G, R), np.int32))


@pytest.mark.cuda
def test_uploads_keep_pinned_memory_bounded():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    batches = [_runs_batch(*s, fill=k + 1)
               for k, s in enumerate(SCALE5_SHAPES)]
    largest = max(sum(a.nbytes for a in tb.batch_args(b, 1))
                  for b in batches)
    reserved0 = torch.cuda.host_memory_stats().get(
        "allocated_bytes.current", 0)
    worst = 0
    for _ in range(20):
        for b in batches:
            t = tb.upload_gap_batch(b, device=dev)
            pinned = (torch.cuda.host_memory_stats().get(
                "allocated_bytes.current", 0) - reserved0
                + tb.staging_bytes())
            worst = max(worst, pinned)
    torch.cuda.synchronize()
    assert worst <= 2 * largest, (worst, largest)
    # back to back, unsynchronized: each upload arrives whole
    t1 = tb.upload_gap_batch(batches[4], device=dev)
    t2 = tb.upload_gap_batch(batches[2], device=dev)
    t3 = tb.upload_gap_batch(batches[4], device=dev)
    torch.cuda.synchronize()
    for t, b in ((t1, batches[4]), (t2, batches[2]), (t3, batches[4])):
        assert bool((t["blk"] == int(b.blk[0, 0, 0])).all())
        assert torch.equal(t["hp_init"].cpu(),
                           torch.from_numpy(b.hp_init))
