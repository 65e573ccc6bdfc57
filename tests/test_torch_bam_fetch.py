"""The BAM region fetch stopped at the first BAI chunk that starts past the
region (io/bam.py chunks_before), on one chromosome of reads that span
20 kb of the reference 1.5 kb apart (testing.make_binned_bam), so that
the chunks of the 1 Mb and 8 Mb bins they fall in lie all along it:

- BamReader.fetch_window_columnar gives every column of the JAX package's
  fetch, which inflates the span of every chunk, voff included, for
  regions at the chromosome's start, across and inside its 1 Mb bins, at
  its last reads, over the whole of it and past its last read, into a
  fresh buffer and into the reused arena; the chunks it drops
  (source_chunks_pruned) are those from the first whose first record, as
  the Python reader decodes it, starts at or past the region's end; its
  plain buffer (what source_plain_bytes counts) is the span of the chunks
  it keeps, below the span of all of them where it drops one; its load
  parses one record less a chunk dropped;
- a chunk whose first record's 12 fixed bytes (block_size, refID, pos)
  cross a BGZF block's end is read right: kept where that record starts
  before the region's end, dropped where it starts past it;
- ChromReadSource over gap windows' halos, with the segment pipe on and
  off, gives every window the reads of the per-window loads (the Python
  loader's and the native one's), and its counters hold the chunks its
  fetches dropped and the plain bytes of the chunks they kept.
Tolerance: exact.
"""
import numpy as np
import pytest

import torch_jax_native
from pomfret_tpu_torch import testing
from pomfret_tpu_torch.core import readset
from pomfret_tpu_torch.io import bam as port_bam
from pomfret_tpu_torch.io.bam import BamReader, chunks_before
from pomfret_tpu_torch.io.bgzf import BgzfReader, BgzfWriter
from pomfret_tpu_torch.utils import stats

torch_jax_native.ready()

REF_LEN = 2_400_000
REGIONS = {
    "start": (0, 130_000),
    "across_1mb": (954_999, 1_085_000),
    "inside_1mb_bin": (1_300_000, 1_430_000),
    "across_2mb": (1_984_999, 2_115_000),
    "last": (2_150_000, 2_280_000),
    "whole": (0, REF_LEN),
    "past_last_read": (2_300_000, REF_LEN),
}
PRUNES = {"start", "across_1mb", "inside_1mb_bin"}  # chunks lie past these
FILTERS = (10, 1_000, 0.1, 100, 156)  # min_mapq, readlen, de_max, lo, hi
CFG = readset.MmrConfig(readlen_threshold=1_000, cov_for_selection=5,
                        cov_for_runtime=10)


@pytest.fixture(scope="module")
def binned(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("binned") / "b.bam")
    return path, testing.make_binned_bam(path, ref_len=REF_LEN)


def _first_record(rd, cb):
    return next(rd._iter_from(cb))


def _kept(rd, every, end):
    """How many chunks lead the list before the first whose first record,
    decoded by the Python reader, starts at or past `end`."""
    return next((k for k, (cb, _) in enumerate(every)
                 if _first_record(rd, cb).pos >= end), len(every))


def _span_bytes(path, chunks):
    """The plain bytes of the blocks from the chunks' first to the block
    their last ends in: one inflate of the chunks' span."""
    if not chunks:
        return 0
    offs, sizes = BgzfReader(path).block_offsets()
    hi = max(ce for _, ce in chunks)
    k0 = offs.index(min(cb for cb, _ in chunks) >> 16)
    k1 = offs.index(hi >> 16) + (1 if hi & 0xFFFF else 0)
    return sum(sizes[k0:k1])


def _same_columns(got, ref):
    assert set(got) == set(ref) | {"n_parsed"}
    n = ref["n"]
    assert got["n"] == n
    for k, v in ref.items():
        if k in ("calls", "quals"):  # arenas: the calls in use
            m = int(ref["call_off"][n]) if n else 0
            assert np.array_equal(got[k][:m], v[:m]), k
        elif isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


def _fetch(rd, beg, end, reuse):
    stats.reset_stages()
    cols, buf = rd.fetch_window_columnar("c1", beg, end, *FILTERS,
                                         reuse_buffer=reuse)
    return cols, buf, stats.counter_report()["source_chunks_pruned"]


def _check_region(path, beg, end, reuse, monkeypatch):
    """The fetch of [beg, end) against the JAX package's and against
    itself with no chunk dropped; returns the chunks it dropped."""
    from pomfret_tpu.io.bam import BamReader as JaxBamReader

    rd = BamReader(path)
    every = rd._load_index().chunks_for_region(0, beg, end)
    cols, buf, pruned = _fetch(rd, beg, end, reuse)
    ref, _ = JaxBamReader(path).fetch_window_columnar(
        "c1", beg, end, *FILTERS, reuse_buffer=reuse)
    _same_columns(cols, ref)
    kept = _kept(rd, every, end)
    assert pruned == len(every) - kept
    assert len(buf) == _span_bytes(path, every[:kept])
    union = _span_bytes(path, every)
    assert len(buf) < union if pruned else len(buf) == union
    with monkeypatch.context() as mp:
        mp.setattr(port_bam, "chunks_before", lambda raw, c, tid, end: c)
        whole, _, none = _fetch(rd, beg, end, reuse)
    assert none == 0
    _same_columns(whole, ref)
    assert whole["n_parsed"] - cols["n_parsed"] == pruned
    return pruned


@pytest.mark.parametrize("reuse", [False, True])
@pytest.mark.parametrize("region", sorted(REGIONS))
def test_fetch_equals_the_jax_fetch(binned, monkeypatch, region, reuse):
    pruned = _check_region(binned[0], *REGIONS[region], reuse, monkeypatch)
    assert (pruned > 0) == (region in PRUNES)


def _edge_bam(tmp_path_factory, binned, which: str, cross: int):
    """make_binned_bam again, with the read before the first record of the
    across_1mb region's first chunk (`which` "kept") or of its first chunk
    past the region ("pruned") padded so that record starts `cross` bytes
    before its block's end. Returns the path, the record's name, its
    virtual offset there and the region."""
    path, names = binned
    beg, end = REGIONS["across_1mb"]
    rd = BamReader(path)
    every = rd._load_index().chunks_for_region(0, beg, end)
    k = _kept(rd, every, end)
    assert 0 < k < len(every)
    cb = every[0 if which == "kept" else k][0]
    qname = _first_record(rd, cb).qname
    offs, sizes = BgzfReader(path).block_offsets()
    # the header has block 0 to itself; records fill blocks of BLOCK bytes
    B = BgzfWriter.BLOCK
    at = sum(sizes[1:offs.index(cb >> 16)]) + (cb & 0xFFFF)
    n = (B - cross - at) % B
    n += B if n < 4 else 0
    out = str(tmp_path_factory.mktemp(f"edge_{which}_{cross}") / "e.bam")
    testing.make_binned_bam(out, ref_len=REF_LEN,
                            pad={names[names.index(qname) - 1]: n})
    rd = BamReader(out)
    voff = next(c for c, _ in rd._load_index().chunks_for_region(0, beg, end)
                if _first_record(rd, c).qname == qname)
    offs, sizes = BgzfReader(out).block_offsets()
    assert (voff & 0xFFFF) == sizes[offs.index(voff >> 16)] - cross
    return out, qname, voff, (beg, end)


@pytest.mark.parametrize("cross", [2, 6, 10])
@pytest.mark.parametrize("which", ["kept", "pruned"])
def test_chunk_head_across_a_block_end(tmp_path_factory, binned,
                                       monkeypatch, which, cross):
    path, qname, voff, (beg, end) = _edge_bam(tmp_path_factory, binned,
                                              which, cross)
    rd = BamReader(path)
    rec = _first_record(rd, voff)
    raw = rd._bgzf._raw
    assert port_bam._record_head(raw, voff) == (0, rec.pos)
    assert (rec.pos >= end) == (which == "pruned")
    every = rd._load_index().chunks_for_region(0, beg, end)
    k = [cb for cb, _ in every].index(voff)
    kept = chunks_before(raw, every, 0, end)
    assert (len(kept) == k) if which == "pruned" else (len(kept) > k)
    assert _check_region(path, beg, end, False, monkeypatch) \
        == len(every) - len(kept)
    # the chunk alone, at an end at and just past its record's start
    one = every[k:k + 1]
    assert chunks_before(raw, one, 0, rec.pos) == []
    assert chunks_before(raw, one, 0, rec.pos + 1) == one


def test_record_head_at_a_block_end(binned):
    """A virtual offset at its block's end names the next block's first
    byte: the head read there is the next block's record."""
    path, _ = binned
    rd = BamReader(path)
    offs, sizes = BgzfReader(path).block_offsets()
    raw = rd._bgzf._raw
    cb = rd._load_index().chunks_for_region(0, *REGIONS["start"])[0][0]
    j = offs.index(cb >> 16)
    assert (cb & 0xFFFF) == 0 and j > 0
    at_end = (offs[j - 1] << 16) | sizes[j - 1]
    assert port_bam._record_head(raw, at_end) == (0, 0)
    assert port_bam._record_head(raw, cb) == (0, 0)
    # past the file's last block there is no record
    assert port_bam._record_head(raw, len(raw) << 16) is None


GAPS = [(300_000, 330_000), (1_005_000, 1_035_000), (1_500_000, 1_530_000),
        (2_035_000, 2_065_000)]


@pytest.mark.parametrize("pipe", [True, False])
def test_chrom_source_gap_windows(binned, monkeypatch, pipe):
    path, _ = binned
    monkeypatch.setenv("POMFRET_SEG_PIPE" if pipe else "POMFRET_NO_SEG_PIPE",
                       "1")
    R = readset.READBACK
    regions = [[max(s - R - 1, 0), e + R] for s, e in GAPS]
    rd = BamReader(path)
    fetched = []
    fwc = rd.fetch_window_columnar

    def spy(chrom, beg, end, *a, **kw):
        fetched.append((beg, end))
        return fwc(chrom, beg, end, *a, **kw)

    monkeypatch.setattr(rd, "fetch_window_columnar", spy)
    stats.reset_stages()
    src = readset.ChromReadSource(rd, "c1", CFG, regions=regions)
    counters = stats.counter_report()
    assert src.ok and len(fetched) >= len(GAPS)
    idx = rd._load_index()
    want_pruned = want_bytes = 0
    for beg, end in fetched:
        every = idx.chunks_for_region(0, beg, end)
        k = _kept(rd, every, end)
        want_pruned += len(every) - k
        want_bytes += _span_bytes(path, every[:k])
    assert counters["source_chunks_pruned"] == want_pruned > 0
    assert counters["source_plain_bytes"] == want_bytes
    windows = [("c1", s, e) for s, e in GAPS]
    got = [testing._snap(src.window(s, e, R)) for s, e in GAPS]
    assert all(len(w["reads"]) > 30 for w in got)
    monkeypatch.undo()
    m = testing.port_modules()
    assert got == testing._windows(m, path, windows, CFG)
    assert got == testing._windows(m, path, windows, CFG, native=True)
