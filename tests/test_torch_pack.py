"""The port's packing (numpy copies of the JAX package's) vs the originals.

pomfret_tpu_torch's build_gap_device_data, pack_group, pack_gap_batch and
batch_args must give arrays equal to pomfret_tpu's on the windows of
tests/test_runs_upload.py, for the runs and the dense layouts, a mixed-
layout split and batched permutation lanes; densify_runs must equal the
JAX package's _densify_runs. Tolerance: exact.
"""
import tempfile

import numpy as np
import pytest
import torch

import pomfret_tpu.kernels.engine_jax as ej
from pomfret_tpu.core.engine_host import Drand48
from pomfret_tpu.core.methmer import (extract_mmr_arrays,
                                      get_methmer_sites_and_ranges)
from pomfret_tpu.core.readset import (READBACK, MmrConfig,
                                      load_reads_given_interval)
from pomfret_tpu.io.bam import BamReader
from pomfret_tpu.parallel import batch as jb
from pomfret_tpu.testing import make_two_block_scenario
from pomfret_tpu_torch.kernels import engine_torch as et
from pomfret_tpu_torch.parallel import batch as tb
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

torch.set_num_threads(1)

_DD_FIELDS = ("ids", "has_mmr", "hp_init", "seed_ok", "perm", "n_reads",
              "n_sites", "max_d", "q_break", "min0", "max0", "R", "S", "blk",
              "b0")
_BATCH_FIELDS = ("ids", "has_mmr", "hp_init", "seed_ok", "perm", "n_reads",
                 "n_sites", "q_break", "min0", "max0", "cov", "n_cand", "D",
                 "nc_cap", "S", "blk", "b0")


def _assert_same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, f
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


def _assert_same_group(port, ref):
    (datas_p, parts_p, errs_p), (datas_r, parts_r, errs_r) = port, ref
    assert errs_p == errs_r
    assert len(datas_p) == len(datas_r)
    for dp, dr in zip(datas_p, datas_r):
        _assert_same(dp, dr, _DD_FIELDS)
    assert len(parts_p) == len(parts_r)
    for (ip, bp), (ir, br) in zip(parts_p, parts_r):
        np.testing.assert_array_equal(ip, ir)
        _assert_same(bp, br, _BATCH_FIELDS)
        for x, y in zip(tb.batch_args(bp, 77), jb.batch_args(br, 77)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def window():
    with tempfile.TemporaryDirectory() as d:
        bam, vcf, truth = make_two_block_scenario(d)
        bamr = BamReader(bam)
        cfg = MmrConfig(cov_for_selection=5, cov_for_runtime=10)
        gs, ge = truth["gap"]
        rs = load_reads_given_interval(bamr, "chr1", gs, ge, READBACK, cfg)
        ms_f = get_methmer_sites_and_ranges(rs, cfg, 0)
        ms_b = get_methmer_sites_and_ranges(rs, cfg, 1)
        yield rs, cfg, ms_f, ms_b


@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("want_runs", [False, True])
def test_gap_device_data_matches(window, direction, want_runs):
    rs, cfg, ms_f, ms_b = window
    ms = ms_f if direction == 0 else ms_b
    res = extract_mmr_arrays(rs, ms)
    assert res is not None, "native methmer extraction unavailable"
    R, S = et._round_up(rs.n, 128), et._round_up(ms.n, 128)
    dp = et.build_gap_device_data(rs, ms, direction, R, S, mmr_arrays=res,
                                  want_runs=want_runs)
    dr = ej.build_gap_device_data(rs, ms, direction, R, S, mmr_arrays=res,
                                  want_runs=want_runs)
    assert (dp.blk is not None) == want_runs
    _assert_same(dp, dr, _DD_FIELDS)
    np.testing.assert_array_equal(dp.dense_ids(), dr.dense_ids())
    bp = tb.pack_gap_batch([dp, dp], [10, 10], 14, pad_g=32)
    br = jb.pack_gap_batch([dr, dr], [10, 10], 14, pad_g=32)
    _assert_same(bp, br, _BATCH_FIELDS)


def test_pack_gap_batch_pads_lanes_to_32(window):
    rs, cfg, ms_f, _ = window
    dd = et.build_gap_device_data(rs, ms_f, 0, et._round_up(rs.n, 128),
                                  et._round_up(ms_f.n, 128),
                                  mmr_arrays=extract_mmr_arrays(rs, ms_f),
                                  want_runs=True)
    batch = tb.pack_gap_batch([dd] * 3, [10] * 3, 14)
    assert batch.shape3[0] == 32
    assert (batch.n_reads[3:] == 0).all() and (batch.q_break[3:] == 0).all()
    assert et._bucket_lanes(33) == 64 and et._bucket_dim(2049) == 2560


@pytest.mark.parametrize("n_permutations", [1, 3])
def test_pack_group_matches(window, n_permutations):
    rs, cfg, ms_f, ms_b = window
    loaded = [(0, rs, ms_f, ms_b), (1, rs, ms_f, ms_b)]
    kw = {}
    if n_permutations > 1:
        kw = dict(n_permutations=n_permutations)
    port = et.pack_group(loaded, cfg, 14, rngs=[
        Drand48.from_srand48(7 + i) for i, *_ in loaded], **kw)
    ref = ej.pack_group(loaded, cfg, 14, rngs=[
        Drand48.from_srand48(7 + i) for i, *_ in loaded], **kw)
    assert len(port[0]) == 2 * len(loaded) * n_permutations
    assert port[1][0][1].blk is not None       # the runs layout
    _assert_same_group(port, ref)


def test_pack_group_dense_and_mixed_split(window, monkeypatch):
    """One gap forced onto the dense layout splits the group into a runs
    and a dense sub-batch (tests/test_runs_upload.py::
    test_mixed_group_splits_by_layout); all-dense packs one dense batch."""
    rs, cfg, ms_f, ms_b = window
    loaded = [(0, rs, ms_f, ms_b), (1, rs, ms_f, ms_b), (2, rs, ms_f, ms_b)]

    def dense_for(mod, gaps):
        real = mod.build_gap_device_data
        calls = {"n": 0}

        def fake(rs_, ms_, direction, pad_r, pad_s, **kw):
            j = calls["n"] % len(loaded)
            calls["n"] += 1
            if j in gaps:
                kw.pop("want_runs", None)
            return real(rs_, ms_, direction, pad_r, pad_s, **kw)
        monkeypatch.setattr(mod, "build_gap_device_data", fake)

    for gaps in ({1}, {0, 1, 2}):
        dense_for(et, gaps)
        dense_for(ej, gaps)
        port = et.pack_group(loaded, cfg, 14)
        ref = ej.pack_group(loaded, cfg, 14)
        monkeypatch.undo()
        _assert_same_group(port, ref)
        assert len(port[1]) == (2 if gaps == {1} else 1)
        assert port[1][-1][1].blk is None


def test_densify_runs_matches_jax(window):
    rs, cfg, ms_f, ms_b = window
    datas = [et.build_gap_device_data(rs, ms, dr, et._round_up(rs.n, 128),
                                      et._round_up(ms.n, 128),
                                      mmr_arrays=extract_mmr_arrays(rs, ms),
                                      want_runs=True)
             for dr, ms in ((0, ms_f), (1, ms_b))]
    batch = tb.pack_gap_batch(datas, [10, 10], 14)
    assert batch.blk is not None
    # a block run that reaches past S exercises the clipping
    blk, b0 = batch.blk.copy(), batch.b0.copy()
    b0[0, 0] = batch.S // 128 - 1
    blk[0, 0, :] = 5
    ref = np.asarray(jb._densify_runs(blk, b0, batch.S))
    got = tb.densify_runs(torch.from_numpy(blk), torch.from_numpy(b0),
                          batch.S)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    got8 = tb.densify_runs(torch.from_numpy(blk), torch.from_numpy(b0),
                           batch.S, torch.int8)
    np.testing.assert_array_equal(got8.numpy(), ref)


def test_batch_tensors_keep_dtypes(window):
    rs, cfg, ms_f, ms_b = window
    dd = et.build_gap_device_data(rs, ms_f, 0, et._round_up(rs.n, 128),
                                  et._round_up(ms_f.n, 128),
                                  mmr_arrays=extract_mmr_arrays(rs, ms_f))
    batch = tb.pack_gap_batch([dd], [10], 14)
    t = tb.batch_tensors(batch, 99, "cpu")
    assert t["ids"].dtype == torch.int8 and batch.D <= 127
    assert list(t) == ["ids", *tb._LOOP_KEYS]
    for (k, v), a in zip(t.items(), tb.batch_args(batch, 99)):
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), a, err_msg=k)
    assert (t["max_iters"] == 99).all()


def test_cuda_engine_rejects_cpu_tensors(window):
    rs, cfg, ms_f, ms_b = window
    dd = et.build_gap_device_data(rs, ms_f, 0, et._round_up(rs.n, 128),
                                  et._round_up(ms_f.n, 128),
                                  mmr_arrays=extract_mmr_arrays(rs, ms_f))
    batch = tb.pack_gap_batch([dd], [10], 14)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tb._run_batch(tb.batch_tensors(batch, 9, "cpu"), batch, "cuda")
