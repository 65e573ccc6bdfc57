"""The probe kernels' plain versions vs the JAX package's tools/probe_*.py.

Each registry entry of pomfret_tpu_torch.tools.probes runs twice on the
same inputs: the JAX probe file, loaded by path, with
jax.experimental.pallas.pallas_call patched to run in interpret mode and to
record the array each pallas_call returns (several probes only print a
string); and the port's plain version on the CPU. Tolerance: the integer
sums exact; the ratio sums of probe_stile and probe_stile2 within rtol=1e-5,
atol=1e-4 (f32 summation order: the JAX probe's own full-S and tiled-S
sums differ by up to 2.3e-5).

Nine variants read scratch rows that the Pallas kernel never wrote, which
interpret mode fills with values of its own (int8 scratch comes back
non-zero): probe_dma static/traced_row/traced_both/chunk _i8, probe_dma3
c16_i8, c32_i8, c32_i8_dyn, probe_dma4 lead_i8_multi and probe_v3_parts
dma_dyn. The port zero-fills scratch, so on those the plain version is held
against the probe's numpy oracle with zeros there, not against interpret
mode. Every entry is also held against that oracle.
"""
import contextlib
import importlib.util
import io
import os
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pomfret_tpu_torch import testing
from pomfret_tpu_torch.kernels import probes as kp
from pomfret_tpu_torch.tools import probes as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = sorted(tp.PROBES)
UNDEFINED = {("probe_dma", v) for v in ("static_i8", "traced_row_i8",
                                        "traced_both_i8", "chunk_i8")} | {
    ("probe_dma3", v) for v in ("c16_i8", "c32_i8", "c32_i8_dyn")} | {
    ("probe_dma4", "lead_i8_multi"), ("probe_v3_parts", "dma_dyn")}

_MODULES = {}


def _probe_module(stem):
    if stem not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"_jax_{stem}", os.path.join(REPO, "tools", f"{stem}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[stem] = mod
    return _MODULES[stem]


def _run_jax_probe(monkeypatch, stem, variant):
    """The first array returned by each pallas_call the probe builds, in
    the order it builds them."""
    orig = pl.pallas_call
    first = []

    def recording(kernel, *args, **kwargs):
        kwargs["interpret"] = True
        f = orig(kernel, *args, **kwargs)
        k = len(first)
        first.append(None)

        def keep(out):
            if first[k] is None:
                first[k] = np.asarray(out)

        def g(*a):
            out = f(*a)
            jax.debug.callback(keep, out)
            return out
        return g

    monkeypatch.setattr(pl, "pallas_call", recording)
    mod = _probe_module(stem)
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            if variant == "main":
                mod.main()
            else:
                mod.run(variant)
        except AssertionError:
            # the probe's own assert on an undefined-scratch variant
            assert (stem, variant) in UNDEFINED
    jax.effects_barrier()
    return first


def test_registry_covers_every_probe():
    assert len(tp.PROBES) == 45
    assert UNDEFINED == {k for k, p in tp.PROBES.items()
                         if p.undefined_in_jax}
    stems = {os.path.splitext(f)[0] for f in os.listdir(
        os.path.join(REPO, "tools")) if f.startswith("probe_")}
    assert stems == {s for s, _ in tp.PROBES}


@pytest.mark.parametrize("stem,variant", KEYS)
def test_plain_matches_jax_probe(monkeypatch, stem, variant):
    p = tp.PROBES[(stem, variant)]
    _, _, got, ok, msg = tp.run_probe(p, torch.device("cpu"))
    assert ok, msg                       # the probe's oracle, zero scratch
    recorded = _run_jax_probe(monkeypatch, stem, variant)
    names = ["full", "tiled"] if p.kernel == "probe_stile" else ["out"]
    assert len(recorded) == len(names)
    if (stem, variant) in UNDEFINED:
        return                           # interpret mode's scratch values
    for name, want in zip(names, recorded):
        assert got[name].shape == want.shape, name
        if p.kernel == "probe_stile":
            np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-4)
        else:
            assert np.array_equal(got[name], want.astype(np.int64)), \
                (name, got[name].ravel()[:8], want.ravel()[:8])


@pytest.mark.parametrize("n_iter", [1, 3])
def test_stile_plain_full_equals_tiled(n_iter):
    """Full-S and tiled-S sum the same exact f64 values: equal bit for bit,
    here with a range of its own per batch row."""
    inp = tp.stile_make()
    rng = np.random.default_rng(7)
    lo = rng.integers(0, 900, size=len(inp["ranges"]))
    inp["ranges"] = np.stack([lo, lo + rng.integers(0, 600, size=len(lo))],
                             1).astype(np.int32)
    t = tp.tensors(inp, "cpu")
    full = kp.stile(t["cnt"], t["cids"], t["ranges"], tiled=False,
                    n_iter=n_iter)
    tiled = kp.stile(t["cnt"], t["cids"], t["ranges"], tiled=True,
                     n_iter=n_iter)
    assert torch.equal(full, tiled)
    assert np.array_equal(full.numpy(), tp.stile_expect(inp, n_iter))
    assert kp.tile_bounds(t["ranges"], 1536) == (
        int(lo.min()) // 256 * 256,
        min(-(-int(t["ranges"][:, 1].max()) // 256) * 256, 1536))


def test_row_copy_plain_edges():
    """A row range outside [0, R) copies nothing; a slot range outside
    [0, NB) places nothing; the total is the sum of the lanes; the buffer
    comes back only with keep_buf, and NB=0 has none."""
    src = torch.arange(4 * 6 * 16, dtype=torch.int32).view(4, 6, 16)
    rows = torch.tensor([0, 5, -1, 3], dtype=torch.int32)   # 5 + 2 > 6
    slots = torch.tensor([1, 0, 0, 3], dtype=torch.int32)   # 3 + 2 > 4
    lane_sum, total, buf = kp.row_copy(src, rows, slots, W=2, NB=4,
                                       keep_buf=True)
    want = torch.zeros(4, 4, 16, dtype=torch.int32)
    want[0, 1:3] = src[0, 0:2]
    assert torch.equal(buf, want)
    assert lane_sum.tolist() == [int(src[0, :2].sum()), 0, 0, 0]
    assert int(total) == int(lane_sum.sum())
    assert kp.row_copy(src, rows, slots, W=2, NB=4)[2] is None
    stage_sums = [int(src[0, :2].sum()), 0, 0, int(src[3, 3:5].sum())]
    for nb in (4, 0):
        staged, total, _ = kp.row_copy(src, rows, slots, W=2, NB=nb,
                                       sum_stage=True)
        assert staged.tolist() == stage_sums
        assert int(total) == sum(stage_sums)


def test_entry_point_exit_codes(capsys):
    assert tp.main(["probe_dma6", "t1", "t5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["probe_dma6 t1: OK out=[254, 254, 254, 254, 254, 254, "
                   "254, 254]", "probe_dma6 t5: OK out=[254, 0, 0, 0, 0, 0, "
                   "0, 0]"]
    assert tp.main(["probe_dma6", "t9", "--device", "cpu"]) == 2


def test_entry_point_fails_on_a_wrong_result(monkeypatch, capsys):
    p = tp.PROBES[("probe_v3_parts", "whileloop")]
    wrong = tp.Probe(p.stem, p.variant, p.kernel, p.make,
                     lambda fn, t: (fn(t["hp"], "whileloop", n_iter=4),),
                     p.result, p.expect)
    monkeypatch.setitem(tp.PROBES, ("probe_v3_parts", "whileloop"), wrong)
    assert tp.main(["tools/probe_v3_parts.py", "whileloop", "--device",
                    "cpu"]) == 1
    assert "whileloop: FAIL out" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The identities the card kernels rely on, held on the plain versions
# ---------------------------------------------------------------------------

S_STILE = testing.STILE_S


@pytest.mark.parametrize("case", sorted(testing.STILE_EDGE_RANGES))
def test_stile_plain_full_equals_tiled_edge_ranges(case):
    """Full-S == tiled-S == the numpy oracle bit for bit on ranges with lo
    < 0, hi > S, lo >= hi, a tile of their own per row, ids outside [0, D);
    also at B = 1 and NC = 1."""
    for seed, (B, NC) in enumerate(((32, 16), (1, 16), (32, 1), (1, 1))):
        inp = testing.stile_edge_inputs(case, seed, B, NC)
        t = tp.tensors(inp, "cpu")
        full, tiled = (kp.stile_plain(t["cnt"], t["cids"], t["ranges"],
                                      tiled=tl, n_iter=3)
                       for tl in (False, True))
        assert torch.equal(full, tiled), (case, B, NC)
        assert np.array_equal(full.numpy(), tp.stile_expect(inp, 3))


@pytest.mark.parametrize("tiled", [False, True])
def test_stile_plain_same_bits_when_sites_permuted(tiled):
    """The f64 sum of the ratios is exact, so any order of the sites gives
    the same bits: the kernel's warps sum in their own order. Permuting
    every site under a range that keeps them all, and the sites inside a
    shared range among themselves, leaves the result unchanged."""
    inp = tp.stile_make()
    t = tp.tensors(inp, "cpu")
    lo, hi = tp.STILE_RANGE
    r = np.random.default_rng(11)
    for perm, ranges in (
            (r.permutation(S_STILE), torch.tensor([[0, S_STILE]] * 32,
                                                  dtype=torch.int32)),
            (np.r_[np.arange(lo), lo + r.permutation(hi - lo),
                   np.arange(hi, S_STILE)], t["ranges"])):
        perm = torch.from_numpy(perm)
        want = kp.stile_plain(t["cnt"], t["cids"], ranges, tiled=tiled,
                              n_iter=4)
        got = kp.stile_plain(t["cnt"][:, :, perm], t["cids"][:, :, perm],
                             ranges, tiled=tiled, n_iter=4)
        assert torch.equal(got, want)


def _rn32_sum(q, t):
    """RN to f32 of q + t, exactly: q f32, t f64. The f64 sum rounds, but
    monotonically, so its f32 rounding is right unless it lands on an f32
    midpoint that the exact sum is not on; those are redone in
    fractions."""
    q64 = q.astype(np.float64)
    s = q64 + t
    f = s.astype(np.float32)
    other = np.nextafter(f, np.where(s > f.astype(np.float64),
                                     np.float32(np.inf), np.float32(-np.inf)))
    mid = (f.astype(np.float64) + other.astype(np.float64)) / 2
    for i in np.flatnonzero((mid == s) & (other != f)):
        exact = Fraction(float(q64[i])) + Fraction(float(t[i]))
        if exact != Fraction(float(mid[i])):
            f[i] = max(f[i], other[i]) if exact > mid[i] else min(f[i], other[i])
    return f


def _rcp_fma_quotients(c0, div):
    """stile_kernel's reciprocal-and-FMA quotient, emulated exactly: r =
    RN(1/div), q = RN(c0 r), e = RN(c0 - q div) (c0 - q div is exact in
    f64 by Sterbenz's lemma), result RN(q + e r) (e r is exact in f64)."""
    r = np.float32(1) / div
    q = c0 * r
    e = (c0.astype(np.float64) - q.astype(np.float64) * np.float64(div))
    e = e.astype(np.float32).astype(np.float64)
    return _rn32_sum(q, e * np.float64(r))


def test_stile_rcp_fma_division_is_ieee():
    """The quotient the kernel takes by default (a reciprocal per
    iteration and an FMA correction) equals the IEEE quotient for every
    integer c0 in [1, 2^16] and each of probe_stile2's 400 divisors, and
    for random normal c0; emulated exactly here, run on the card by
    tests/test_torch_kernel.py."""
    ints = np.arange(1, 2 ** 16 + 1, dtype=np.float32)
    rand = np.random.default_rng(5).uniform(-90, 90, 1 << 15)
    rand = np.exp2(rand).astype(np.float32)
    c0 = np.concatenate([ints, rand])
    want = kp.stile_ratios_plain(torch.from_numpy(c0), 400).numpy()
    divs = np.float32(7) + np.arange(400, dtype=np.float32) * np.float32(1e-6)
    for i, div in enumerate(divs):
        got = _rcp_fma_quotients(c0, div)
        assert np.array_equal(got, c0 / div), i
        assert np.array_equal(got, want[i]), i
    # the emulation sees an uncorrected quotient's errors
    assert not np.array_equal(c0 * (np.float32(1) / divs[8]), c0 / divs[8])
    assert torch.equal(kp.stile_ratios(torch.from_numpy(ints[:10]), 3),
                       kp.stile_ratios_plain(torch.from_numpy(ints[:10]), 3))


@pytest.mark.parametrize("NC,S,D", [(16, 1536, 4), (1, 1536, 4), (3, 100, 8),
                                    (64, 7, 1)])
def test_stile_plan(NC, S, D):
    kpb, shm = kp.stile_plan(NC, S, D)
    assert kpb == min(kp.STILE_WARPS, NC)
    row = -(-S // 4) * 4
    assert row % 4 == 0 and S <= row < S + 4
    assert shm == 128 + (D + 1 + kpb) * row * 4
    assert kp.stile_plan(16, 1536, 4) == (4, 128 + 9 * 1536 * 4)


@pytest.mark.parametrize("W,S,elt", [(1, 256, 1), (1, 256, 4), (17, 256, 1),
                                     (16, 256, 1), (64, 256, 4), (64, 256, 1),
                                     (3, 48, 4), (63, 16, 1)])
def test_row_copy_plan(W, S, elt):
    """The chunks cover the stage once, in 1-4 pieces of 16-byte multiples,
    each of at least MIN_CHUNK_BYTES but where one piece takes it all."""
    shm, chunks, size = kp.row_copy_plan(W, S, elt)
    nbytes = W * S * elt
    assert shm == 256 + nbytes
    assert 1 <= chunks <= kp.COPY_CHUNKS and size % 16 == 0
    assert (chunks - 1) * size < nbytes <= chunks * size
    assert chunks == 1 or size >= kp.MIN_CHUNK_BYTES
    if nbytes >= kp.COPY_CHUNKS * kp.MIN_CHUNK_BYTES:
        assert chunks == kp.COPY_CHUNKS


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_row_copy_plain_buffer_sum_is_stage_sum_where_placed(dtype):
    """sum(buffer) == sum(stage) for a lane whose stage is placed, 0 for
    one whose is not: the kernel sums the stage and never builds the
    buffer."""
    r = np.random.default_rng(3)
    L, R, S, W, NB = 8, 12, 32, 3, 5
    src = torch.from_numpy(r.integers(-100, 100, size=(L, R, S))).to(dtype)
    rows = torch.tensor([-1, 0, R - W, R - W + 1, 4, 2, 9, 5],
                        dtype=torch.int32)
    slots = torch.tensor([0, 2, -1, 1, NB - W, NB - W + 1, 0, 7],
                         dtype=torch.int32)
    staged, st_total, _ = kp.row_copy_plain(src, rows, slots, W=W, NB=NB,
                                            sum_stage=True)
    lane, total, buf = kp.row_copy_plain(src, rows, slots, W=W, NB=NB,
                                         keep_buf=True)
    placed = (slots >= 0) & (slots <= NB - W)
    assert torch.equal(lane, torch.where(placed, staged, 0))
    assert torch.equal(lane, buf.to(torch.int32).sum(dim=(1, 2),
                                                     dtype=torch.int32))
    assert int(total) == int(lane.sum()) and int(st_total) == int(staged.sum())
    copied = (rows >= 0) & (rows <= R - W)
    assert torch.equal(staged != 0, copied & (staged != 0))


# ---------------------------------------------------------------------------
# The v3 loop and the lane vectors: the identities the redesigned kernels
# rely on, on the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 5, 9, 40])
def test_v3_loop_plain_matches_jax_probe_iters(monkeypatch, iters):
    """The JAX probe_v3_feasibility kernel in interpret mode at ITERS 1, 5,
    9 and 40 (9 and 40 reuse slots of NC=4; from iteration 32 on no read
    q >= 2 it is left and every pick is R - 1) == v3_loop_plain on the same
    inputs, exactly."""
    mod = _probe_module("probe_v3_feasibility")
    monkeypatch.setattr(mod, "ITERS", iters)
    recorded = _run_jax_probe(monkeypatch, "probe_v3_feasibility", "main")
    assert len(recorded) == 1
    t = tp.tensors(tp.PROBES[("probe_v3_feasibility", "main")].make(), "cpu")
    got = kp.v3_loop_plain(t["ids"], t["hp"], NC=tp.NC, n_iter=iters)
    assert np.array_equal(got.numpy(), recorded[0][:, 0])


@pytest.mark.parametrize("L,R,S,NC,n_iter", [
    (8, 64, 256, 4, 9), (5, 70, 8, 1, 40), (3, 1, 4, 4, 6),
    (4, 100, 12, 16, 60), (2, 33, 4, 3, 20)])
def test_v3_loop_bookkeeping_matches_plain(L, R, S, NC, n_iter):
    """The kernel's bookkeeping (ballot-word picks, per-slot sums, the
    uint32 total += new - old) == v3_loop_plain: ids whose sums wrap int32,
    n_iter > NC (slots reused), a lane with no eligible read, R not a
    multiple of 32 and R = 1; the timing route gives the same on the CPU."""
    inp = testing.v3_inputs(L, R, S, L * R + n_iter, none_eligible=[L - 1])
    t = tp.tensors(inp, "cpu")
    want = kp.v3_loop_plain(t["ids"], t["hp"], NC=NC, n_iter=n_iter)
    got = testing.v3_loop_bookkeeping(inp["ids"], inp["hp"], NC, n_iter)
    assert np.array_equal(got, want.numpy())
    assert torch.equal(kp.v3_loop_loaded(t["ids"], t["hp"], NC=NC,
                                         n_iter=n_iter), want)
    # the sums do wrap: the exact sums differ from the int32 results
    rows = inp["ids"].astype(np.int64).sum(axis=2)
    assert np.abs(rows).max() > 2 ** 31


def test_lane_vec_plain_wraps_as_int32():
    """whileloop == the int32 wrap of n_iter * sum_q hp, and the sloads ==
    the int32 wrap of sum_l (min_q hp + l), where the exact sums overflow:
    the kernel's uint32 adds give these bits."""
    r = np.random.default_rng(4)
    hp = r.integers(2 ** 30, 2 ** 31, size=(8, 64)).astype(np.int32)
    hp[3] = -hp[3]
    t = torch.from_numpy(hp)
    for n_iter in (0, 1, 5, 1000):
        want = (n_iter * hp.astype(np.int64).sum(axis=1)) % 2 ** 32
        got = kp.lane_vec_plain(t, "whileloop", n_iter=n_iter)
        assert np.array_equal(got.numpy(), want.astype(np.uint32).view(
            np.int32)), n_iter
    v = hp.astype(np.int64).min(axis=1) + np.arange(8)
    want = np.full(8, v.sum() % 2 ** 32).astype(np.uint32).view(np.int32)
    for mode, dyn in (("sload", 0), ("smem_dma", 0), ("sload_dyn", 11)):
        got = kp.lane_vec_plain(t, mode, dyn=dyn)
        assert np.array_equal(got.numpy(), want), mode
    assert torch.equal(kp.lane_vec(t, "smem_dma"), torch.from_numpy(want))


@pytest.mark.parametrize("L,R,NC,S", [(8, 64, 4, 256), (8, 1024, 4, 1536),
                                      (200, 1000, 16, 1536), (1, 1, 1, 4),
                                      (3, 100, 16, 256), (8, 64, 40, 1536)])
def test_v3_loop_plan(L, R, NC, S):
    """Up to V3_LOOP_WARPS lanes a block, never more than L, as many as
    fit one block's shared memory: each warp's mbarrier, NC slot sums and
    ceil(R / 32) ballot words, then from a 16-byte boundary its NC rows."""
    wpb, shm = kp.v3_loop_plan(L, R, NC, S)
    nw = -(-R // 32)

    def size(w):
        head = 8 * w + 4 * w * (NC + nw)
        return head + (-head) % 16 + 4 * w * NC * S
    assert 1 <= wpb <= min(kp.V3_LOOP_WARPS, L) and shm == size(wpb)
    cap = kp.MAX_SHARED_BYTES - 1024
    assert shm <= cap or wpb == 1
    assert wpb == min(kp.V3_LOOP_WARPS, L) or size(wpb + 1) > cap
    assert kp.v3_loop_plan(8, 64, 4, 256) == (4, 16512)


@pytest.mark.parametrize("kernel", sorted(kp.PROBE_KERNELS))
def test_launch_shape(kernel):
    """Every registry entry's launch shape (the floor's): whole warps, at
    most 1024 threads a block; blocks that cover the entry's lanes
    (row_copy, lane_vec: one block a lane or one for all; v3_loop: the
    plan's lanes a block; stile: its k's a block, a row of blocks per b);
    a cluster only where the kernel needs one (row_copy's lanes,
    lane_vec's smem_dma), dividing the grid."""
    entries = [p for p in tp.PROBES.values() if p.kernel == kernel]
    assert entries
    for p in entries:
        inputs = p.make()
        (gx, gy), threads, cluster = tp.launch_shape(p, inputs)
        assert threads % 32 == 0 and 32 <= threads <= 1024, p.variant
        if kernel == "probe_row_copy":
            L = inputs["src"].shape[0]
            assert ((gx, gy), threads, cluster) == (
                (L, 1), kp.ROW_COPY_THREADS, L)
        elif kernel == "probe_lane_vec":
            L = inputs["hp"].shape[0]
            assert ((gx, gy), threads) == ((1, 1), 32 * L)
            assert cluster == (p.kw["mode"] == "smem_dma"), p.variant
        elif kernel == "probe_v3_loop":
            L, R, S = inputs["ids"].shape
            wpb = threads // 32
            assert (wpb, gy, cluster) == (
                kp.v3_loop_plan(L, R, p.kw["NC"], S)[0], 1, 0)
            assert (gx - 1) * wpb < L <= gx * wpb
        else:
            B, NC = inputs["cids"].shape[:2]
            kpb = threads // 32
            assert (gy, cluster) == (B, 0) and kpb <= kp.STILE_WARPS
            assert (gx - 1) * kpb < NC <= gx * kpb
        assert cluster == 0 or gx % cluster == 0
