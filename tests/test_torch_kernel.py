"""The hand-written CUDA kernels vs their plain PyTorch versions, on the
card. Marked `cuda`: without a GPU every test here skips (the same checks
run as phase 3 of chip_smoke.py). Tolerance: exact — hp by array_equal and
all of stats, including each lane's own iteration count; each step of the
per-iteration kernels (score rows, cnt, hp, flags) equal to its plain
version's, since both sum the scores exactly. The four probe kernels
(kernels/probes.py) on every entry of tools/probes.py: equal to the probe's
oracle and, output for output, to their plain versions (exact; the ratio
sums bit for bit, full-S and tiled-S alike)."""
import numpy as np
import pytest
import torch

from pomfret_tpu_torch import testing
from pomfret_tpu_torch.kernels import engine_fused as tf
from pomfret_tpu_torch.kernels import engine_fused3 as tf3
from pomfret_tpu_torch.kernels import probes as kp
from pomfret_tpu_torch.parallel import batch as tb
from pomfret_tpu_torch.tools import probes as tpr
from pomfret_tpu_torch.testing import (N_FUZZ_CARD, bench_gap_batch,
                                       checked_step, crafted_args, fuzz_args,
                                       near_tie_args, wide_args)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both(args, D, nc_cap, device):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args]
    n0 = tf3.run_batch_fused3.launches
    hk, sk = tf3.run_batch_fused3(*t, D=D, nc_cap=nc_cap)
    assert tf3.run_batch_fused3.launches == n0 + 1
    hpl, spl = tf3.loop_plain(*t, D=D, nc_cap=nc_cap)
    torch.cuda.synchronize()
    assert torch.equal(hk, hpl)
    assert torch.equal(sk, spl)
    return hk.cpu().numpy(), sk.cpu().numpy()


@pytest.mark.parametrize("trial", range(N_FUZZ_CARD))
def test_kernel_matches_plain_fuzz(cuda, trial):
    args, D, nc_cap = fuzz_args(trial)
    _both(args, D, nc_cap, cuda)


def test_kernel_matches_plain_near_tie(cuda):
    args, D, nc_cap, layout = near_tie_args()
    hp, _ = _both(args, D, nc_cap, cuda)
    g, _, row = layout["gate"]
    assert hp[g, row] == 0       # the exact sum 3.0 passes the gate


def test_kernel_matches_plain_bench_shape(cuda):
    batch, _ = bench_gap_batch(G=64)
    hp, st = _both(tb.batch_args(batch, 2 * batch.shape3[1] + 64), batch.D,
                   batch.nc_cap, cuda)
    assert (hp <= 1).sum() > 0 and (st[:, 3] > 0).all()


def test_kernel_matches_plain_crafted(cuda):
    """A failure that empties the candidate set (refill), one that moves
    q_last past the prefetched row (speculation miss), a tie in reused
    slots (to the higher read, not the higher slot)."""
    args, D, nc_cap, layout = crafted_args()
    hp, _ = _both(args, D, nc_cap, cuda)
    g, rows = layout["reuse_tie"]
    assert hp[g, rows["tie1"]].tolist() == [0]
    assert hp[g, rows["tie0"]].tolist() == [2]


def _fixture(name):
    if name == "bench":
        batch, _ = bench_gap_batch(G=64)
        return (tb.batch_args(batch, 2 * batch.shape3[1] + 64), batch.D,
                batch.nc_cap)
    return fuzz_args(name)


@pytest.mark.parametrize("name,placement,route", [
    ("bench", "shared", "bulk"),   # table, sums and rows in shared memory
    (8, "shared", "bulk"),         # the dense shape: one block per SM
    (9, "mixed", "bulk"),          # a 256 KiB table stays in global memory
    (10, "shared", "loads")])      # 100-byte rows: no bulk copy
def test_kernel_placement(cuda, name, placement, route):
    args, D, nc_cap = _fixture(name)
    G = args[0].shape[0]
    p0 = dict(tf3.run_batch_fused3.placements)
    r0 = dict(tf3.run_batch_fused3.row_routes)
    _both(args, D, nc_cap, cuda)
    assert tf3.run_batch_fused3.placements[placement] - p0[placement] == G
    assert tf3.run_batch_fused3.row_routes[route] - r0[route] == G


@pytest.mark.parametrize("n_cand,slots", [(512, "slots_shared"),
                                          (520, "slots_shared"),
                                          (1030, "slots_global")])
def test_kernel_wide_nc_cap(cuda, n_cand, slots):
    """nc_cap 512, 528 and 1040: the slot arrays (244 bytes a row slot)
    in shared memory while they fit, else in a per-lane global buffer."""
    args, D, nc_cap = wide_args(n_cand)
    G = args[0].shape[0]
    p0 = dict(tf3.run_batch_fused3.placements)
    _, st = _both(args, D, nc_cap, cuda)
    assert tf3.run_batch_fused3.placements[slots] - p0[slots] == G
    assert (st[1:, 3] > 0).all()


@pytest.mark.parametrize("name", ["bench", 9])
def test_kernel_seed_table(cuda, name):
    """At max_iters 0 the kernel's table write-back is the seed table of
    _seed_count_table_b, in shared memory (bench) and in global (trial 9)."""
    args, D, nc_cap = _fixture(name)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in args]
    t[11] = torch.zeros_like(t[11])
    G, R, S = t[0].shape
    out = torch.full((G, 2 * D, S), -1.0, device=cuda)
    hp, st = tf3.run_batch_fused3(*t, D=D, nc_cap=nc_cap, table_out=out)
    seed = tf._seed_count_table_b(t[0], t[2], t[3], t[1], D)
    torch.cuda.synchronize()
    assert torch.equal(out, seed)
    assert torch.equal(hp, t[2]) and not st[:, [0, 2, 3]].any()


def test_kernel_phase_cycles(cuda):
    args, D, nc_cap = fuzz_args(1)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in args]
    cycles = torch.zeros((t[0].shape[0], 6), dtype=torch.int64, device=cuda)
    hp, st = tf3.run_batch_fused3(*t, D=D, nc_cap=nc_cap, phase_cycles=cycles)
    h0, s0 = tf3.run_batch_fused3(*t, D=D, nc_cap=nc_cap)
    torch.cuda.synchronize()
    assert torch.equal(hp, h0) and torch.equal(st, s0)
    ran = st[:, 0] > 0
    assert (cycles[:, 0] > 0).all() and (cycles[ran][:, 3] > 0).all()


def test_dispatch_engines_agree(cuda):
    batch, _ = bench_gap_batch(G=32)
    hk = tb.run_gap_batch(batch, engine="cuda", device=cuda)
    hpl = tb.run_gap_batch(batch, engine="torch", device=cuda)
    assert np.array_equal(hk, hpl)


def _gens_stepwise(args, D, nc_cap, device):
    """Gens 1 and 2 with every kernel step held against its plain version;
    both loops' (hp, stats) must equal the loop kernel's."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args]
    score = checked_step(tf.score_candidates_batch, tf.score_plain)
    step = checked_step(tf.step_fused2, tf.score_commit_plain,
                        in_place=(3, 4))
    n1, n2 = tf.score_candidates_batch.launches, tf.step_fused2.launches
    h1, s1 = tf.run_batch_fused(*t, D=D, nc_cap=nc_cap, score=score)
    h2, s2 = tf.run_batch_fused2(*t, D=D, nc_cap=nc_cap, step=step)
    h3, s3 = tf3.run_batch_fused3(*t, D=D, nc_cap=nc_cap)
    torch.cuda.synchronize()
    assert tf.score_candidates_batch.launches - n1 == score.calls
    assert tf.step_fused2.launches - n2 == step.calls
    assert score.calls == step.calls == int(s3[:, 0].max())
    for h, s in ((h1, s1), (h2, s2)):
        assert torch.equal(h, h3) and torch.equal(s, s3)
    return h3.cpu().numpy(), s3.cpu().numpy()


@pytest.mark.parametrize("trial", range(N_FUZZ_CARD))
def test_step_kernels_match_plain_fuzz(cuda, trial):
    _gens_stepwise(*fuzz_args(trial), cuda)


def test_step_kernels_match_plain_near_tie(cuda):
    args, D, nc_cap, layout = near_tie_args()
    hp, _ = _gens_stepwise(args, D, nc_cap, cuda)
    g, _, row = layout["gate"]
    assert hp[g, row] == 0


def test_gens_agree_bench_shape(cuda):
    batch, _ = bench_gap_batch(G=64)
    hp, st = _gens_stepwise(tb.batch_args(batch, 2 * batch.shape3[1] + 64),
                            batch.D, batch.nc_cap, cuda)
    assert (hp <= 1).sum() > 0 and (st[:, 3] > 0).all()


def test_step_kernels_match_plain_crafted(cuda):
    args, D, nc_cap, layout = crafted_args()
    hp, _ = _gens_stepwise(args, D, nc_cap, cuda)
    g, rows = layout["reuse_tie"]
    assert hp[g, rows["tie1"]].tolist() == [0]


def test_step_kernels_wide_nc(cuda):
    """NC 1040: every step of both kernels equal to its plain version."""
    args, D, nc_cap = wide_args(1030)
    assert nc_cap == 1040
    _, st = _gens_stepwise(args, D, nc_cap, cuda)
    assert (st[1:, 3] > 0).all()


def test_step_kernels_int32_ids(cuda):
    """The bench shape with its ids widened to int32 (4 sites a 16-byte
    load)."""
    batch, _ = bench_gap_batch(G=64)
    args = list(tb.batch_args(batch, 2 * batch.shape3[1] + 64))
    args[0] = args[0].astype(np.int32)
    hp, _ = _gens_stepwise(args, batch.D, batch.nc_cap, cuda)
    assert (hp <= 1).sum() > 0


def test_step_kernels_slot_sums_global(cuda):
    """NC 8192: the slots' sums (32 bytes a slot) exceed shared memory, so
    both kernels keep them in a per-lane global buffer; one step of each
    equals its plain version."""
    rng = np.random.default_rng(7)
    G, NC, S, D, R = 2, 8192, 64, 4, 9000
    cnt = rng.integers(0, 4, size=(G, 2 * D, S)).astype(np.float32)
    cids = rng.integers(-1, D, size=(G, NC, S)).astype(np.int8)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in (("cnt", cnt),
                                                       ("cids", cids))}
    sums = t["cnt"].view(G, D, 2, S).sum(dim=1).contiguous()
    lo = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    hi = torch.tensor([S, 40], dtype=torch.int32, device=cuda)
    kernels = (tf.score_candidates_batch, tf.step_fused2)
    before = [dict(f.placements) for f in kernels]
    got = tf.score_candidates_batch(t["cnt"], sums, t["cids"], lo, hi, D=D)
    assert torch.equal(got, tf.score_plain(t["cnt"], sums, t["cids"], lo,
                                           hi, D))
    reads = np.stack([rng.permutation(R)[:NC] for _ in range(G)])
    cmeta = np.stack([reads, rng.integers(0, 2, size=(G, NC)),
                      np.ones((G, NC)), np.zeros((G, NC))], 1)
    scal = np.array([[0, 3, 2, S - 4, 1, 0, 0, 0]] * G)
    args = [torch.from_numpy(a.astype(np.int32)).to(cuda)
            for a in (scal, cmeta)] + [t["cids"], t["cnt"],
                                       torch.full((G, R), 2, dtype=torch.int32,
                                                  device=cuda)]
    want = tf.score_commit_plain(*[a.clone() for a in args], D=D)
    for a, b in zip(tf.step_fused2(*args, D=D), want):
        assert torch.equal(a, b)
    for f, p0 in zip(kernels, before):
        assert f.placements["slots_global"] - p0["slots_global"] == G


@pytest.mark.parametrize("name,placement", [
    ("bench", "shared"),   # table, sums and slots' sums in shared memory
    (9, "mixed")])         # a 256 KiB table stays in global memory
def test_step_kernel_placement(cuda, name, placement):
    args, D, nc_cap = _fixture(name)
    G = args[0].shape[0]
    kernels = (tf.score_candidates_batch, tf.step_fused2)
    before = [(f.launches, dict(f.placements)) for f in kernels]
    _gens_stepwise(args, D, nc_cap, cuda)
    for f, (n0, p0) in zip(kernels, before):
        n = f.launches - n0
        assert n > 0 and f.placements[placement] - p0[placement] == n * G


@pytest.mark.parametrize("gen", ["1", "2"])
def test_dispatch_gens_agree(cuda, monkeypatch, gen):
    batch, _ = bench_gap_batch(G=32)
    h3 = tb.run_gap_batch(batch, engine="cuda", device=cuda)
    monkeypatch.setenv("POMFRET_FUSED_GEN", gen)
    name = "score_kernel" if gen == "1" else "score_commit_kernel"
    n0 = tb.DISPATCH_STATS["kernel_launches"][name]
    hk = tb.run_gap_batch(batch, engine="cuda", device=cuda)
    assert tb.DISPATCH_STATS["kernel_launches"][name] > n0
    hpl = tb.run_gap_batch(batch, engine="torch", device=cuda)
    assert np.array_equal(hk, h3) and np.array_equal(hpl, h3)


@pytest.mark.parametrize("stem,variant", sorted(tpr.PROBES))
def test_probe_kernel_matches_plain(cuda, stem, variant):
    p = tpr.PROBES[(stem, variant)]
    fn = kp.PROBE_KERNELS[p.kernel]
    n0 = fn.launches
    inputs, _, _, ok, msg = tpr.run_probe(p, cuda)
    torch.cuda.synchronize()
    assert ok, msg
    assert fn.launches > n0
    kernel, plain_fn = tpr.compared(p)
    t = tpr.tensors(inputs, cuda)
    for a, b in zip(p.call(kernel, t), p.call(plain_fn, t)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n_iter", [1, 3])
def test_probe_stile_full_equals_tiled(cuda, n_iter):
    inp = tpr.stile_make()
    rng = np.random.default_rng(7)
    lo = rng.integers(0, 900, size=len(inp["ranges"]))
    inp["ranges"] = np.stack([lo, lo + rng.integers(0, 600, size=len(lo))],
                             1).astype(np.int32)
    t = tpr.tensors(inp, cuda)
    out = [kp.stile(t["cnt"], t["cids"], t["ranges"], tiled=tiled,
                    n_iter=n_iter) for tiled in (False, True)]
    plain = kp.stile_plain(t["cnt"], t["cids"], t["ranges"], tiled=False,
                           n_iter=n_iter)
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], plain)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_probe_row_copy_edges(cuda, dtype):
    """Rows outside [0, R) copy nothing, slots outside [0, NB) place
    nothing, on the card as in the plain version; without keep_buf the
    buffer is not written back; the total of a launch does not carry over
    into the next (nothing outlives a launch)."""
    src = (torch.arange(4 * 6 * 64) % 7 - 1).to(dtype).view(4, 6, 64)
    rows = torch.tensor([0, 5, -1, 3], dtype=torch.int32)
    slots = torch.tensor([1, 0, 0, 3], dtype=torch.int32)
    for sum_stage in (False, True):
        for keep_buf in (False, True):
            for _ in range(3):
                want = kp.row_copy_plain(src, rows, slots, W=2, NB=4,
                                         sum_stage=sum_stage,
                                         keep_buf=keep_buf)
                got = kp.row_copy(src.to(cuda), rows.to(cuda),
                                  slots.to(cuda), W=2, NB=4,
                                  sum_stage=sum_stage, keep_buf=keep_buf)
                assert torch.equal(got[0].cpu(), want[0])
                assert torch.equal(got[1].cpu(), want[1])
                assert (got[2] is None) == (not keep_buf)
                if keep_buf:
                    assert torch.equal(got[2].cpu(), want[2])


def test_probe_kernels_refuse_what_they_cannot_take(cuda):
    src = torch.zeros(2, 4, 8, dtype=torch.int8, device=cuda)  # 8-byte rows
    idx = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        kp.row_copy(src, idx, idx, W=1, NB=1)
    for L in (0, kp.MAX_CLUSTER_LANES + 1):      # one cluster of 1-16 blocks
        src = torch.zeros(L, 4, 16, dtype=torch.int8, device=cuda)
        idx = torch.zeros(L, dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="cluster"):
            kp.row_copy(src, idx, idx, W=1, NB=1)
    cnt = torch.zeros(1, 2 * 64, 1536, device=cuda)  # 64 planes: 417 KB
    cids = torch.zeros(1, 1, 1536, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        kp.stile(cnt, cids, idx[:2].view(1, 2), tiled=False)
    with pytest.raises(ValueError, match="multiple of 4"):
        kp.lane_vec(torch.zeros(6, 8, dtype=torch.int32, device=cuda),
                    "smem_dma")


# ---------------------------------------------------------------------------
# The redesigned stile and row_copy kernels on their edge cases, bit for bit
# against the plain versions (on the CPU, from the same inputs)
# ---------------------------------------------------------------------------

def _stile_check(inp, cuda, n_iters, rcp):
    t = tpr.tensors(inp, "cpu")
    c = tpr.tensors(inp, cuda)
    for n_iter in n_iters:
        want = kp.stile_plain(t["cnt"], t["cids"], t["ranges"], tiled=False,
                              n_iter=n_iter)
        for tiled in (False, True):
            got = kp.stile_divided(c["cnt"], c["cids"], c["ranges"],
                                   tiled=tiled, n_iter=n_iter, rcp=rcp)
            assert torch.equal(got.cpu(), want), (n_iter, tiled)


@pytest.mark.parametrize("rcp", [True, False])
def test_probe_stile_iterations(cuda, rcp):
    """probe_stile's inputs at 1, 3 and 400 iterations, and with a range
    of its own per row."""
    inp = tpr.stile_make()
    _stile_check(inp, cuda, (1, 3, 400), rcp)
    lo = np.random.default_rng(7).integers(0, 900, size=len(inp["ranges"]))
    inp["ranges"] = np.stack([lo, lo + 300], 1).astype(np.int32)
    _stile_check(inp, cuda, (3,), rcp)


@pytest.mark.parametrize("rcp", [True, False])
@pytest.mark.parametrize("case", sorted(testing.STILE_EDGE_RANGES))
def test_probe_stile_edge_ranges(cuda, case, rcp):
    """lo < 0, hi > S, lo >= hi, tiles that differ by row, ids outside
    [0, D); at (B, NC) = (32, 16), (1, 16), (32, 1), (1, 1), and at 400
    iterations for the full batch."""
    for seed, (B, NC) in enumerate(((32, 16), (1, 16), (32, 1), (1, 1))):
        inp = testing.stile_edge_inputs(case, seed, B, NC)
        _stile_check(inp, cuda, (1, 3, 400) if seed == 0 else (3,), rcp)


@pytest.mark.parametrize("S,D,NC", [(99, 4, 6), (1537, 2, 5), (64, 8, 4)])
def test_probe_stile_other_shapes(cuda, S, D, NC):
    """Rows that are not 16-byte multiples (staged by loads, not bulk
    copies), eight count planes, NC not a multiple of the warps a block."""
    inp = testing.stile_edge_inputs("tiles_differ_by_row", S, 5, NC, D, S)
    _stile_check(inp, cuda, (1, 7), True)


@pytest.mark.parametrize("scale", [2.0 ** 110, 2.0 ** -110])
def test_probe_stile_counts_outside_the_reciprocal_range(cuda, scale):
    """Counts outside [2^-100, 2^100], where the reciprocal's quotient need
    not be the IEEE one, send their block to __fdiv_rn: equal bit for bit
    still (small integers times one power of two keep the f64 sums
    exact)."""
    inp = tpr.stile_make()
    inp["cnt"] = (inp["cnt"] * np.float32(scale)).astype(np.float32)
    _stile_check(inp, cuda, (1, 3), True)


@pytest.mark.parametrize("rcp", [True, False])
def test_probe_stile_division_is_ieee(cuda, rcp):
    """stile_kernel's quotient equals the IEEE quotient (the plain version's
    on the CPU) for every integer c0 in [1, 2^16] against all 400 divisors
    of probe_stile2, for random normal c0 and for zeros, subnormals,
    infinities and huge values."""
    ints = np.arange(1, 2 ** 16 + 1, dtype=np.float32)
    rand = np.exp2(np.random.default_rng(5).uniform(-126, 127, 1 << 16))
    special = np.array([0.0, -0.0, 2.0 ** -149, 2.0 ** -130, 2.0 ** -101,
                        2.0 ** 101, 3.0e38, np.inf, -np.inf, -1.0, -7.0],
                       np.float32)
    c0 = torch.from_numpy(np.concatenate([ints, rand.astype(np.float32),
                                          special]))
    n0 = kp.stile_ratios.launches
    got = kp.stile_ratios(c0.to(cuda), 400, rcp=rcp).cpu()
    assert kp.stile_ratios.launches == n0 + 1
    want = kp.stile_ratios_plain(c0, 400)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _row_copy_check(src, rows, slots, W, cuda):
    R = src.shape[1]
    for NB in (0, W, W + 3):
        for sum_stage in (False, True):
            for keep_buf in (False, True):
                want = kp.row_copy_plain(src, rows, slots, W=W, NB=NB,
                                         sum_stage=sum_stage,
                                         keep_buf=keep_buf)
                got = kp.row_copy(src.to(cuda), rows.to(cuda),
                                  slots.to(cuda), W=W, NB=NB,
                                  sum_stage=sum_stage, keep_buf=keep_buf)
                assert torch.equal(got[0].cpu(), want[0]), (R, W, NB)
                assert torch.equal(got[1].cpu(), want[1])
                assert (got[2] is None) == (not keep_buf)
                if keep_buf:
                    assert torch.equal(got[2].cpu(), want[2])


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("W", [1, 17, 64])
def test_probe_row_copy_rows_slots(cuda, dtype, W):
    """W = 1, 17 and R (one chunk to four), rows -1, R-W and R-W+1, slots
    in and out of range, NB = 0, W and W+3, with and without keep_buf, at
    the most lanes one cluster takes."""
    R, S, L = 64, 256, kp.MAX_CLUSTER_LANES
    r = np.random.default_rng(W)
    src = torch.from_numpy(r.integers(-128, 128, size=(L, R, S))).to(dtype)
    rows = torch.tensor(([-1, R - W, R - W + 1, 0] * 4)[:L], dtype=torch.int32)
    slots = torch.tensor(([0, 3, -1, 1, 2, 0, 5, 0] * 2)[:L],
                         dtype=torch.int32)
    _row_copy_check(src, rows, slots, W, cuda)


@pytest.mark.parametrize("L", range(1, kp.MAX_CLUSTER_LANES + 1))
def test_probe_row_copy_lanes(cuda, L):
    """Every cluster size from 1 to 16 lanes (above 8 non-portable)."""
    r = np.random.default_rng(L)
    src = torch.from_numpy(r.integers(-5, 100, size=(L, 32, 64))).to(
        torch.int32)
    rows = torch.from_numpy(r.integers(-2, 32, size=L)).to(torch.int32)
    slots = torch.from_numpy(r.integers(-1, 6, size=L)).to(torch.int32)
    _row_copy_check(src, rows, slots, 4, cuda)


def test_probe_row_copy_two_streams(cuda):
    """Two launches in flight at once on two streams: each keeps its own
    lane sums and total (no counter or other state shared between
    launches)."""
    assert testing.row_copy_two_streams(cuda, trials=20) == []


# ---------------------------------------------------------------------------
# The redesigned lane_vec and v3_loop kernels, bit for bit against the
# plain versions (on the CPU, from the same inputs), and the launch floor
# ---------------------------------------------------------------------------

def _lane_vec_rows(L, Rh, seed):
    """Rows with negative values and values whose sums wrap int32."""
    r = np.random.default_rng(seed)
    hp = r.integers(-2 ** 31, 2 ** 31, size=(L, Rh), dtype=np.int64)
    hp[::2] = r.integers(-50, 50, size=hp[::2].shape)
    return torch.from_numpy(hp.astype(np.int32))


@pytest.mark.parametrize("mode", kp.LANE_VEC_MODES)
def test_probe_lane_vec_modes(cuda, mode):
    """Every mode at L in {1, 4, 8, 17, 32} and Rh in {1, 64, 1000}, with
    n_iter in {0, 1, 5, 1000} (whileloop) and dyn in 0..2L (sload_dyn);
    smem_dma where L is a multiple of 4, refused elsewhere."""
    for L in (1, 4, 8, 17, 32):
        for Rh in (1, 64, 1000):
            hp = _lane_vec_rows(L, Rh, 100 * L + Rh)
            h = hp.to(cuda)
            if mode == "smem_dma":
                if L % 4:
                    with pytest.raises(ValueError, match="multiple of 4"):
                        kp.lane_vec(h, mode)
                    continue
            kw = ([dict(n_iter=n) for n in (0, 1, 5, 1000)]
                  if mode == "whileloop" else
                  [dict(dyn=d) for d in range(2 * L + 1)]
                  if mode == "sload_dyn" else [{}])
            for k in kw:
                got = kp.lane_vec(h, mode, **k)
                assert torch.equal(got.cpu(), kp.lane_vec_plain(hp, mode, **k)
                                   ), (L, Rh, k)


# (L, R, S, NC): the registry's shape, S = 4 and 1536, NC = 1 and 16, L = 1
# and 200, R = 1 and 1000 (not a multiple of 32 at 1000: 31.25 words)
V3_SHAPES = [(8, 64, 256, 4), (8, 64, 4, 1), (8, 64, 1536, 16),
             (1, 1000, 256, 4), (8, 1000, 1536, 4), (200, 64, 256, 16),
             (8, 1, 256, 4), (200, 1000, 4, 16), (1, 64, 1536, 16)]


@pytest.mark.parametrize("L,R,S,NC", V3_SHAPES)
def test_probe_v3_loop_shapes(cuda, L, R, S, NC):
    """v3_loop (bulk copies) and v3_loop_loaded (the warp's loads) ==
    v3_loop_plain at n_iter in {0, 1, 3, NC, NC+1, 9, 400} (slots reused
    from NC+1 on; past R/2 every pick is R - 1), ids whose sums wrap int32,
    and lanes without an eligible read."""
    inp = testing.v3_inputs(L, R, S, L + R + S + NC,
                            none_eligible=range(0, L, 3))
    t = tpr.tensors(inp, "cpu")
    c = tpr.tensors(inp, cuda)
    for n_iter in sorted({0, 1, 3, NC, NC + 1, 9, 400}):
        want = kp.v3_loop_plain(t["ids"], t["hp"], NC=NC, n_iter=n_iter)
        for fn in (kp.v3_loop, kp.v3_loop_loaded):
            got = fn(c["ids"], c["hp"], NC=NC, n_iter=n_iter)
            assert torch.equal(got.cpu(), want), (fn.__name__, n_iter)


def test_probe_v3_loop_two_streams(cuda):
    """Two v3_loop launches in flight at once on two streams: each keeps
    its own slots and sums."""
    assert testing.v3_loop_two_streams(cuda, trials=20) == []


def test_probe_v3_loop_refuses_what_it_cannot_take(cuda):
    hp = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        kp.v3_loop(torch.zeros(2, 4, 6, dtype=torch.int32, device=cuda), hp,
                   NC=2, n_iter=1)
    with pytest.raises(ValueError, match="does not fit"):
        kp.v3_loop(torch.zeros(2, 4, 1024, dtype=torch.int32, device=cuda),
                   hp, NC=64, n_iter=1)


def test_probe_launch_floor_shapes(cuda):
    """The empty kernel launches at the launch shape of every registry
    entry (phase 3b's floors); each launch counts; a cluster that does not
    divide the grid is refused."""
    n0 = kp.launch_floor.launches
    shapes = {tpr.launch_shape(p, p.make()) for p in tpr.PROBES.values()}
    for shape in shapes:
        kp.launch_floor(cuda, *shape)
    torch.cuda.synchronize()
    assert kp.launch_floor.launches == n0 + len(shapes)
    assert {s[2] for s in shapes} == {0, 1, 8}
    with pytest.raises(RuntimeError, match="pomfret_probe_empty_launch"):
        kp.launch_floor(cuda, (3, 1), 32, 2)


def test_probe_launchers_refuse_other_shapes(cuda):
    """row_copy's and lane_vec's launchers take their launch shape from the
    wrapper (row_copy_shape, lane_vec_shape: the shapes the floors are
    timed at) and refuse any other, so the two cannot drift apart."""
    from pomfret_tpu_torch.kernels.engine_fused import _launch
    src = torch.zeros(2, 4, 16, dtype=torch.int8, device=cuda)
    idx = torch.zeros(2, dtype=torch.int32, device=cuda)
    sums = torch.empty(3, dtype=torch.int32, device=cuda)
    _, chunks, chunk = kp.row_copy_plan(1, 16, 1)
    _, threads, cluster = kp.row_copy_shape(2)
    for bad in ((threads // 2, cluster), (threads, cluster - 1)):
        with pytest.raises(RuntimeError, match="row_copy"):
            _launch(cuda, "pomfret_probe_row_copy_launch", 1, src.data_ptr(),
                    idx.data_ptr(), idx.data_ptr(), None, sums.data_ptr(),
                    sums[2:].data_ptr(), 2, 4, 16, 1, 0, 1, chunks, chunk,
                    *bad)
    hp = torch.zeros(4, 8, dtype=torch.int32, device=cuda)
    mode = kp.LANE_VEC_MODES.index("smem_dma")
    _, threads, cluster = kp.lane_vec_shape(4, "smem_dma")
    for bad in ((threads - 32, cluster), (threads, 0)):
        with pytest.raises(RuntimeError, match="lane_vec"):
            _launch(cuda, "pomfret_probe_lane_vec_launch", hp.data_ptr(),
                    sums.data_ptr(), 4, 8, mode, 0, 0, *bad)
    torch.cuda.synchronize()
