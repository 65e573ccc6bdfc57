"""The port's per-iteration engines (v1, v2) vs the JAX package's, on the CPU.

- Steps: score_plain against the Pallas _score_kernel and
  score_commit_plain against the Pallas _score_commit_kernel, both run in
  interpret mode (engine_fused.score_candidates_batch / _step_fused2,
  interpret=True), on the same numpy inputs: the seed state and one
  mid-loop state of fuzz trials 0-7. Tolerance: the count rows, flags, cnt
  and hp exact. The score rows differ by rounding only: the port rounds
  the exact sum of a row's n positive ratios once, the Pallas kernel adds
  them in f32 in its own order, which any order keeps within (n-1) * 2**-24
  of the exact sum, relative to it; so |port - pallas| <= (n+1) * 2**-24 *
  port, n = the row's l_found. (Up to 4 ulp apart on these fixtures.)
- Loops: run_batch_fused / run_batch_fused2 against the JAX loops in
  interpret mode and the vmapped XLA engine (_run_batch_jit): hp exact; and
  against the port's loop_plain: hp and stats exact, each lane's iteration
  count included.
- The engine-generation selector against pomfret_tpu.parallel.batch's.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from pomfret_tpu.core.methmer import (get_methmer_sites_and_ranges,
                                      store_mmr_of_reads, wipe_mmr_of_reads)
from pomfret_tpu.core.readset import (READBACK, MmrConfig,
                                      load_reads_given_interval)
from pomfret_tpu.io.bam import BamReader
from pomfret_tpu.kernels import engine_fused as jf
from pomfret_tpu.kernels.engine_jax import _round_up, build_gap_device_data
from pomfret_tpu.parallel import batch as jb
from pomfret_tpu.testing import SynthConfig, make_two_block_scenario
from pomfret_tpu_torch.kernels import engine_fused as tf
from pomfret_tpu_torch.kernels import engine_fused3 as tf3
from pomfret_tpu_torch.parallel import batch as tb
from pomfret_tpu_torch.testing import N_FUZZ, fuzz_args, near_tie_args
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

torch.set_num_threads(1)

MID_ITERS = 3  # the mid-loop state: after this many iterations

# the Pallas calls under jit, as the JAX loops make them: one trace per
# shape serves both states of a trial
_pallas_score = jax.jit(jf.score_candidates_batch,
                        static_argnames=("D", "bg", "interpret"))
_pallas_step = jax.jit(jf._step_fused2,
                       static_argnames=("D", "nc_cap", "bg", "interpret"))


def _tensors(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _step_inputs(args, D, nc_cap, n_iter):
    """The inputs of iteration n_iter + 1 of every lane, from the port's
    plain v2 loop cut at n_iter iterations: its hp and stats, and the count
    table rebuilt from them (the seeds plus every read the loop tagged)."""
    t = _tensors(args)
    (ids, has_mmr, hp_init, seed_ok, n_reads, n_sites, q_break, min0, max0,
     cov, n_cand, max_iters) = t
    cut = torch.minimum(max_iters, torch.full_like(max_iters, n_iter))
    hp, st = tf.run_batch_fused2(*t[:11], cut, D=D, nc_cap=nc_cap,
                                 step=tf.score_commit_plain)
    G, R, S = ids.shape
    cnt = tf._seed_count_table_b(ids, hp, seed_ok | (hp != hp_init), has_mmr,
                                 D)
    it, q_last, failed = st[:, 0], st[:, 1], st[:, 2]
    active = (q_last < q_break) & (failed <= 10) & (it < max_iters)
    n_slots = torch.clamp(n_cand.to(torch.int64), max=nc_cap)
    cand_read, cand_valid = tf._candidates_b(hp, q_last, n_reads, n_slots,
                                             nc_cap)
    cids = tf._gather_rows(ids, cand_read)
    sums = cnt.view(G, D, 2, S).sum(dim=1)
    min_i, max_i = tf._range_from_seed_b(sums.sum(dim=1), cov, min0, max0,
                                         n_sites)
    z = torch.zeros_like(min0)
    scal = torch.stack([min0, max0, cov, n_sites, active.to(torch.int32), z,
                        z, z], dim=1)
    cmeta = torch.stack([cand_read.to(torch.int32),
                         cand_valid.to(torch.int32),
                         has_mmr.gather(1, cand_read).to(torch.int32),
                         torch.zeros_like(cand_valid, dtype=torch.int32)],
                        dim=1)
    return dict(cnt=cnt, sums=sums, cids=cids, min_i=min_i, max_i=max_i,
                scal=scal, cmeta=cmeta, hp=hp, active=active)


def _assert_sums_close(got, ref, n):
    """got: exact sums of n positive f32 terms rounded once; ref: the same
    sums added in f32 in any order (see the module docstring)."""
    err = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    assert (err <= (n + 1) * 2.0 ** -24 * got.astype(np.float64)).all()


@pytest.mark.parametrize("n_iter", [0, MID_ITERS])
@pytest.mark.parametrize("trial", range(N_FUZZ))
def test_steps_match_pallas(trial, n_iter):
    args, D, nc_cap = fuzz_args(trial)
    x = _step_inputs(args, D, nc_cap, n_iter)
    if n_iter:
        assert x["active"].any()  # a real mid-loop state
    npx = {k: v.numpy() for k, v in x.items()}
    cids32 = npx["cids"].astype(np.int32)   # the JAX loops widen the ids

    # v1: scores of every slot
    got = tf.score_plain(x["cnt"], x["sums"], x["cids"], x["min_i"],
                         x["max_i"], D).numpy()
    ref = np.asarray(_pallas_score(
        npx["cnt"], npx["sums"], cids32, npx["min_i"], npx["max_i"], D=D,
        bg=8, interpret=True))
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got[:, 2:], ref[:, 2:])
    _assert_sums_close(got[:, :2], ref[:, :2], got[:, 2:4])
    assert (got[:, 2] > 0).any()            # the fixture scores something

    # v2: one whole iteration, cnt and hp updated in place
    cnt, hp = x["cnt"].clone(), x["hp"].clone()
    c2, h2, fl = tf.score_commit_plain(x["scal"], x["cmeta"], x["cids"], cnt,
                                       hp, D)
    assert c2 is cnt and h2 is hp
    rc, rh, rf = (np.asarray(a) for a in _pallas_step(
        npx["scal"], npx["cmeta"], cids32, npx["cnt"], npx["hp"], D=D,
        nc_cap=nc_cap, bg=8, interpret=True))
    assert np.array_equal(cnt.numpy(), rc)
    assert np.array_equal(hp.numpy(), rh)
    assert np.array_equal(fl.numpy(), rf)
    assert not fl.numpy()[~npx["active"]].any()   # inactive lanes: no commit


def _loops(args, D, nc_cap):
    """(hp, stats) of the port's v1 and v2 loops through their wrappers
    (CPU tensors: the plain steps, no launch counted) and of loop_plain."""
    t = _tensors(args)
    n1 = tf.score_candidates_batch.launches
    n2 = tf.step_fused2.launches
    out = {"1": tf.run_batch_fused(*t, D=D, nc_cap=nc_cap),
           "2": tf.run_batch_fused2(*t, D=D, nc_cap=nc_cap),
           "3": tf3.loop_plain(*t, D=D, nc_cap=nc_cap)}
    assert tf.score_candidates_batch.launches == n1
    assert tf.step_fused2.launches == n2
    return {g: (h.numpy(), s.numpy()) for g, (h, s) in out.items()}


@pytest.mark.parametrize("trial", list(range(N_FUZZ)) + ["near_tie"])
def test_gens_match_loop_plain(trial):
    """Gens 1 and 2 equal loop_plain (gen 3): hp and all of stats."""
    if trial == "near_tie":
        args, D, nc_cap, _ = near_tie_args()
    else:
        args, D, nc_cap = fuzz_args(trial)
    out = _loops(args, D, nc_cap)
    for gen in ("1", "2"):
        assert np.array_equal(out[gen][0], out["3"][0]), gen
        assert np.array_equal(out[gen][1], out["3"][1]), gen
    # the plain steps directly give the same as the wrappers on the CPU
    t = _tensors(args)
    h, s = tf.run_batch_fused2(*t, D=D, nc_cap=nc_cap,
                               step=tf.score_commit_plain)
    assert np.array_equal(h.numpy(), out["3"][0])
    assert np.array_equal(s.numpy(), out["3"][1])


def _assert_loops_match_jax(args, D, nc_cap):
    hv = np.asarray(jb._run_batch_jit(*args, D=D, nc_cap=nc_cap))
    h1 = np.asarray(jf.run_batch_fused(*args, D=D, nc_cap=nc_cap, bg=8,
                                       interpret=True))
    h2 = np.asarray(jf.run_batch_fused2(*args, D=D, nc_cap=nc_cap, bg=8,
                                        interpret=True))
    out = _loops(args, D, nc_cap)
    for gen, ref in (("1", h1), ("2", h2)):
        assert np.array_equal(out[gen][0], ref), gen
        assert np.array_equal(out[gen][0], hv), gen
    return hv


@pytest.mark.parametrize("trial", [0, 3])
def test_loops_match_jax_fuzz(trial):
    args, D, nc_cap = fuzz_args(trial)
    hv = _assert_loops_match_jax(args, D, nc_cap)
    assert (hv[0] == args[2][0]).all()      # the dead lane is untouched


def test_loops_match_jax_scenario(tmp_path):
    """The noisy trans two-block batch of tests/test_engine_fused.py."""
    cfg_s = SynthConfig(noise=0.05, nocall=0.05, seed=11,
                        ref_len=200_000, read_len=20_000, read_stagger=900)
    bam, vcf, truth = make_two_block_scenario(str(tmp_path), trans=True,
                                              cfg=cfg_s)
    cfg = MmrConfig(cov_for_selection=5, cov_for_runtime=10)
    gs, ge = truth["gap"]
    rs = load_reads_given_interval(BamReader(bam), "chr1", gs, ge, READBACK,
                                   cfg)
    datas = []
    for direction in (0, 1):
        ms = get_methmer_sites_and_ranges(rs, cfg, direction)
        store_mmr_of_reads(rs, ms)
        datas.append(build_gap_device_data(
            rs, ms, direction, _round_up(rs.n, 128), _round_up(ms.n, 128)))
        wipe_mmr_of_reads(rs)
    batch = jb.pack_gap_batch(datas * 4, [10] * 8, n_cand=14)
    args = jb.batch_args(batch, 2 * batch.ids.shape[1] + 64)
    hv = _assert_loops_match_jax(args, batch.D, batch.nc_cap)
    assert (hv <= 1).sum() > 0


_GEN_ENVS = [({}, "3"), ({"POMFRET_FUSED_GEN": "1"}, "1"),
             ({"POMFRET_FUSED_GEN": "2"}, "2"),
             ({"POMFRET_FUSED_GEN": "3"}, "3"),
             ({"POMFRET_FUSED_GEN": "7"}, "3"),
             ({"POMFRET_FUSED_V2": "0"}, "1")]


@pytest.mark.parametrize("env,gen", _GEN_ENVS)
def test_fused_gen_matches_jax(monkeypatch, env, gen):
    for k in ("POMFRET_FUSED_GEN", "POMFRET_FUSED_V2"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tb._fused_gen() == jb._fused_gen() == gen


@pytest.mark.parametrize("gen", ["1", "2", "3"])
def test_run_batch_reaches_the_selected_loop(monkeypatch, gen):
    """_run_batch runs the loop POMFRET_FUSED_GEN names: the kernel
    wrappers' loop for "cuda", the plain steps' for "torch"."""
    loops = {"1": "run_batch_fused", "2": "run_batch_fused2",
             "3": "run_batch_fused3"}
    assert tb._loop_for("cuda", gen) is getattr(tf if gen != "3" else tf3,
                                                loops[gen])
    calls = []

    def spy(name):
        real = getattr(tb, name)

        @functools.wraps(real)
        def fn(*a, **kw):
            calls.append((name, kw.get("score", kw.get("step"))))
            return real(*a, **kw)
        return fn

    for name in ("run_batch_fused", "run_batch_fused2", "loop_plain"):
        monkeypatch.setattr(tb, name, spy(name))
    monkeypatch.setenv("POMFRET_FUSED_GEN", gen)
    args, D, nc_cap = fuzz_args(0)
    batch = tb.GapBatch(*args[:2], args[2], args[3], np.zeros_like(args[2]),
                        *args[4:11], D=D, nc_cap=nc_cap)
    hp, _ = tb._run_batch(tb.batch_tensors(batch, int(args[11][0]), "cpu"),
                          batch, "torch")
    want = {"1": ("run_batch_fused", tf.score_plain),
            "2": ("run_batch_fused2", tf.score_commit_plain),
            "3": ("loop_plain", None)}[gen]
    assert calls == [want]
    ref, _ = tf3.loop_plain(*_tensors(args), D=D, nc_cap=nc_cap)
    assert torch.equal(hp, ref)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tb._run_batch(tb.batch_tensors(batch, 8, "cpu"), batch, "cuda")


def test_wrappers_reject_other_devices():
    args, D, nc_cap = fuzz_args(0)
    x = {k: v.to("meta") for k, v in
         _step_inputs(args, D, nc_cap, 0).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        tf.score_candidates_batch(x["cnt"], x["sums"], x["cids"], x["min_i"],
                                  x["max_i"], D=D)
    with pytest.raises(ValueError, match="unsupported device"):
        tf.step_fused2(x["scal"], x["cmeta"], x["cids"], x["cnt"], x["hp"],
                       D=D)


def test_checked_step():
    """testing.checked_step (chip_smoke.py's step check) passes equal
    steps through and raises on the first step that differs."""
    from pomfret_tpu_torch.testing import checked_step
    args, D, nc_cap = fuzz_args(1)
    t = _tensors(args)
    step = checked_step(tf.step_fused2, tf.score_commit_plain,
                        in_place=(3, 4))
    hp, st = tf.run_batch_fused2(*t, D=D, nc_cap=nc_cap, step=step)
    ref, ref_st = tf3.loop_plain(*t, D=D, nc_cap=nc_cap)
    assert torch.equal(hp, ref) and torch.equal(st, ref_st)
    assert step.calls == int(st[:, 0].max()) and step.max_abs_err == 0.0
    assert len(step.first[0]) == 5

    def off_by_one(*a, **kw):
        out = tf.score_plain(*a, **kw)
        out[0, 0, 0] += 1.0
        return out
    score = checked_step(off_by_one, tf.score_plain)
    with pytest.raises(RuntimeError, match="off_by_one != score_plain at "
                                           "call 0, output 0"):
        tf.run_batch_fused(*t, D=D, nc_cap=nc_cap, score=score)
