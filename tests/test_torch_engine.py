"""The port's plain greedy loop vs the JAX package's engines, on the CPU.

pomfret_tpu_torch.kernels.engine_fused3.loop_plain must give the same final
hp vectors as the vmapped XLA engine (parallel.batch._run_batch_jit) and as
the Pallas v3 kernel in interpret mode (engine_fused3.run_batch_fused3),
and the same stats[:, 1:4] = [q_last, failed, commits] as
run_batch_fused3_core(with_stats=True). Tolerance: exact (array_equal);
the outputs are integer tags and counters. stats[:, 0] is not compared:
the port counts each lane's own iterations, the Pallas kernel its lane
block's.
"""
import functools
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from pomfret_tpu.core.engine_host import (CountTable, predict_tags_of_reads,
                                          update_available_methmer_range)
from pomfret_tpu.core.methmer import (get_methmer_sites_and_ranges,
                                      store_mmr_of_reads, wipe_mmr_of_reads)
from pomfret_tpu.core.readset import (READBACK, MmrConfig,
                                      load_reads_given_interval)
from pomfret_tpu.io.bam import BamReader
from pomfret_tpu.kernels.engine_fused3 import (run_batch_fused3,
                                               run_batch_fused3_core)
from pomfret_tpu.kernels.engine_jax import _round_up, build_gap_device_data
from pomfret_tpu.parallel.batch import (_run_batch_jit, batch_args,
                                        pack_gap_batch)
from pomfret_tpu.testing import SynthConfig, make_two_block_scenario
from pomfret_tpu_torch.kernels import engine_fused3 as tf3
from pomfret_tpu_torch.testing import (CRAFTED_LANES, N_FUZZ,
                                       NEAR_TIE_LANES, crafted_args,
                                       fuzz_args, near_tie_args, wide_args)
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

torch.set_num_threads(1)


def _assert_port_matches_jax(args, D, nc_cap, jitted_entry=False):
    """loop_plain (and the wrapper on CPU tensors) vs the JAX paths.

    run_batch_fused3 is jax.jit(run_batch_fused3_core); the with_stats
    call returns the same kernel's hp plus its stats, so one interpret-mode
    compile serves both checks. jitted_entry additionally runs the jitted
    entry point itself."""
    hv = np.asarray(_run_batch_jit(*args, D=D, nc_cap=nc_cap))
    core = jax.jit(functools.partial(run_batch_fused3_core, D=D,
                                     nc_cap=nc_cap, bg=8, interpret=True,
                                     with_stats=True))
    h3, st3 = (np.asarray(a) for a in core(*args))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    hp, st = tf3.loop_plain(*targs, D=D, nc_cap=nc_cap)
    assert hp.dtype == torch.int32 and st.dtype == torch.int32
    assert np.array_equal(hp.numpy(), hv)
    assert np.array_equal(hp.numpy(), h3)
    assert np.array_equal(st.numpy()[:, 1:4], st3[:, 1:4])
    if jitted_entry:
        he = np.asarray(run_batch_fused3(*args, D=D, nc_cap=nc_cap, bg=8,
                                         interpret=True))
        assert np.array_equal(hp.numpy(), he)
    # the kernel wrapper takes the plain loop for CPU tensors, uncounted
    n0 = tf3.run_batch_fused3.launches
    hw, sw = tf3.run_batch_fused3(*targs, D=D, nc_cap=nc_cap)
    assert tf3.run_batch_fused3.launches == n0
    assert torch.equal(hw, hp) and torch.equal(sw, st)
    return hv, st.numpy()


@pytest.mark.parametrize("trial", range(N_FUZZ))
def test_loop_plain_fuzz(trial):
    """The randomized sweep of tests/test_engine_fused3.py: odd D,
    nc_cap == n_cand, dead and full lanes, tiny R/S."""
    args, D, nc_cap = fuzz_args(trial)
    hv, st = _assert_port_matches_jax(args, D, nc_cap,
                                      jitted_entry=trial == 0)
    assert (hv[0] == args[2][0]).all()      # the dead lane is untouched
    assert st[0, 0] == 0 and st[1, 0] > 0


@pytest.mark.parametrize("n_cand", [520, 1030])
def test_loop_plain_wide_nc_cap(n_cand):
    """nc_cap 528 and 1040, above the 512 the CUDA engine once refused:
    loop_plain and the wrapper on CPU tensors equal the vmapped XLA
    engine."""
    args, D, nc_cap = wide_args(n_cand)
    assert nc_cap in (528, 1040) and args[4][1] > nc_cap
    hv = np.asarray(_run_batch_jit(*args, D=D, nc_cap=nc_cap))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    hp, st = tf3.loop_plain(*targs, D=D, nc_cap=nc_cap)
    assert np.array_equal(hp.numpy(), hv)
    assert (st.numpy()[1:, 3] > 0).all()          # every live lane committed
    hw, sw = tf3.run_batch_fused3(*targs, D=D, nc_cap=nc_cap)
    assert torch.equal(hw, hp) and torch.equal(sw, st)


def _datas_from(bam, truth):
    bamr = BamReader(bam)
    cfg = MmrConfig(cov_for_selection=5, cov_for_runtime=10)
    gs, ge = truth["gap"]
    rs = load_reads_given_interval(bamr, "chr1", gs, ge, READBACK, cfg)
    out = []
    for direction in (0, 1):
        ms = get_methmer_sites_and_ranges(rs, cfg, direction)
        store_mmr_of_reads(rs, ms)
        out.append(build_gap_device_data(
            rs, ms, direction, _round_up(rs.n, 128), _round_up(ms.n, 128)))
        wipe_mmr_of_reads(rs)
    return out


@pytest.fixture(scope="module")
def small_gap(tmp_path_factory):
    """tests/test_engine_fused3.py's one-gap window."""
    d = str(tmp_path_factory.mktemp("small_gap"))
    cfg_s = SynthConfig(seed=5, ref_len=160_000, read_len=18_000,
                        read_stagger=1100)
    bam, vcf, truth = make_two_block_scenario(d, cfg=cfg_s)
    return _datas_from(bam, truth)


def test_loop_plain_padded_lanes_small_ncand(small_gap):
    # 3 real lanes packed into G=8: 5 dead lanes, n_cand=3
    batch = pack_gap_batch(small_gap + small_gap[:1], [10] * 4, n_cand=3,
                           pad_g=8)
    args = batch_args(batch, 2 * batch.ids.shape[1] + 64)
    hv, st = _assert_port_matches_jax(args, batch.D, batch.nc_cap,
                                      jitted_entry=True)
    assert (hv[:4] <= 1).sum() > 0
    assert (hv[4:] == 2).all()
    assert (st[4:] == 0).all()


def test_loop_plain_zero_max_iters(small_gap):
    batch = pack_gap_batch(small_gap, [10] * 2, n_cand=14, pad_g=8)
    args = batch_args(batch, 0)
    hv, st = _assert_port_matches_jax(args, batch.D, batch.nc_cap,
                                      jitted_entry=True)
    assert np.array_equal(hv, batch.hp_init)
    assert (st == 0).all()


@pytest.mark.parametrize("trans,noise", [(False, 0.0), (True, 0.05)])
def test_loop_plain_scenarios(tmp_path, trans, noise):
    """tests/test_engine_fused.py's clean and noisy batches."""
    cfg_s = SynthConfig(noise=noise, nocall=noise, seed=11,
                        ref_len=200_000, read_len=20_000, read_stagger=900)
    bam, vcf, truth = make_two_block_scenario(str(tmp_path), trans=trans,
                                              cfg=cfg_s)
    datas = _datas_from(bam, truth)
    batch = pack_gap_batch(datas * 4, [10] * 8, n_cand=14, pad_g=8)
    args = batch_args(batch, 2 * batch.ids.shape[1] + 64)
    hv, _ = _assert_port_matches_jax(args, batch.D, batch.nc_cap,
                                     jitted_entry=True)
    assert (hv <= 1).sum() > 0


def _host_oracle_pick(spec, seeds):
    """First pick of core.engine_host on a crafted lane: the seeds into a
    CountTable, the valid range from site 0, one predict_tags_of_reads
    call over the candidates. Returns the candidates' tags (2 = untagged)."""
    table = CountTable(len(spec["sites"]) + 1)
    for site, mer, hap in seeds:
        table.insert([mer], 1, site, hap)
    ms = SimpleNamespace(mmr_min_i=0, mmr_max_i=0, n=len(spec["sites"]) + 1)
    update_available_methmer_range(table, ms, 1)
    reads = [SimpleNamespace(hp=2, mmr=[0] * len(run), mmr_n=len(run),
                             mmr_start_i=run[0]) for run in spec["cands"]]
    predict_tags_of_reads(SimpleNamespace(reads=reads), table, ms,
                          list(range(len(reads))), 1, 1, 3, 3)
    return [r.hp for r in reads]


# first picks on the NEAR_TIE_LANES: (JAX engines and port, host oracle)
_NEAR_TIE_PICKS = {"gate": ([0], [2]), "tie": ([2, 0], [0, 2])}


@pytest.mark.parametrize("name", sorted(NEAR_TIE_LANES))
def test_loop_plain_near_tie(name):
    """Picks that hinge on the f32 summation order: loop_plain equals both
    JAX engines; the host oracle, which adds the ratios one by one in f32,
    picks differently (ROADMAP.md queue 3, score summation)."""
    args, D, nc_cap, layout = near_tie_args()
    hv, _ = _assert_port_matches_jax(args, D, nc_cap)
    g, seeds, row = layout[name]
    spec = NEAR_TIE_LANES[name]
    engines, host = _NEAR_TIE_PICKS[name]
    assert hv[g, row:row + len(spec["cands"])].tolist() == engines
    assert _host_oracle_pick(spec, seeds) == host


@functools.lru_cache(maxsize=1)
def _crafted_run():
    args, D, nc_cap, layout = crafted_args()
    hv, st = _assert_port_matches_jax(args, D, nc_cap)
    return args, hv, st, layout


@pytest.mark.parametrize("name", sorted(CRAFTED_LANES))
def test_loop_plain_crafted(name):
    """The lanes that drive the loop kernel's candidate-set upkeep (a
    failure that empties the set, a failure past the prefetched row, a tie
    in reused slots): loop_plain equals both JAX engines on them, and each
    lane ends as its design says."""
    args, hv, st, layout = _crafted_run()
    g, rows = layout[name]
    assert (hv[g, rows["good"]] == 0).all()          # good rows commit to 0
    if name == "reuse_tie":                          # the tie, to the higher
        assert hv[g, rows["tie1"]].tolist() == [0]   # read, in 3 iterations
        assert hv[g, rows["tie0"]].tolist() == [2]
        assert st[g, 0] == 3 and st[g, 3] == 3
    else:                                            # the empty rows fail
        assert (hv[g, rows["empty"]] == 2).all()
        assert st[g, 1] >= len(rows["empty"]) and st[g, 3] == 10
    if name == "miss":                               # q_last passed the
        assert args[10][g] > 16                      # first 16 members and
        assert st[g, 1] >= 20                        # two more rows


def test_wrapper_table_out():
    """The wrapper's table write-back: at max_iters 0 the seed table
    (_seed_count_table_b), after the loop the table of the commits."""
    from pomfret_tpu_torch.kernels.engine_fused import _seed_count_table_b
    args, D, nc_cap = fuzz_args(1)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    G, R, S = t[0].shape
    seed = _seed_count_table_b(t[0], t[2], t[3], t[1], D)
    out = torch.full((G, 2 * D, S), -1.0)
    tf3.run_batch_fused3(*t[:11], torch.zeros_like(t[11]), D=D,
                         nc_cap=nc_cap, table_out=out)
    assert torch.equal(out, seed)
    hp, st = tf3.run_batch_fused3(*t, D=D, nc_cap=nc_cap, table_out=out)
    # each commit adds its row's valid mers to one haplotype's rows
    added = (out - seed).sum(dim=(1, 2))
    ids = t[0].long()
    won = (hp != t[2]) & (hp <= 1)
    want = (((ids >= 0) & (ids < D)).sum(dim=2) * won).sum(dim=1)
    assert torch.equal(added.long(), want) and int(st[:, 3].sum()) > 0
    with pytest.raises(ValueError, match="CUDA kernel only"):
        tf3.run_batch_fused3(*t, D=D, nc_cap=nc_cap,
                             phase_cycles=torch.zeros((G, 6), dtype=torch.int64))


def test_wrapper_rejects_other_devices():
    args, D, nc_cap = fuzz_args(0)
    targs = [torch.from_numpy(np.ascontiguousarray(a)).to("meta")
             for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tf3.run_batch_fused3(*targs, D=D, nc_cap=nc_cap)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """The CUDA library builds from source with nvcc or not at all."""
    from pomfret_tpu_torch.kernels import _build
    monkeypatch.setenv("NVCC", str(tmp_path / "missing"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    assert os.path.basename(_build.library_path()).startswith(
        "libpomfret_kernels_")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("trial", range(4))
def test_loop_plain_work_count(trial):
    """loop_plain's `work` tally (the loop kernel's bound in chip_smoke.py)
    leaves the loop's outputs as they are, stays inside the counts of a
    full range every iteration, and after one iteration is each lane's
    valid slots times the sites of its seeded range."""
    from pomfret_tpu_torch.kernels.engine_fused import (_range_from_seed_b,
                                                        _seed_count_table_b)
    args, D, nc_cap = fuzz_args(trial)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    ids, has_mmr, hp_init, seed_ok, n_reads, n_sites = t[:6]
    q_break, cov, min0, max0, n_cand = t[6], t[9], t[7], t[8], t[10]
    work = {}
    hp, st = tf3.loop_plain(*t, D=D, nc_cap=nc_cap, work=work)
    hp0, st0 = tf3.loop_plain(*t, D=D, nc_cap=nc_cap)
    assert torch.equal(hp, hp0) and torch.equal(st, st0)
    n_slots = n_cand.long().clamp(max=nc_cap)
    assert 0 < work["slot_sites"] <= int(
        (st[:, 0].long() * n_slots * n_sites.long()).sum())
    assert 0 < work["id_cells"] <= int((n_reads.long() * n_sites.long()).sum())
    assert 0 < work["mer_slot_sites"] <= work["slot_sites"]

    one = t[:11] + [torch.clamp(t[11], max=1)]
    work1 = {}
    hp1, st1 = tf3.loop_plain(*one, D=D, nc_cap=nc_cap, work=work1)
    cnt = _seed_count_table_b(ids, hp_init, seed_ok, has_mmr, D)
    lo, hi = _range_from_seed_b(cnt.sum(dim=1), cov, min0, max0, n_sites)
    span = (hi.clamp(max=ids.shape[2]).long() - lo.clamp(min=0).long()) \
        .clamp(min=0)
    rows = torch.arange(ids.shape[1])[None, :]
    elig = ((hp_init != 0) & (hp_init != 1) & (rows < n_reads[:, None])).sum(1)
    ran = (st1[:, 0] == 1).long()
    n_valid = torch.minimum(elig, n_slots) * ran
    won = (hp1 != hp_init).sum(dim=1)
    assert work1["slot_sites"] == int((n_valid * span).sum())
    assert work1["id_cells"] == int(
        ((n_valid - won) * span + won * torch.maximum(
            n_sites.long(), span)).sum())
