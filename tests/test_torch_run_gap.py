"""The port's single-gap engine (kernels.engine_torch.run_gap, engine
"torch" on the CPU) vs the JAX package's run_gap_jax and its host oracle.

The fixtures (tests/torch_run_gap_cases.py) are those of the JAX tests that
call run_gap_jax:
- tests/test_engine_jax.py::test_device_matches_host (4 cases);
- tests/test_engine_params.py::test_params_device_matches_host (3 cases,
  in test_torch_run_gap_params.py);
- tests/test_review_regressions.py::test_weird_hp_tag_device_matches_host;
- tests/test_realistic_reads.py::test_messy_reads_decode_and_join.
Here too: the iteration cap, the buffer sizes, one batch per direction and
pipeline.haplotag_region_given_bam's engines. Permutation voting is in
test_torch_run_gap_perm.py, _vote.py and _pipeline.py (split for the test
workers). Decisions and every read's tag must be equal (exact).
"""
import numpy as np
import pytest
import torch

from pomfret_tpu.core.methmer import store_mmr_of_reads as tpu_store
from pomfret_tpu.kernels import engine_jax as ej
from pomfret_tpu_torch.core import engine_host as port_host
from pomfret_tpu_torch.core.methmer import store_mmr_of_reads
from pomfret_tpu_torch.core.readset import READBACK, MmrConfig
from pomfret_tpu_torch.io.bam import BamReader
from pomfret_tpu_torch.kernels import engine_fused3 as tf3
from pomfret_tpu_torch.kernels import engine_torch as et
from pomfret_tpu_torch.parallel import batch as tb
from pomfret_tpu_torch import testing as T
from torch_run_gap_cases import (CASES, COV, JAX_CASES, N_CAND, PARAM_CASES,
                                 case_data, check_three_ways, load_port,
                                 load_tpu)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", [c for c in CASES if c not in PARAM_CASES])
def test_run_gap_matches_jax_and_host(tmp_path_factory, case):
    assert check_three_ways(*case_data(tmp_path_factory, case), 1,
                            None) >= 0


def _direction_inputs(tmp_path_factory, direction=0):
    """One direction of the first case, packed by each package: the port's
    batch (one lane) and run_direction_device's arguments."""
    bam, gap, kw = case_data(tmp_path_factory, JAX_CASES[0])
    rs_p, f_p, b_p = load_port(bam, gap, kw)
    ms_p = f_p if direction == 0 else b_p
    store_mmr_of_reads(rs_p, ms_p)
    pad_r = et._round_up(max(rs_p.n, 8), 128)
    pad_s = et._round_up(max(ms_p.n, 8), 128)
    dd_p = et.build_gap_device_data(rs_p, ms_p, direction, pad_r, pad_s)
    rs_t, f_t, b_t = load_tpu(bam, gap, kw)
    ms_t = f_t if direction == 0 else b_t
    tpu_store(rs_t, ms_t)
    dd_t = ej.build_gap_device_data(rs_t, ms_t, direction, pad_r, pad_s)
    return dd_p, dd_t, pad_r


def _jax_direction(dd, max_iters):
    import jax.numpy as jnp
    return np.asarray(ej.run_direction_device(
        jnp.asarray(np.asarray(dd.ids, dtype=np.int32)),
        jnp.asarray(dd.has_mmr), jnp.asarray(dd.hp_init),
        jnp.asarray(dd.seed_ok), jnp.int32(dd.n_reads),
        jnp.int32(dd.n_sites), jnp.int32(dd.q_break), jnp.int32(dd.min0),
        jnp.int32(dd.max0), jnp.int32(COV), jnp.int32(N_CAND),
        jnp.int32(max_iters), D=et._round_up(dd.max_d, 16),
        nc_cap=et._round_up(N_CAND, 16)))


@pytest.mark.parametrize("cap", [1, 4, 9])
def test_iteration_cap_binds_identically(tmp_path_factory, cap):
    """With a cap below the loop's own end, the port's batch and JAX's
    run_direction_device stop at the same iteration with the same tags."""
    dd_p, dd_t, pad_r = _direction_inputs(tmp_path_factory)
    batch = tb.pack_gap_batch([dd_p], [COV], N_CAND)
    hp_capped = tb.run_gap_batch(batch, max_iters=cap, engine="torch",
                                 device="cpu")[0]
    hp_full = tb.run_gap_batch(batch, max_iters=2 * pad_r + 64,
                               engine="torch", device="cpu")[0]
    _, stats = tf3.loop_plain(*[torch.from_numpy(np.ascontiguousarray(a))
                                for a in tb.batch_args(batch, cap)],
                              D=batch.D, nc_cap=batch.nc_cap)
    assert int(stats[0, 0]) == cap            # the cap ended the loop
    assert not np.array_equal(hp_capped, hp_full)
    assert np.array_equal(hp_capped, _jax_direction(dd_t, cap))
    assert np.array_equal(hp_full, _jax_direction(dd_t, 2 * pad_r + 64))


def test_run_gap_cap_and_one_batch_per_direction(tmp_path_factory,
                                                 monkeypatch):
    """run_gap passes run_gap_jax's cap, 2 * pad_r + 64, and runs each
    direction's seeds as the lanes of one batch."""
    calls = []
    orig = tb.run_gap_batch

    def spy(batch, max_iters=None, **kw):
        calls.append((batch.shape3, max_iters, int((batch.n_reads > 0)
                                                   .sum())))
        return orig(batch, max_iters, **kw)

    monkeypatch.setattr(tb, "run_gap_batch", spy)
    bam, gap, kw = case_data(tmp_path_factory, JAX_CASES[0])
    rs, f, b = load_port(bam, gap, kw)
    et.run_gap(rs, f, b, N_CAND, COV, 3,
               port_host.Drand48.from_srand48(11), engine="torch")
    assert len(calls) == 2
    for (G, R, _), max_iters, lanes in calls:
        assert R == et._round_up(max(rs.n, 8), 128)
        assert max_iters == 2 * R + 64
        assert lanes == 3 and G == 32


def test_buffer_sizes_do_not_change_tags(tmp_path_factory):
    """D (run_gap_jax rounds max_d to 16, pack_gap_batch to a power of two)
    and nc_cap only size buffers: the loop's tags are the same."""
    dd_p, _, pad_r = _direction_inputs(tmp_path_factory, direction=1)
    batch = tb.pack_gap_batch([dd_p], [COV], N_CAND)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in tb.batch_args(batch, 2 * pad_r + 64)]
    out = {(D, nc): tf3.loop_plain(*t, D=D, nc_cap=nc)[0]
           for D, nc in ((batch.D, batch.nc_cap),
                         (et._round_up(dd_p.max_d, 16), batch.nc_cap),
                         (64, 48))}
    ref = out[(batch.D, batch.nc_cap)]
    assert (ref[0] <= 1).any()
    for k, hp in out.items():
        assert torch.equal(hp, ref), k


def test_haplotag_region_given_bam_engines(tmp_path):
    """pipeline.haplotag_region_given_bam takes engine host|torch (the JAX
    package's host|jax): every gap of the trans-alternating scenario is
    trans, with the same tags either way."""
    from pomfret_tpu_torch.core.intervals import (Storage,
                                                  merge_close_intervals,
                                                  store_raw_intervals)
    from pomfret_tpu_torch.io.intervals_loader import (
        IS_VCF, load_intervals_from_file)
    from pomfret_tpu_torch.pipeline import (_derive_chrom_params,
                                            estimate_read_coverage_cached,
                                            haplotag_region_given_bam)

    bam_path, vcf, truths = T.make_multichrom_multigap_scenario(
        str(tmp_path), n_chroms=1, n_blocks=3, trans_alternate=True)
    assert truths[0]["expected_decisions"] == [1, 1]
    bam = BamReader(bam_path)
    st = Storage()
    load_intervals_from_file(vcf, IS_VCF, st)
    for rg in st.ranges:
        store_raw_intervals(rg)
        merge_close_intervals(rg, READBACK)
    cov = estimate_read_coverage_cached(bam_path, 2)
    rg, ref = st.ranges[0], st.ref_names[0]
    cfg, n_cand = _derive_chrom_params(MmrConfig(), 14, cov.get(ref, 0), ref)
    for i in range(len(rg.starts)):
        got = {}
        for engine in ("host", "torch"):
            dec, rs = haplotag_region_given_bam(
                st, bam, ref, rg.starts[i], rg.ends[i], cfg, n_cand,
                engine=engine, device="cpu" if engine == "torch" else None)
            got[engine] = (dec, [r.hp for r in rs.reads])
        assert got["host"] == got["torch"]
        assert got["torch"][0] == 1, i
    with pytest.raises(ValueError):
        haplotag_region_given_bam(st, bam, ref, rg.starts[0], rg.ends[0],
                                  cfg, n_cand, engine="jax")
