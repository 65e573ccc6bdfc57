"""The fixtures and the three-way check shared by tests/test_torch_run_gap*.py:
the port's run_gap(engine="torch") on the CPU against the JAX package's
run_gap_jax and its host oracle, on the fixtures of the JAX tests that call
run_gap_jax, with the data made by the port's own scenario makers
(pomfret_tpu_torch.testing); each package loads the window with its own
readers. Decisions and every read's tag must be equal (exact).
"""
import os

from pomfret_tpu.core import engine_host as tpu_host
from pomfret_tpu.core.methmer import get_methmer_sites_and_ranges as tpu_sites
from pomfret_tpu.core.readset import (MmrConfig as TpuMmrConfig,
                                      load_reads_given_interval as tpu_load)
from pomfret_tpu.io.bam import BamReader as TpuBamReader
from pomfret_tpu.kernels import engine_jax as ej
from pomfret_tpu_torch.core import engine_host as port_host
from pomfret_tpu_torch.core.methmer import get_methmer_sites_and_ranges
from pomfret_tpu_torch.core.readset import (READBACK, MmrConfig,
                                            load_reads_given_interval)
from pomfret_tpu_torch.io.bam import BamReader
from pomfret_tpu_torch.kernels import engine_torch as et
from pomfret_tpu_torch.parallel import batch as tb
from pomfret_tpu_torch import testing as T
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

N_CAND, COV = 14, 10


def _two_block_fixture(d, hp_label_fn=None, frac_clipped=0.0,
                       frac_indel=0.0, cfg=None):
    """The two-block region of test_review_regressions.py and
    test_realistic_reads.py, built read by read."""
    sr = T.SynthRegion(cfg)
    b1, b2 = (5_000, 80_000), (120_000, 195_000)
    snp = []
    for lo, hi in (b1, b2):
        p = lo
        while p < hi:
            for q in range(p, min(p + 200, cfg.ref_len)):
                if sr.ref[q] == "A":
                    snp.append(q)
                    break
            p += 2_000
    sr.add_snps(snp, [i % 2 for i in range(len(snp))])
    kw = dict(hp_label_fn=hp_label_fn) if hp_label_fn else dict(
        frac_clipped=frac_clipped, frac_indel=frac_indel)
    recs = sr.make_reads(tagged=True, **kw)
    bam = os.path.join(d, "fixture.bam")
    sr.write_bam(bam, recs)
    b1v = [p for p in snp if b1[0] <= p < b1[1]]
    b2v = [p for p in snp if b2[0] <= p < b2[1]]
    return bam, (b1v[-1] + 1, b2v[0] + 1)


def _weird_hp(start, hap):
    return 5 if (start // 700) % 7 == 0 else hap + 1


# name -> (maker, MmrConfig keywords)
CASES = {
    **{f"engine_jax-{trans}-{seed}-{noise}": (
        lambda d, trans=trans, seed=seed, noise=noise:
        _scenario(d, trans, T.SynthConfig(
            noise=noise, nocall=noise, seed=seed, ref_len=200_000,
            read_len=20_000, read_stagger=900)), {})
       for trans, seed, noise in ((False, 0, 0.0), (True, 1, 0.0),
                                  (False, 3, 0.03), (True, 7, 0.05))},
    **{f"params-{k}-{k_span}-{lo}-{hi}": (
        lambda d, k=k: _scenario(d, False, T.SynthConfig(
            noise=0.04, nocall=0.04, seed=k)),
        dict(k=k, k_span=k_span, lo=lo, hi=hi))
       for k, k_span, lo, hi in ((1, 5000, 100, 156), (7, 2000, 100, 156),
                                 (3, 500, 128, 129))},
    "weird_hp": (lambda d: _two_block_fixture(
        d, hp_label_fn=_weird_hp, cfg=T.SynthConfig(seed=13)), {}),
    "messy_reads": (lambda d: _two_block_fixture(
        d, frac_clipped=0.4, frac_indel=0.5,
        cfg=T.SynthConfig(noise=0.03, nocall=0.03, seed=5)), {}),
}
JAX_CASES = [c for c in CASES if c.startswith("engine_jax")]
PARAM_CASES = [c for c in CASES if c.startswith("params")]


def _scenario(d, trans, cfg):
    bam, _, truth = T.make_two_block_scenario(d, trans=trans, cfg=cfg)
    return bam, truth["gap"]


_DATA = {}


def case_data(tmp_path_factory, case):
    """(bam, gap, MmrConfig keywords) of a case, made once per process
    under pytest's session temporary directory."""
    if case not in _DATA:
        maker, kw = CASES[case]
        bam, gap = maker(str(tmp_path_factory.mktemp(case)))
        _DATA[case] = (bam, gap, dict(cov_for_selection=5,
                                      cov_for_runtime=COV, **kw))
    return _DATA[case]


def vote_fixture(d, trans, noise):
    """The two-block scenario of tests/test_permutation.py::
    test_permutation_voting_device_matches_host."""
    bam, _, truth = T.make_two_block_scenario(
        d, trans=trans, cfg=T.SynthConfig(noise=noise, nocall=noise, seed=13))
    return bam, truth["gap"], dict(cov_for_selection=5, cov_for_runtime=10)


def load_tpu(bam, gap, kw):
    cfg = TpuMmrConfig(**kw)
    rs = tpu_load(TpuBamReader(bam), "chr1", gap[0], gap[1], READBACK, cfg)
    return rs, tpu_sites(rs, cfg, 0), tpu_sites(rs, cfg, 1)


def load_port(bam, gap, kw):
    cfg = MmrConfig(**kw)
    rs = load_reads_given_interval(BamReader(bam), "chr1", gap[0], gap[1],
                                   READBACK, cfg)
    return (rs, get_methmer_sites_and_ranges(rs, cfg, 0),
            get_methmer_sites_and_ranges(rs, cfg, 1))


def three_ways(bam, gap, kw, n_perm, key):
    """(decision, tags) of the JAX package's host oracle, run_gap_jax and
    the port's run_gap(engine="torch"). key: the per-gap srand48 seed of
    the permutation stream, or None for each package's global stream
    (reset first)."""
    out = []
    for run in ("host", "jax", "port"):
        if run == "port":
            port_host.reset_drand48()
            rng = (port_host.Drand48.from_srand48(key)
                   if key is not None else None)
            rs, f, b = load_port(bam, gap, kw)
            n0 = tb.DISPATCH_STATS["n_dispatches"]
            dec = et.run_gap(rs, f, b, N_CAND, COV, n_perm, rng,
                             engine="torch", device="cpu")
            # both directions ran, one batch each
            assert tb.DISPATCH_STATS["n_dispatches"] - n0 in (0, 2)
        else:
            tpu_host.reset_drand48()
            rng = (tpu_host.Drand48.from_srand48(key)
                   if key is not None else None)
            rs, f, b = load_tpu(bam, gap, kw)
            fn = tpu_host.haplotag_region if run == "host" else ej.run_gap_jax
            dec = fn(rs, f, b, N_CAND, COV, n_perm, rng)
        out.append((dec, [r.hp for r in rs.reads]))
    return out


def check_three_ways(bam, gap, kw, n_perm, key):
    (dh, th), (dj, tj), (dp, tp) = three_ways(bam, gap, kw, n_perm, key)
    assert dh == dj == dp
    assert th == tj == tp
    return dp
