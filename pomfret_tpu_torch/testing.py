"""Packed batches, and a step checker, for holding the kernels against
their plain versions.

Used by the tests and by chip_smoke.py; the synthetic read data comes from
pomfret_tpu.testing.
"""
from __future__ import annotations

import tempfile

import numpy as np


N_FUZZ = 8        # trials of the sweep that tests/test_engine_fused3.py runs
N_FUZZ_CARD = 10  # plus the two shapes below, run on the card only


def fuzz_args(trial: int):
    """One trial of a randomized loop batch. Trials 0-7 are the sweep of
    tests/test_engine_fused3.py: 8 lanes with a dead lane (n_reads = 0)
    and a full one, odd D, tiny R/S, and every fourth trial with
    nc_cap == n_cand. Trial 8 has the shape of the dense windows of
    bench.py's BENCH_SCALE=5 set (R=1792, D=8, NC=64); trial 9 a
    dictionary wider than int8 (D=256, int32 ids). Returns (numpy args in
    the engines' order, D, nc_cap)."""
    rng = np.random.default_rng(1000 + trial)
    G = 8
    if trial == 8:
        R, S, D, n_cand = 1792, 1536, 8, 50
    elif trial == 9:
        R, S, D, n_cand = 96, 128, 256, 12
    else:
        R = int(rng.integers(2, 7)) * 16
        S = int(rng.integers(1, 5)) * 32
        D = int(rng.choice([4, 8, 16]))
        n_cand = 16 if trial % 4 == 3 else int(rng.integers(2, 17))
    nc_cap = ((n_cand + 15) // 16) * 16
    ids = rng.integers(-1, D, size=(G, R, S)).astype(
        np.int8 if D <= 127 else np.int32)
    has_mmr = rng.random((G, R)) < 0.9
    ids[~has_mmr] = -1
    hp_init = np.full((G, R), 2, np.int32)
    n_seed = int(rng.integers(4, 12))
    hp_init[:, :n_seed] = rng.integers(0, 2, size=(G, n_seed))
    seed_ok = hp_init <= 1
    n_reads = rng.integers(0, R + 1, size=G).astype(np.int32)
    n_reads[0] = 0                       # dead lane
    n_reads[1] = R                       # full lane
    n_sites = rng.integers(1, S + 1, size=G).astype(np.int32)
    q_break = n_reads.copy()
    min0 = np.minimum(rng.integers(0, 4, size=G), n_sites - 1).astype(np.int32)
    max0 = np.minimum(min0 + rng.integers(0, 8, size=G),
                      n_sites - 1).astype(np.int32)
    cov = rng.integers(1, 6, size=G).astype(np.int32)
    args = (ids, has_mmr, hp_init, seed_ok, n_reads, n_sites, q_break,
            min0, max0, cov, np.full(G, n_cand, np.int32),
            np.full(G, 2 * R + 16, np.int32))
    return args, D, nc_cap


# Crafted lanes whose first pick hinges on how the f32 ratios cnt/sum are
# summed. Each site is (c, s, h): c hap-0 seed reads carry mer id 0 there,
# s - c carry id 1, h hap-1 seed reads carry id 2; every candidate carries
# id 0 on its run of sites.
#  - "gate": ratios 3/6, 5/6, 5/6, 5/6 sum to 3.0 exactly, but to
#    2.9999998 added one by one in f32; score1 is 0 with l1 = 0, so the
#    `diff < 3.0 and l < 3` gate decides whether the read is tagged.
#  - "tie": two candidates hold the same ratios 8/9, 4/9, 3/6 in opposite
#    site order: equal exact sums (a tie, to the higher read), but
#    1.8333334 and 1.8333333 added one by one in f32.
NEAR_TIE_LANES = {
    "gate": dict(sites=[(3, 6, 0), (5, 6, 0), (5, 6, 0), (5, 6, 0)],
                 cands=[[0, 1, 2, 3]]),
    "tie": dict(sites=[(8, 9, 1), (4, 9, 1), (3, 6, 1), (3, 6, 1),
                       (4, 9, 1), (8, 9, 1)],
                cands=[[0, 1, 2], [3, 4, 5]]),
}


def near_tie_args(G: int = 8, R: int = 64, S: int = 32):
    """The NEAR_TIE_LANES as one batch of G lanes (the rest dead), D = 4,
    max_iters = 1, so hp holds each lane's first pick. Each lane's seeds
    are one-site reads (site, id, hap) in rows [0, n_seed), then its
    candidates; one more site with an id-3 seed closes the valid range
    (cov = 1). Returns (numpy args in the engines' order, D, nc_cap,
    {name: (lane, seeds, first candidate row)})."""
    ids = np.full((G, R, S), -1, np.int8)
    hp_init = np.full((G, R), 2, np.int32)
    n_reads = np.zeros(G, np.int32)
    n_sites = np.ones(G, np.int32)
    layout = {}
    for g, (name, spec) in enumerate(NEAR_TIE_LANES.items()):
        k = len(spec["sites"])
        seeds = []
        for i, (c, s, h) in enumerate(spec["sites"]):
            seeds += [(i, 0, 0)] * c + [(i, 1, 0)] * (s - c) + [(i, 2, 1)] * h
        seeds.append((k, 3, 0))
        for r, (i, d, hap) in enumerate(seeds):
            ids[g, r, i] = d
            hp_init[g, r] = hap
        for j, run in enumerate(spec["cands"]):
            ids[g, len(seeds) + j, run] = 0
        n_reads[g] = len(seeds) + len(spec["cands"])
        n_sites[g] = k + 1
        layout[name] = (g, seeds, len(seeds))
    z = np.zeros(G, np.int32)
    args = (ids, ids.max(axis=2) >= 0, hp_init, hp_init <= 1, n_reads,
            n_sites, n_reads.copy(), z, z, np.ones(G, np.int32),
            np.full(G, 14, np.int32), np.ones(G, np.int32))
    return args, 4, 16, layout


def checked_step(kernel, plain, in_place=()):
    """A loop step that runs `kernel` and then `plain` on the same inputs
    and raises unless every output is equal (exact). `in_place` holds the
    positions of the arguments both update in place: `plain` gets copies
    of them taken before the kernel runs. The step returns the kernel's
    outputs and keeps .calls, .max_abs_err and .first (the first call's
    arguments, copied)."""
    import torch

    def step(*args, **kw):
        copies = [a.clone() if i in in_place else a
                  for i, a in enumerate(args)]
        if step.first is None:
            step.first = ([a.clone() for a in args], kw)
        got = kernel(*args, **kw)
        want = plain(*copies, **kw)
        pairs = zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,))))
        for i, (k, p) in enumerate(pairs):
            err = float((k.double() - p.double()).abs().max()) \
                if k.numel() else 0.0
            step.max_abs_err = max(step.max_abs_err, err)
            if not torch.equal(k, p):
                raise RuntimeError(
                    f"{kernel.__name__} != {plain.__name__} at call "
                    f"{step.calls}, output {i}: max |diff| {err}")
        step.calls += 1
        return got

    step.calls, step.max_abs_err, step.first = 0, 0.0, None
    return step


def bench_gap_batch(G: int = 256, n_cand: int = 14):
    """The bench-shape batch (bench.py build_real_gap_batch): the gap window
    of make_two_block_scenario, both directions, repeated over G lanes
    (D = 4, R and S rounded up to 128). Returns (GapBatch, window reads)."""
    from pomfret_tpu.core.methmer import (get_methmer_sites_and_ranges,
                                          store_mmr_of_reads,
                                          wipe_mmr_of_reads)
    from pomfret_tpu.core.readset import (READBACK, MmrConfig,
                                          load_reads_given_interval)
    from pomfret_tpu.io.bam import BamReader
    from pomfret_tpu.testing import make_two_block_scenario
    from .kernels.engine_torch import _round_up, build_gap_device_data
    from .parallel.batch import pack_gap_batch

    with tempfile.TemporaryDirectory() as d:
        bam, vcf, truth = make_two_block_scenario(d)
        cfg = MmrConfig(cov_for_selection=5, cov_for_runtime=10)
        gs, ge = truth["gap"]
        rs = load_reads_given_interval(BamReader(bam), "chr1", gs, ge,
                                       READBACK, cfg)
        lanes = []
        for direction in (0, 1):
            ms = get_methmer_sites_and_ranges(rs, cfg, direction)
            store_mmr_of_reads(rs, ms)
            lanes.append(build_gap_device_data(
                rs, ms, direction, _round_up(rs.n, 128),
                _round_up(ms.n, 128)))
            wipe_mmr_of_reads(rs)
    return pack_gap_batch(lanes * (G // 2), [10] * G, n_cand=n_cand,
                          pad_g=G), rs.n
