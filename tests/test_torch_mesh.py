"""The port's mesh (parallel/batch.py: make_gap_mesh, production_mesh, the
sharded dispatch) on the CPU, and on the card where there is one.

- A batch split over [cpu] * 8 (eight shards of consecutive lanes) gives
  the hp and stats of the unsplit batch under gens 1, 2 and 3, in the
  dense and the runs layouts, on seeded batches (testing.fuzz_args, and
  the same lanes in the runs layout); DISPATCH_STATS counts the devices.
- pack_group(lane_multiple=8) and (lane_multiple=3) pad the lanes as
  pomfret_tpu's pack_group does; a batch the device count does not divide
  raises.
- production_mesh honours POMFRET_NO_MESH and POMFRET_MESH_DEVICES, with
  torch.cuda.device_count patched.
- methphase with an 8-shard CPU mesh in place of production_mesh is
  byte-identical to the run without, with n_devices_last == 8 and
  lanes_last % 8 == 0 (tests/test_parallel.py's check); run_jobs_batched
  with a mesh gives the decisions and tag maps of the run without; two
  processes, each with a two-shard CPU mesh, write the one-process outputs.
- Card tests (marker `cuda`, skipped without a GPU): [cuda:0, cuda:0]
  splits each batch into two shards on one card, on streams of their own;
  hp and stats equal the unsplit batch's on testing.fuzz_args and the wide
  fixtures under gens 1, 2 and 3, each shard one kernel launch (gen 3).
The file imports no jax at the top, so the card (no jax there) runs its
`cuda` tests with `pytest --noconftest -m cuda`. Tolerance: exact.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from pomfret_tpu_torch.cli import main as port_main
from pomfret_tpu_torch.core.intervals import (Storage, merge_close_intervals,
                                              store_raw_intervals)
from pomfret_tpu_torch.core.methmer import get_methmer_sites_and_ranges
from pomfret_tpu_torch.core.readset import (READBACK, MmrConfig,
                                            load_reads_given_interval)
from pomfret_tpu_torch.io.bam import BamReader
from pomfret_tpu_torch.io.intervals_loader import (IS_VCF,
                                                   load_intervals_from_file)
from pomfret_tpu_torch.kernels import engine_fused3 as tf3
from pomfret_tpu_torch.kernels import engine_torch as et
from pomfret_tpu_torch.parallel import batch as tb
from pomfret_tpu_torch.testing import (N_FUZZ, N_FUZZ_CARD, args_batch,
                                       fuzz_args, make_multi_block_scenario,
                                       make_multichrom_multigap_scenario,
                                       make_two_block_scenario, run_processes,
                                       wide_args)

torch.set_num_threads(1)

CPU8 = tb.make_gap_mesh(["cpu"] * 8)


def _as_runs(batch):
    """The same lanes in the runs layout: S padded to a multiple of 128,
    each row's run from its first to its last 128-site block holding a
    mer."""
    G, R, S = batch.shape3
    B = -(-S // 128)
    ids = np.full((G, R, B * 128), -1, np.int32)
    ids[:, :, :S] = batch.ids
    present = (ids >= 0).reshape(G, R, B, 128).any(-1)
    has = present.any(-1)
    first = np.where(has, present.argmax(-1), -1)
    last = np.where(has, B - 1 - present[..., ::-1].argmax(-1), -1)
    C = max(1, int((last - first + 1).max()))
    blk = np.zeros((G, R, C * 128), np.uint8)
    for g, r in zip(*np.nonzero(has)):
        seg = ids[g, r, first[g, r] * 128:(first[g, r] + C) * 128]
        blk[g, r, :len(seg)] = seg + 1
    return dataclasses.replace(batch, ids=None, blk=blk,
                               b0=first.astype(np.int32), S=B * 128)


def _split_vs_whole(batch, max_iters, engine, device, mesh):
    whole = tb.run_gap_batch_async(batch, max_iters, engine=engine,
                                   device=device)
    split = tb.run_gap_batch_async(batch, max_iters, engine=engine,
                                   mesh=mesh)
    assert tb.DISPATCH_STATS["n_devices_last"] == len(mesh)
    assert tb.DISPATCH_STATS["lanes_last"] == batch.shape3[0]
    np.testing.assert_array_equal(np.asarray(split), np.asarray(whole))
    np.testing.assert_array_equal(split.stats(), whole.stats())
    return np.asarray(whole)


@pytest.mark.parametrize("layout", ["dense", "runs"])
@pytest.mark.parametrize("gen", ["1", "2", "3"])
def test_split_matches_whole_cpu(monkeypatch, gen, layout):
    monkeypatch.setenv("POMFRET_FUSED_GEN", gen)
    for trial in range(N_FUZZ):
        batch, max_iters = args_batch(*fuzz_args(trial))
        if layout == "runs":
            dense = _split_vs_whole(batch, max_iters, "torch", "cpu", CPU8)
            batch = _as_runs(batch)
        hp = _split_vs_whole(batch, max_iters, "torch", "cpu", CPU8)
        if layout == "runs":
            np.testing.assert_array_equal(hp, dense)


def test_undividable_batch_raises():
    batch, max_iters = args_batch(*fuzz_args(0))  # G = 8
    n0 = tb.DISPATCH_STATS["n_dispatches"]
    with pytest.raises(ValueError, match="does not split over 3 devices"):
        tb.run_gap_batch(batch, max_iters, engine="torch",
                         mesh=tb.make_gap_mesh(["cpu"] * 3))
    assert tb.DISPATCH_STATS["n_dispatches"] == n0
    with pytest.raises(ValueError):
        tb.make_gap_mesh([])


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    """The gap window of the two-block scenario, loaded."""
    d = str(tmp_path_factory.mktemp("window"))
    bam, vcf, truth = make_two_block_scenario(d)
    cfg = MmrConfig(cov_for_selection=5, cov_for_runtime=10)
    gs, ge = truth["gap"]
    rs = load_reads_given_interval(BamReader(bam), "chr1", gs, ge, READBACK,
                                   cfg)
    return (rs, get_methmer_sites_and_ranges(rs, cfg, 0),
            get_methmer_sites_and_ranges(rs, cfg, 1)), cfg


@pytest.mark.parametrize("lane_multiple", [8, 3])
def test_pack_group_lane_multiple(window, lane_multiple):
    """1, 16 and 17 gaps: 2, 32 and 34 lanes."""
    # imported here: the card runs this file's cuda tests without jax
    import pomfret_tpu.kernels.engine_jax as ej
    win, cfg = window
    for n in (1, 16, 17):
        loaded = [(i, *win) for i in range(n)]
        port = et.pack_group(loaded, cfg, 14, lane_multiple=lane_multiple)
        ref = ej.pack_group(loaded, cfg, 14, lane_multiple=lane_multiple)
        lanes = [b.shape3[0] for _, b in port[1]]
        assert lanes == [b.shape3[0] for _, b in ref[1]]
        assert lanes == {(8, 1): [32], (8, 16): [32], (8, 17): [64],
                         (3, 1): [96], (3, 16): [96],
                         (3, 17): [96]}[lane_multiple, n]


def test_production_mesh(monkeypatch):
    monkeypatch.delenv("POMFRET_NO_MESH", raising=False)
    monkeypatch.delenv("POMFRET_MESH_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    assert tb.production_mesh(cuda) == tuple(
        torch.device(f"cuda:{i}") for i in range(4))
    assert tb.production_mesh("cuda") == tb.production_mesh(cuda)
    for device in (None, "cpu", "cuda:1"):  # host engine, CPU, one card
        assert tb.production_mesh(device) is None
    monkeypatch.setenv("POMFRET_MESH_DEVICES", "2")
    assert tb.production_mesh(cuda) == (torch.device("cuda:0"),
                                        torch.device("cuda:1"))
    monkeypatch.setenv("POMFRET_MESH_DEVICES", "1")
    assert tb.production_mesh(cuda) is None
    monkeypatch.delenv("POMFRET_MESH_DEVICES")
    monkeypatch.setenv("POMFRET_NO_MESH", "1")
    assert tb.production_mesh(cuda) is None
    monkeypatch.delenv("POMFRET_NO_MESH")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tb.production_mesh(cuda) is None


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """tests/test_parallel.py's scenario for the pipeline under a mesh."""
    d = str(tmp_path_factory.mktemp("mesh"))
    bam, vcf, _ = make_multi_block_scenario(d, n_blocks=3)
    return d, ["-c", "50", "--engine", "torch", "--vcf", vcf, bam]


def _same_files(p1, p2, exts):
    for ext in exts:
        with open(p1 + ext, "rb") as f1, open(p2 + ext, "rb") as f2:
            a = f1.read()
            assert a == f2.read(), ext
            assert a, ext


def test_pipeline_on_a_cpu_mesh_matches_one_device(scenario, monkeypatch):
    d, args = scenario
    one = os.path.join(d, "one")
    assert port_main(["methphase", "-o", one, *args]) == 0
    assert tb.DISPATCH_STATS["n_devices_last"] == 1
    monkeypatch.setattr(tb, "production_mesh", lambda device: CPU8)
    mesh8 = os.path.join(d, "mesh8")
    assert port_main(["methphase", "-o", mesh8, *args]) == 0
    assert tb.DISPATCH_STATS["n_devices_last"] == 8
    assert tb.DISPATCH_STATS["lanes_last"] % 8 == 0
    _same_files(mesh8, one, (".mp.gtf", ".mp.vcf"))
    n0 = tb.DISPATCH_STATS["n_dispatches"]
    assert port_main(["warmup", "-o", os.path.join(d, "w"), *args]) == 0
    assert tb.DISPATCH_STATS["n_dispatches"] > n0
    assert tb.DISPATCH_STATS["n_devices_last"] == 8


def _jobs(vcf, cov):
    """methphase's job list for `-c cov` (tests/test_torch_pipeline.py)."""
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


def test_run_jobs_batched_mesh(tmp_path, monkeypatch):
    """run_jobs_batched(mesh=...) against mesh=None (production_mesh: one
    device on the CPU) on 2 chromosomes x 3 gaps; the group holds
    POMFRET_GAP_GROUP gaps a device."""
    monkeypatch.setenv("POMFRET_GAP_GROUP", "1")
    bam, vcf, _ = make_multichrom_multigap_scenario(
        str(tmp_path), n_chroms=2, n_blocks=4, read_stagger=1400)
    st, jobs = _jobs(vcf, 25)
    n0 = tb.DISPATCH_STATS["n_dispatches"]
    base = et.run_jobs_batched(st, BamReader(bam), jobs, engine="torch",
                               device="cpu")
    assert tb.DISPATCH_STATS["n_dispatches"] - n0 == 6  # a gap a group
    n0 = tb.DISPATCH_STATS["n_dispatches"]
    split = et.run_jobs_batched(st, BamReader(bam), jobs, engine="torch",
                                device="cpu",
                                mesh=tb.make_gap_mesh(["cpu"] * 4))
    assert tb.DISPATCH_STATS["n_dispatches"] - n0 == 2  # 3 gaps < 4
    assert tb.DISPATCH_STATS["n_devices_last"] == 4
    assert split == base
    assert [d for dec, _ in base for d in dec.values()].count(0) >= 4


def test_processes_and_mesh_compose(scenario):
    """Two processes, each splitting its gaps' batches over two CPU
    shards."""
    d, args = scenario
    one = os.path.join(d, "one_c")
    assert port_main(["methphase", "-o", one, *args]) == 0
    two = os.path.join(d, "two_mesh2")
    outs = run_processes(["methphase", "-o", two, *args], 2,
                         env={"OMP_NUM_THREADS": "1"}, mesh=["cpu", "cpu"])
    for o in outs:
        assert o["rc"] == 0 and o["loaded"] == []
        assert o["n_devices_last"] == 2 and o["lanes_last"] % 2 == 0
    _same_files(two, one, (".mp.gtf", ".mp.vcf"))


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_FIXTURES = [("fuzz", t) for t in range(N_FUZZ_CARD)] + [
    ("wide", 528), ("wide", 1040)]


@pytest.mark.cuda
@pytest.mark.parametrize("gen", ["1", "2", "3"])
@pytest.mark.parametrize("kind,arg", CARD_FIXTURES)
def test_two_shards_on_one_card(cuda, monkeypatch, gen, kind, arg):
    monkeypatch.setenv("POMFRET_FUSED_GEN", gen)
    batch, max_iters = args_batch(*(fuzz_args(arg) if kind == "fuzz"
                                    else wide_args(arg)))
    n0 = tf3.run_batch_fused3.launches
    _split_vs_whole(batch, max_iters, "cuda", cuda,
                    tb.make_gap_mesh(["cuda:0", "cuda:0"]))
    if gen == "3":
        assert tf3.run_batch_fused3.launches - n0 == 3  # whole, 2 shards
