"""The port's profile tools (python -m pomfret_tpu_torch.tools.
profile_loader and profile_pack) against the JAX package's modules, on the
CPU, on the dense chromosome cut to 3 blocks (2 gaps of ~1.6k reads):
- profile_loader's windows, reads and reads by chromosome equal those of
  the calls tools/profile_loader.py makes through pomfret_tpu (its
  ChromReadSource over the whole chromosome, each window, both site
  selections);
- profile_pack's groups, at 1 and at 128 windows a group, hold the
  windows tools/profile_pack.py groups, and each group's packed lanes and
  batches equal pomfret_tpu.kernels.engine_jax.pack_group's on those
  windows;
- both JSON records carry the peak RSS (VmHWM here) and VmRSS after
  every stage of every chromosome.
Tolerance: exact.
"""
import json
import os

import pytest
import torch

from pomfret_tpu_torch.tools import profile_loader, profile_pack
from test_torch_pack import _assert_same_group
from torch_accuracy_cases import small_dense
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile")
    small_dense(root)
    return root


def _args(root, *extra):
    return ["--dense", "0.05", "--blocks", "3", "--data-root", str(root),
            *extra]


def _jax_windows(bam_path):
    """[(ref_name, cfg, n_cand, [(i, rs, ms_fwd, ms_bwd)])] as the JAX
    tools load them."""
    from pomfret_tpu.core.intervals import (merge_close_intervals,
                                            store_raw_intervals)
    from pomfret_tpu.core.methmer import get_methmer_sites_and_ranges
    from pomfret_tpu.core.readset import READBACK, ChromReadSource, MmrConfig
    from pomfret_tpu.io.bam import BamReader
    from pomfret_tpu.io.intervals_loader import IS_VCF, load_intervals_from_file
    from pomfret_tpu.pipeline import (Storage, _derive_chrom_params,
                                      estimate_read_coverage_cached)
    bam = BamReader(bam_path)
    st = Storage()
    load_intervals_from_file(bam_path.replace("dense_noise.bam",
                                              "multichrom.vcf.gz"), IS_VCF, st)
    name2cov = estimate_read_coverage_cached(bam_path, 2)
    out = []
    for job_i, rg in enumerate(st.ranges):
        store_raw_intervals(rg)
        merge_close_intervals(rg, READBACK)
        ref_name = st.ref_names[job_i]
        cfg, n_cand = _derive_chrom_params(
            MmrConfig(), 14, name2cov.get(ref_name, 0), ref_name)
        src = ChromReadSource(bam, ref_name, cfg)
        assert src.ok
        wins = []
        for i in range(len(rg.starts)):
            rs = src.window(rg.starts[i], rg.ends[i], READBACK, None)
            wins.append((i, rs, get_methmer_sites_and_ranges(rs, cfg, 0),
                         get_methmer_sites_and_ranges(rs, cfg, 1)))
        out.append((ref_name, cfg, n_cand, wins))
    return out


def _memory_complete(rec, stages):
    chroms = set(rec["reads_by_chrom"]) if "reads_by_chrom" in rec else {
        m["chrom"] for m in rec["memory"]}
    got = {(m["chrom"], m["stage"]) for m in rec["memory"]
           if m["peak_rss_mib"] > 0 and m["vm_rss_mib"] > 0}
    assert got == {(c, s) for c in chroms for s in stages}
    assert rec["peak_rss_mib"] >= max(m["peak_rss_mib"]
                                      for m in rec["memory"])
    assert rec["host"]["peak_rss_from"] == "VmHWM"


def test_loader_counts_the_jax_tools_windows(root, tmp_path):
    out = tmp_path / "loader.json"
    assert profile_loader.main(_args(root, "--out", str(out))) == 0
    with open(out) as f:
        rec = json.load(f)
    ref = _jax_windows(rec["set"]["bam"])
    assert rec["windows"] == sum(len(w) for *_, w in ref) == 2
    assert rec["reads_by_chrom"] == {
        name: sum(rs.n for _, rs, _, _ in w) for name, _, _, w in ref}
    assert rec["reads"] == sum(rec["reads_by_chrom"].values()) > 3000
    assert set(rec["stages_s"]) == {"src_init", "window", "methmer"}
    assert (rec["host"]["cores"], rec["host"]["card"]) == (os.cpu_count(),
                                                           None)
    _memory_complete(rec, ("src_init", "window", "methmer"))


@pytest.mark.parametrize("group", [1, 128])
def test_pack_packs_as_the_jax_package(root, group):
    from pomfret_tpu.kernels.engine_jax import pack_group as jax_pack
    a = profile_loader.argparse.Namespace(
        dense=0.05, scale=1, blocks=3, data_root=str(root))
    desc, bam, jobs = profile_loader.load_set(a)
    groups, _ = profile_pack.load_groups(bam, jobs, group)
    ref = []
    for name, cfg, n_cand, wins in _jax_windows(desc["bam"]):
        kept = [w for w in wins if w[1].n and w[2].n and w[3].n]
        ref += [(kept[k:k + group], cfg, n_cand)
                for k in range(0, len(kept), group)]
    assert [[i for i, *_ in g[0]] for g in groups] == [
        [i for i, *_ in g[0]] for g in ref]
    assert len(groups) == (2 if group == 1 else 1)
    checked = []

    def check(k, got):  # before the next group refills the native arena
        _assert_same_group(got, jax_pack(*ref[k]))
        checked.append(len(got[1]))
    _, shapes = profile_pack.pack_groups(groups, profile_loader.Marks(),
                                         check)
    assert len(checked) == len(groups)
    assert sum(shapes.values()) == sum(checked)


def test_pack_record(root, tmp_path):
    out = tmp_path / "pack.json"
    assert profile_pack.main(_args(root, "--group", "1", "--out",
                                   str(out))) == 0
    with open(out) as f:
        rec = json.load(f)
    assert (rec["groups"], rec["lanes"], len(rec["group_s"])) == (2, 2, 2)
    assert rec["reads"] > 3000 and rec["wall_s"] > 0
    assert [(s["R"], s["S"], s["D"], s["nc_cap"], s["batches"])
            for s in rec["packed_shapes"]] == [(1792, 1536, 32, 64, 2)]
    _memory_complete(rec, ("src_init", "window", "methmer", "load", "pack"))
