"""The parallel dataset maker (testing.make_datasets, and its pool
testing._make_scenarios at a given number of workers) against the serial
maker and the JAX package's, on the CPU.

- The set: chromosomes 2-4 of testing.scale_params (read stagger 1000,
  1400 and 2000; noise and nocall 0.02 and 0.03 on two of them) at 4
  blocks, all-cis and trans_alternate.
- With 2 and 3 workers, and through make_datasets (a worker a core) on
  the cis and the trans set at once: the BAM and its BAI equal the serial
  maker's and
  pomfret_tpu.testing's byte for byte; the VCF too, but for gzip's MTIME
  field (header bytes 4-7, the clock when it was written); the truths'
  blocks, PS ids, gaps and expected decisions are equal; make_datasets
  records the making process's own peak beside the workers'.
- A worker that raises makes the parent raise with its traceback, at
  once: the other workers are stopped and the parts removed.
- The .bench_data/<key>/ keys of the record's sets are unchanged.
Tolerance: exact.
"""
import multiprocessing
import os
import time

import pytest

import pomfret_tpu.testing as jax_testing
from pomfret_tpu_torch import testing
from pomfret_tpu_torch.io.bam import BamReader

PER_CHROM = testing.scale_params(1)["per_chrom"][1:]
PARAMS = dict(n_blocks=4, block_len=60_000, gap_len=30_000,
              per_chrom=PER_CHROM)
TRUTH_KEYS = ("blocks", "ps_ids", "gaps", "expected_decisions")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{trans: {"jax": ..., "serial": ...}}, each (bam, vcf, truths): the
    JAX package's and the port's serial makers, each set in a spawned
    process, all four at once."""
    root = tmp_path_factory.mktemp("reference")
    running = {}
    for name, mod in (("jax", jax_testing), ("serial", testing)):
        for trans in (False, True):
            d = str(root / f"{name}_{trans}")
            os.makedirs(d)
            running[name, trans] = testing.Spawned(
                mod.make_multichrom_multigap_scenario, d, 2, 4, 60_000,
                30_000, 700, PER_CHROM, 2, "multichrom.bam", trans)
    try:
        return {trans: {name: running[name, trans].result(timeout=300)
                        for name in ("jax", "serial")}
                for trans in (False, True)}
    finally:
        for sp in running.values():
            sp.stop()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_same_set(got, ref):
    bam, vcf, truths = got
    rbam, rvcf, rtruths = ref
    assert _read(bam) == _read(rbam)
    assert _read(bam + ".bai") == _read(rbam + ".bai")
    a, b = _read(vcf), _read(rvcf)
    assert a[:4] + a[8:] == b[:4] + b[8:]
    assert len(truths) == len(rtruths) == len(PER_CHROM)
    for t, r in zip(truths, rtruths):
        for k in TRUTH_KEYS:
            assert list(t[k]) == list(r[k]), k


def _kw(d, trans):
    os.makedirs(d)
    return dict(tmpdir=d, n_blocks=4, per_chrom=PER_CHROM, bam_threads=2,
                trans_alternate=trans)


@pytest.mark.parametrize("trans", [False, True], ids=["cis", "trans"])
def test_three_workers_make_the_serial_bytes(reference, tmp_path, trans):
    d = str(tmp_path / "p3")
    got, = testing._make_scenarios([_kw(d, trans)], 3)
    for ref in reference[trans].values():
        _assert_same_set(got["scenario"], ref)
    assert not os.path.exists(os.path.join(d, ".multichrom.bam.parts"))


def test_two_workers_make_two_sets(reference, tmp_path):
    """Six chromosomes of two sets dealt to two workers."""
    got = testing._make_scenarios(
        [_kw(str(tmp_path / f"p2_{trans}"), trans) for trans in (False, True)],
        2)
    for g, trans in zip(got, (False, True)):
        for ref in reference[trans].values():
            _assert_same_set(g["scenario"], ref)
        assert g["parent_peak_mib"] > 0 and len(g["chroms"]) == 3


def test_make_datasets_two_sets_at_once(reference, tmp_path):
    specs = [(PARAMS, "scale.bam", False),
             (dict(PARAMS, trans=True), "scale_trans.bam", True)]
    made = testing.make_datasets(str(tmp_path), specs)
    for m, (params, name, trans) in zip(made, specs):
        d = tmp_path / ".bench_data" / testing.dataset_key(params)
        assert (m["bam"], m["vcf"]) == (str(d / name),
                                        str(d / "multichrom.vcf.gz"))
        assert m["n_gaps"] == 3 * len(PER_CHROM)
        assert sorted(os.listdir(d)) == sorted(
            [name, name + ".bai", "multichrom.vcf.gz"])
        assert 0 < m["write_s"] < m["seconds"]
        assert sum(c["reads"] for c in m["chroms"]) == sum(
            1 for _ in BamReader(m["bam"]).fetch_all())
        assert all(c["reads"] > 0 and c["seconds"] > 0 and c["peak_mib"] > 0
                   for c in m["chroms"])
        assert m["parent_peak_mib"] == made[0]["parent_peak_mib"] >= m[
            "parent_start_mib"] > 0
        truths = reference[trans]["serial"][2]
        _assert_same_set((m["bam"], m["vcf"], truths),
                         reference[trans]["jax"])
        _assert_same_set((m["bam"], m["vcf"], truths),
                         reference[trans]["serial"])
    # cached now: nothing made, nothing timed
    again = testing.make_datasets(str(tmp_path), specs)
    assert [(m["bam"], m["seconds"], m["chroms"], m["parent_peak_mib"],
             m["parent_start_mib"])
            for m in again] == [(m["bam"], 0.0, [], 0.0, 0.0) for m in made]


def test_a_failing_worker_raises_at_once(tmp_path):
    """Chromosome 2's ML values do not fit a byte: its worker raises while
    chromosome 1's, ~10k reads, would run for a minute."""
    per_chrom = [{"read_stagger": 30}, {"read_stagger": 20_000,
                                        "meth_qual": 300}]
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="struct.error"):
        testing._make_scenarios([dict(tmpdir=str(tmp_path), n_blocks=2,
                                      per_chrom=per_chrom)], 2)
    assert time.perf_counter() - t0 < 30
    assert not multiprocessing.active_children()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("params, key", [
    (testing.scale_params(1), "01d3bad447a3"),
    (testing.scale_params(2), "ed2124a25b61"),
    (testing.scale_params(5), "88479bdfaaec"),
    (testing.trans_params(3), "d14ee8b09bf8"),
    (testing.dense_params(0.05), "02b42f4d23e2"),
    (testing.dense_params(0.25), "963c1427eb16"),
], ids=["scale1", "scale2", "scale5", "trans3", "dense0.05", "dense0.25"])
def test_keys_unchanged(params, key):
    assert testing.dataset_key(params) == key
