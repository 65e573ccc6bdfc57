"""Several processes of the port (parallel/distributed.py) on the CPU.

- assign_gaps, _pack_tag_map and _merge_packed_tag_maps (the port's copies)
  equal pomfret_tpu.parallel.distributed's on the same seeded inputs,
  conflicts and empty maps included; a million-tag merge stays under the
  JAX package's time bound (tests/test_distributed.py).
- Two gloo processes: allgather_decisions and allgather_tag_maps rebuild
  the one-process result, first process winning on conflicts
  (tests/test_distributed.py's check; gloo starts in about a second).
- `pomfret-tpu-torch methphase` in two processes (testing.run_processes:
  POMFRET_COORDINATOR, POMFRET_NUM_PROCS, POMFRET_PROC_ID) writes from
  process 0 .mp.vcf/.mp.gtf byte-identical to one process of the port and
  to `pomfret-tpu methphase --engine host`: on 2 chromosomes x 3 gaps
  (every process decides gaps on both chromosomes) with --engine torch and
  --engine host (the scenario and flags of tests/test_multihost_e2e.py),
  and its .mp.bam carries the one-process run's HP tags;
  tests/test_torch_distributed_cli.py runs --n-permutations 7 and
  `report`. No process loads jax or the JAX package.
- The manifest at 2 and 3 processes: process 0 writes every gap once, in
  global gap order, with the one-process run's records, the same bytes on
  every run, and no process's part is left beside it; a 2-process
  `--resume` from a manifest that lacks one gap, with another gap's record
  in a part that a 3-process run would leave, computes the missing gap
  alone and ends with the whole run's manifest and outputs; each process
  reports the all-gathers' spans and its manifest records, process 0 the
  merge and the merged records. The manifest's parts on their own:
  found by rank beside a manifest whose name holds glob characters,
  merged and removed.
Tolerance: exact (arrays equal, outputs byte-identical).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pomfret_tpu.cli import main as tpu_main
from pomfret_tpu.parallel import distributed as jd
from pomfret_tpu_torch.cli import main as port_main
from pomfret_tpu_torch.io.bam import BamReader
from pomfret_tpu_torch.parallel import distributed as td
from pomfret_tpu_torch.testing import (free_port,
                                       make_multichrom_multigap_scenario,
                                       run_processes)
from pomfret_tpu_torch.utils.manifest import (load_manifest,
                                              load_manifest_parts,
                                              rank_part, rank_parts,
                                              write_merged)
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD = {"OMP_NUM_THREADS": "1"}  # processes share the test's cores


@pytest.mark.parametrize("n_procs", [1, 2, 3, 4])
def test_assign_gaps_partitions(n_procs):
    parts = [td.assign_gaps(10, n_procs, p) for p in range(n_procs)]
    assert sorted(sum(parts, [])) == list(range(10))
    assert parts == [jd.assign_gaps(10, n_procs, p) for p in range(n_procs)]


def _maps(seed, n_procs=3, per=40):
    """Seeded qname->tag maps, one per process, sharing some names."""
    rng = np.random.default_rng(seed)
    shared = [f"shared_{i}" for i in range(8)]
    maps = []
    for p in range(n_procs):
        names = [f"read_{p}_{i}/ccs" for i in range(per)] + list(
            rng.choice(shared, size=4, replace=False))
        maps.append({qn: int(rng.integers(-1, 2)) for qn in names})
    maps.insert(1, {})  # a process that joined nothing
    return maps


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_and_merge_match_jax(seed):
    maps = _maps(seed)
    port = [td._pack_tag_map(m) for m in maps]
    ref = [jd._pack_tag_map(m) for m in maps]
    for (pb, pt), (rb, rt) in zip(port, ref):
        assert pb.dtype == rb.dtype == np.uint8
        assert pt.dtype == rt.dtype == np.int32
        np.testing.assert_array_equal(pb, rb)
        np.testing.assert_array_equal(pt, rt)
    merged = td._merge_packed_tag_maps([b for b, _ in port],
                                       [t for _, t in port])
    assert merged == jd._merge_packed_tag_maps([b for b, _ in ref],
                                               [t for _, t in ref])
    first = {}
    for m in maps:  # the first process to hold a name wins
        for qn, t in m.items():
            first.setdefault(qn, t)
    assert merged == first


def test_tag_map_merge_scales_to_a_million_tags():
    """tests/test_distributed.py's WGS-scale merge, on the port's copy."""
    import time
    P, per = 4, 275_000
    packed = []
    for p in range(P):
        m = {f"m64012_220{p}_{i:07d}/ccs": (i + p) & 1 for i in range(per)}
        packed.append(td._pack_tag_map(m))
    assert sum(len(b) + 4 * len(t) for b, t in packed) < 50 << 20
    t0 = time.time()
    merged = td._merge_packed_tag_maps([b for b, _ in packed],
                                       [t for _, t in packed])
    dt = time.time() - t0
    assert len(merged) == P * per
    assert merged["m64012_2200_0000007/ccs"] == 1
    assert dt < 30, f"million-tag merge took {dt:.1f}s"


def test_one_process_needs_no_group(monkeypatch):
    """Without a coordinator initialize does nothing, and the all-gathers
    return this process's own result (-2, no process, becomes -1)."""
    monkeypatch.delenv("POMFRET_COORDINATOR", raising=False)
    td.initialize()
    assert (td.process_count(), td.process_index()) == (1, 0)
    np.testing.assert_array_equal(td.allgather_decisions({0: 1, 2: 0}, 4),
                                  [1, -1, 0, -1])
    assert td.allgather_tag_maps({"a": 1}) == {"a": 1}


_WORKER = r"""
import json, sys
from pomfret_tpu_torch.parallel import distributed as td
rank, n, coordinator = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
td.initialize(coordinator, n, rank)
N = 10
mine = td.assign_gaps(N, n, rank)
dec = td.allgather_decisions({i: (i % 3) - 1 for i in mine}, N)
local = {f"read{i}_{j}": rank for i in mine for j in range(3)}
local["shared"] = rank
if rank == 1:
    local = {}  # an empty map pads to one element
tags = td.allgather_tag_maps(local)
out = {"rank": td.process_index(), "count": td.process_count(),
       "dec": dec.tolist(), "tags": tags, "stats": td.DIST_STATS,
       "loaded": sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "pomfret_tpu"))}
td.shutdown()
print("RESULT " + json.dumps(out))
"""


def test_two_process_allgather(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p), **ONE_THREAD)
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), "2",
                               coordinator], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.split("RESULT ")[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    expect = {f"read{i}_{j}": 0 for i in range(0, 10, 2) for j in range(3)}
    expect["shared"] = 0
    for rank, o in enumerate(outs):
        assert (o["rank"], o["count"]) == (rank, 2)
        assert o["dec"] == [(i % 3) - 1 for i in range(10)]
        assert o["tags"] == expect
        assert o["stats"]["n_allgathers"] == 2
        assert o["stats"]["allgather_bytes"] > 0
        assert o["loaded"] == []


@pytest.fixture(scope="module")
def multichrom(tmp_path_factory):
    """2 chromosomes x 3 gaps (tests/test_multihost_e2e.py's scenario)."""
    d = str(tmp_path_factory.mktemp("multichrom"))
    bam, vcf, _ = make_multichrom_multigap_scenario(
        d, n_chroms=2, n_blocks=4, read_stagger=1400)
    return d, ["-c", "25", "--write-bam", "--vcf", vcf, bam]


def _same_files(p1, p2, exts):
    for ext in exts:
        with open(p1 + ext, "rb") as f1, open(p2 + ext, "rb") as f2:
            a = f1.read()
            assert a == f2.read(), ext
            assert a, ext


def _hp_tags(prefix):
    """{qname: HP} of a run's .mp.bam."""
    return {r.qname: r.get_tag("HP")
            for r in BamReader(prefix + ".mp.bam").fetch_all()}


def _check_procs(outs, n_procs):
    assert len(outs) == n_procs
    for o in outs:
        assert o["rc"] == 0 and o["loaded"] == []


@pytest.fixture(scope="module")
def multichrom_refs(multichrom):
    """The JAX package's --engine host run and the port's one-process
    --engine torch run: {name: output prefix}."""
    d, args = multichrom
    refs = {"jax_host": os.path.join(d, "jax_host"),
            "port_torch": os.path.join(d, "port_torch")}
    assert tpu_main(["methphase", "-o", refs["jax_host"], "--engine", "host",
                     *args]) == 0
    assert port_main(["methphase", "-o", refs["port_torch"], "--engine",
                      "torch", *args]) == 0
    return refs


@pytest.mark.parametrize("engine", ["torch", "host"])
def test_two_process_methphase_multichrom(multichrom, multichrom_refs,
                                          engine):
    d, args = multichrom
    prefix = os.path.join(d, f"two_{engine}")
    outs = run_processes(["methphase", "-o", prefix, "--engine", engine,
                          *args], 2, env=ONE_THREAD)
    _check_procs(outs, 2)
    if engine == "torch":
        # gaps 0, 2, 4 and 1, 3, 5 of chr1's 0-2 and chr2's 3-5
        assert [o["gaps_decided"] for o in outs] == [3, 3]
        for o in outs:
            assert o["dist"]["n_allgathers"] == 3
    for ref in multichrom_refs.values():
        _same_files(prefix, ref, (".mp.vcf", ".mp.gtf"))
    # the merged read tags: process order agrees with gap order here
    assert _hp_tags(prefix) == _hp_tags(multichrom_refs["port_torch"])


def _manifest(prefix):
    return prefix + ".mp.manifest.jsonl"


def _left_beside(prefix):
    """Files a run left beside its manifest: its parts, temporary files."""
    d, base = os.path.split(_manifest(prefix))
    return sorted(x for x in os.listdir(d) if x.startswith(base + "."))


def _gap_order(records):
    """The manifest's (ref, gap_i) keys in global gap order."""
    return sorted(records, key=lambda k: (int(k[0].lstrip("chr")), k[1]))


@pytest.fixture(scope="module")
def manifest_runs(multichrom):
    """methphase --engine torch in 2 and in 3 processes, each twice:
    {n_procs: [(prefix, each process's result), ...]}."""
    d, args = multichrom
    runs = {}
    for n in (2, 3):
        runs[n] = []
        for k in range(2):
            prefix = os.path.join(d, f"manifest_{n}_{k}")
            outs = run_processes(["methphase", "-o", prefix, "--engine",
                                  "torch", *args], n, env=ONE_THREAD)
            _check_procs(outs, n)
            runs[n].append((prefix, outs))
    return runs


@pytest.mark.parametrize("n_procs", [2, 3])
def test_processes_write_one_whole_manifest(multichrom_refs, manifest_runs,
                                            n_procs):
    one = load_manifest(_manifest(multichrom_refs["port_torch"]))
    assert len(one) == 6
    blobs = []
    for prefix, outs in manifest_runs[n_procs]:
        with open(_manifest(prefix)) as f:
            lines = f.read().splitlines()
        keys = [(e["ref"], e["gap_i"]) for e in map(json.loads, lines)]
        assert len(keys) == len(set(keys)) == 6  # every gap once
        assert keys == _gap_order(keys)
        assert load_manifest(_manifest(prefix)) == one
        assert _left_beside(prefix) == []
        assert sum(o["gaps_decided"] for o in outs) == 6
        with open(_manifest(prefix), "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]


def test_processes_report_the_gathers_and_the_merge(manifest_runs):
    _, outs = manifest_runs[2][0]
    for rank, o in enumerate(outs):
        for name in ("allgather_decisions", "allgather_tags",
                     "allgather_manifest"):
            assert name in o["stages"], (rank, name)
        assert o["counters"]["manifest_records"] == 3
        assert ("manifest_merge" in o["stages"]) == (rank == 0)
        assert o["counters"].get("manifest_records_merged") == \
            (6 if rank == 0 else None)


def test_resume_in_processes_computes_only_the_missing_gap(
        multichrom, multichrom_refs, manifest_runs, tmp_path):
    """From a whole 2-process manifest: global gap 1 (chr1's gap 1, dealt
    to process 1) dropped, gap 4 (chr2's gap 1, process 0) moved into the
    part of a process 2, which a 3-process run leaves."""
    _, args = multichrom
    whole, _ = manifest_runs[2][0]
    prefix = str(tmp_path / "resumed")
    with open(_manifest(whole)) as f:
        lines = f.read().splitlines()
    keys = [(e["ref"], e["gap_i"]) for e in map(json.loads, lines)]
    drop, move = keys.index(("chr1", 1)), keys.index(("chr2", 1))
    with open(_manifest(prefix), "w") as f:
        f.writelines(x + "\n" for i, x in enumerate(lines)
                     if i not in (drop, move))
    with open(rank_part(_manifest(prefix), 2), "w") as f:
        f.write(lines[move] + "\n")
    assert len(load_manifest_parts(_manifest(prefix))) == 5
    outs = run_processes(["methphase", "-o", prefix, "--engine", "torch",
                          "--resume", *args], 2, env=ONE_THREAD)
    _check_procs(outs, 2)
    assert [o["gaps_decided"] for o in outs] == [0, 1]
    assert [o["counters"]["manifest_records"] for o in outs] == [0, 1]
    assert load_manifest(_manifest(prefix)) == load_manifest(_manifest(whole))
    with open(_manifest(prefix), "rb") as f1, open(_manifest(whole),
                                                    "rb") as f2:
        assert f1.read() == f2.read()
    assert _left_beside(prefix) == []
    _same_files(prefix, multichrom_refs["port_torch"], (".mp.vcf", ".mp.gtf"))


def test_manifest_parts_by_rank(tmp_path):
    """A prefix with glob characters: the parts are found by rank (not a
    temporary file, not another prefix's manifest), read after the
    manifest, and removed once the merged manifest is in place."""
    path = str(tmp_path / "o[1]*.mp.manifest.jsonl")
    rec = {"ref": "c", "start": 0, "end": 1, "decision": 0, "tags": {}}
    lines = {k: json.dumps(dict(rec, gap_i=k), separators=(",", ":"))
             for k in range(4)}
    for rank, gaps in ((10, [3]), (2, [1, 2]), (0, [2])):
        with open(rank_part(path, rank), "w") as f:
            f.writelines(lines[g] + "\n" for g in gaps)
    with open(path, "w") as f:
        f.write(lines[0] + "\n" + lines[1][:9])  # a torn last line
    for other in (path + ".tmp7", path + ".rank1x",
                  str(tmp_path / "o[1]*.mp.manifest.rank1.jsonl")):
        open(other, "w").close()
    assert [r for r, _ in rank_parts(path)] == [0, 2, 10]
    assert sorted(load_manifest_parts(path)) == [("c", k) for k in range(4)]
    assert write_merged(path, (lines[k] for k in range(4))) == 4
    assert rank_parts(path) == []
    with open(path) as f:
        assert f.read() == "".join(lines[k] + "\n" for k in range(4))
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in (path, path + ".tmp7", path + ".rank1x",
                                      str(tmp_path / "o[1]*.mp.manifest.rank1.jsonl")))


def test_one_process_manifest_gather_is_its_own(monkeypatch):
    monkeypatch.delenv("POMFRET_COORDINATOR", raising=False)
    assert td.allgather_manifest({3: "x", 1: "y"}) == {3: "x", 1: "y"}


@pytest.mark.slow
def test_four_process_methphase(multichrom, multichrom_refs):
    d, args = multichrom
    prefix = os.path.join(d, "four")
    outs = run_processes(["methphase", "-o", prefix, "--engine", "torch",
                          *args], 4, env=ONE_THREAD)
    _check_procs(outs, 4)
    for ref in multichrom_refs.values():
        _same_files(prefix, ref, (".mp.vcf", ".mp.gtf"))
