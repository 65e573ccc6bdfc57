"""Several processes (pomfret_tpu/parallel/distributed.py) over
torch.distributed.

Processes are peers of one gloo process group. Every process builds the
same global gap (or report window) index from the same VCF; gaps are dealt
round-robin over the processes (assign_gaps: the gap is the unit, so no
read is decided twice). Each process loads only its own gaps' windows and
runs them on its own devices; the per-gap decisions, the read tags and
the manifest lines are then all-gathered (allgather_decisions,
allgather_tag_maps, allgather_manifest), so every process holds the whole
result and process 0 writes outputs equal to a one-process run. Each
all-gather is a span of its own (utils.stats.stage: allgather_decisions,
allgather_tags, allgather_manifest) that holds the wait for the slowest
process.

Every collective runs on gloo, with a card too: what is gathered is host
numpy (a decision vector, a name blob, a tag vector and a blob of
manifest lines), gloo spans hosts over TCP, and it takes two ranks on one
GPU, which NCCL refuses.

The pure-numpy helpers (assign_gaps, _pack_tag_map,
_merge_packed_tag_maps) are copies of the JAX package's.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.stats import stage

# all-gather seconds and payload bytes this process contributed, and the
# number of all-gathers (the JAX package's keys)
DIST_STATS = {"allgather_s": 0.0, "allgather_bytes": 0, "n_allgathers": 0}


def _group_up() -> bool:
    # no group is up where torch.distributed was never imported: asking
    # does not import torch
    dist = sys.modules.get("torch.distributed")
    return dist is not None and dist.is_available() and dist.is_initialized()


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the gloo process group named by the arguments or by
    POMFRET_COORDINATOR (host:port of process 0), POMFRET_NUM_PROCS and
    POMFRET_PROC_ID. Without a coordinator this is a one-process run and
    nothing happens."""
    coordinator = coordinator or os.environ.get("POMFRET_COORDINATOR")
    if coordinator is None:
        return
    num_processes = num_processes or int(os.environ["POMFRET_NUM_PROCS"])
    if process_id is None:
        process_id = int(os.environ["POMFRET_PROC_ID"])
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if _group_up():
        import torch.distributed as dist
        dist.destroy_process_group()


def process_count() -> int:
    """Processes in the group; 1 when no group is up."""
    if not _group_up():
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


def process_index() -> int:
    """This process's rank; 0 when no group is up."""
    if not _group_up():
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def assign_gaps(n_gaps: int, num_processes: int, process_id: int) -> List[int]:
    """Deterministic round-robin gap assignment (same on every host)."""
    return [i for i in range(n_gaps) if i % num_processes == process_id]


def _allgather(a: np.ndarray) -> np.ndarray:
    """(P, *a.shape): every process's `a`, in rank order. Every process
    must pass the same shape and dtype."""
    import torch
    import torch.distributed as dist
    t = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def allgather_decisions(local: Dict[int, int], n_gaps: int) -> np.ndarray:
    """All-gather per-gap decisions across processes.

    local: {global gap index: decision} computed by this process. Returns
    the (n_gaps,) global decision vector, identical on every process: a
    dense max over the processes' vectors (decisions are >= -1; a gap no
    process decided carries -2, and ends as -1, no join)."""
    vec = np.full(n_gaps, -2, dtype=np.int32)
    for i, d in local.items():
        vec[i] = d
    if process_count() == 1:
        out = vec
    else:
        t0 = time.perf_counter()
        with stage("allgather_decisions"):
            out = _allgather(vec).max(axis=0).astype(np.int32)
        DIST_STATS["allgather_s"] += time.perf_counter() - t0
        DIST_STATS["allgather_bytes"] += int(vec.nbytes)
        DIST_STATS["n_allgathers"] += 1
    out[out == -2] = -1
    return out


def _pack_tag_map(local: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a qname->haptag map into two flat arrays for collective
    transport: a NUL-joined name byte blob (uint8) and the parallel tag
    vector (int32), names sorted for determinism."""
    names = sorted(local)
    tags = np.fromiter((local[qn] for qn in names), dtype=np.int32,
                       count=len(names))
    if names:
        blob = np.frombuffer(b"\0".join(qn.encode() for qn in names),
                             dtype=np.uint8).copy()
    else:
        blob = np.zeros(0, dtype=np.uint8)
    return blob, tags


def _merge_packed_tag_maps(blobs: Sequence[np.ndarray],
                           tag_arrays: Sequence[np.ndarray]) -> Dict[str, int]:
    """Merge per-process packed maps in process order; first process wins
    on conflicts (matches the reference's per-thread hash merge,
    blockjoin.c:4579-4595)."""
    merged: Dict[str, int] = {}
    for blob, tags in zip(blobs, tag_arrays):
        if len(tags) == 0:
            continue
        names = bytes(blob).split(b"\0")
        if len(names) != len(tags):
            raise ValueError(f"packed tag map is inconsistent: {len(names)} "
                             f"names, {len(tags)} tags")
        for qn, t in zip(names, tags.tolist()):
            merged.setdefault(qn.decode(), t)
    return merged


def allgather_tag_maps(local: Dict[str, int]) -> Dict[str, int]:
    """All-gather qname->haptag maps; the first process wins on conflicts.
    The lengths go first, so each process pads its name blob and tag
    vector to the largest of them (at least one element)."""
    if process_count() == 1:
        return dict(local)
    t0 = time.perf_counter()
    with stage("allgather_tags"):
        blob, tags = _pack_tag_map(local)
        lens = _allgather(np.array([len(blob), len(tags)], dtype=np.int64))
        mxb, mxt = max(1, int(lens[:, 0].max())), max(1, int(lens[:, 1].max()))
        pb = np.zeros(mxb, dtype=np.uint8)
        pb[: len(blob)] = blob
        pt = np.zeros(mxt, dtype=np.int32)
        pt[: len(tags)] = tags
        all_blobs = _allgather(pb)
        all_tags = _allgather(pt)
    DIST_STATS["allgather_s"] += time.perf_counter() - t0
    DIST_STATS["allgather_bytes"] += int(pb.nbytes + pt.nbytes + 16)
    DIST_STATS["n_allgathers"] += 1
    return _merge_packed_tag_maps(
        [all_blobs[p, : int(lens[p, 0])] for p in range(len(lens))],
        [all_tags[p, : int(lens[p, 1])] for p in range(len(lens))])


def allgather_manifest(local: Dict[int, str]) -> Dict[int, str]:
    """All-gather manifest lines keyed by global gap index; the first
    process wins where two hold one gap. As allgather_tag_maps, the
    lengths go first, then one byte blob a process ("<gap> <line>\\n" a
    line) padded to the largest (at least one byte)."""
    if process_count() == 1:
        return dict(local)
    t0 = time.perf_counter()
    with stage("allgather_manifest"):
        blob = np.frombuffer("".join(f"{g} {line}\n" for g, line in
                                     sorted(local.items())).encode(),
                             dtype=np.uint8)
        lens = _allgather(np.array([len(blob)], dtype=np.int64))[:, 0]
        pb = np.zeros(max(1, int(lens.max())), dtype=np.uint8)
        pb[: len(blob)] = blob
        blobs = _allgather(pb)
    DIST_STATS["allgather_s"] += time.perf_counter() - t0
    DIST_STATS["allgather_bytes"] += int(pb.nbytes + 8)
    DIST_STATS["n_allgathers"] += 1
    merged: Dict[int, str] = {}
    for p, n in enumerate(lens.tolist()):
        for row in bytes(blobs[p, :n]).decode().split("\n")[:-1]:
            g, line = row.split(" ", 1)
            merged.setdefault(int(g), line)
    return merged
