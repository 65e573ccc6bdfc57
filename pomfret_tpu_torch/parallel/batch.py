"""Batched gap execution on one device or split over several.

Counterpart of pomfret_tpu/parallel/batch.py: the packed numpy batch
(GapBatch, equal to the JAX package's) becomes device tensors
(batch_tensors), runs through the engine (_run_batch), and comes back as a
(G, R) tag matrix. Each in-flight batch has its own CUDA stream; its result
is read once the event recorded after its download has completed.

A mesh (make_gap_mesh, production_mesh) is a tuple of devices. Every field
of a GapBatch is lane-major, so a batch of G lanes splits into len(mesh)
shards of G / len(mesh) consecutive lanes; shard k runs on mesh[k], on a
stream of its own, and the shards' rows are stacked back in lane order
(ShardedBatch). Lanes are independent, so the result is the same at any
device count. A batch whose G the device count does not divide raises:
pack_group's lane_multiple pads G so that it divides.

Engines: "cuda" runs the hand-written kernels and raises on a CPU tensor;
"torch" runs their plain versions on whatever device the batch was given.
POMFRET_FUSED_GEN (_fused_gen) picks the engine generation, as in the JAX
package: 3 (the default) is the whole loop in one launch
(engine_fused3.run_batch_fused3, or loop_plain), 2 one score-and-commit
launch per iteration (engine_fused.run_batch_fused2), 1 one scoring launch
per iteration with the commit in plain torch (engine_fused.run_batch_fused).
"""
from __future__ import annotations

import dataclasses
import functools
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.engine_fused import (run_batch_fused, run_batch_fused2,
                                    score_candidates_batch,
                                    score_commit_plain, score_plain,
                                    step_fused2)
from ..kernels.engine_fused3 import loop_plain, run_batch_fused3
from ..kernels.engine_torch import GapDeviceData, _round_up

LANE_MULTIPLE = 32  # G pads to a multiple of this; _bucket_lanes gives pow2*32


@dataclass
class GapBatch:
    """Stacked per-(gap,direction) arrays, padded to common (R, S, D).

    The mer-id grid ships dense (`ids` (G,R,S)) or as 128-aligned runs
    (`blk` (G,R,CB) uint8 of id+1 + `b0` (G,R) int32, ids None), which the
    device densifies (densify_runs)."""
    ids: Optional[np.ndarray]  # (G, R, S) int8/int32, or None (runs mode)
    has_mmr: np.ndarray    # (G, R) bool
    hp_init: np.ndarray    # (G, R) int32
    seed_ok: np.ndarray    # (G, R) bool
    perm: np.ndarray       # (G, R) int32 — device row -> original read id
    n_reads: np.ndarray    # (G,) int32
    n_sites: np.ndarray    # (G,) int32
    q_break: np.ndarray    # (G,) int32
    min0: np.ndarray       # (G,) int32
    max0: np.ndarray       # (G,) int32
    cov: np.ndarray        # (G,) int32
    n_cand: np.ndarray     # (G,) int32
    D: int
    nc_cap: int
    S: int = 0             # padded site count (== ids.shape[2] when dense)
    blk: Optional[np.ndarray] = None  # (G, R, CB) uint8, id+1, 0 = absent
    b0: Optional[np.ndarray] = None   # (G, R) int32 first block, -1 = none

    def __post_init__(self):
        if self.ids is not None and not self.S:
            self.S = self.ids.shape[2]

    @property
    def shape3(self):
        """(G, R, S) independent of layout."""
        g, r = self.has_mmr.shape
        return g, r, self.S


def pack_gap_batch(datas: Sequence[GapDeviceData], covs: Sequence[int],
                   n_cand: int, pad_g: Optional[int] = None) -> GapBatch:
    """Stack lanes into one batch (pomfret_tpu.parallel.batch.
    pack_gap_batch). G pads to `pad_g`, else to a multiple of 32; pad
    lanes have n_reads = q_break = 0, so they are inactive from iteration
    0."""
    R = max(d.R for d in datas)
    S = max(d.S for d in datas)
    # dictionary capacity buckets to powers of two (>= 4)
    need = max(d.max_d for d in datas)
    D = 4
    while D < need:
        D *= 2
    nc_cap = _round_up(max(n_cand, 1), 16)
    G = pad_g or _round_up(len(datas), LANE_MULTIPLE)
    has_mmr = np.zeros((G, R), dtype=bool)
    hp_init = np.full((G, R), 2, dtype=np.int32)
    seed_ok = np.zeros((G, R), dtype=bool)
    perm = np.full((G, R), -1, dtype=np.int32)
    sc = np.zeros((6, G), dtype=np.int32)
    # runs mode when every real lane carries the compact layout, the ids fit
    # id+1 in uint8 (actual need, not the bucketed D) and S is 128-aligned
    runs = (need <= 254 and S % 128 == 0
            and all(d.blk is not None for d in datas))
    ids = blk = b0 = None
    if runs:
        CB = max(128, max(d.blk.shape[1] for d in datas))
        blk = np.zeros((G, R, CB), dtype=np.uint8)
        b0 = np.full((G, R), -1, dtype=np.int32)
    else:
        ids = np.full((G, R, S), -1,
                      dtype=np.int8 if D <= 127 else np.int32)
    for g, d in enumerate(datas):
        r, s = d.R, d.S
        if runs:
            blk[g, :r, : d.blk.shape[1]] = d.blk
            b0[g, :r] = d.b0
        else:
            ids[g, :r, :s] = d.dense_ids()
        has_mmr[g, :r] = d.has_mmr
        hp_init[g, :r] = d.hp_init
        seed_ok[g, :r] = d.seed_ok
        perm[g, :r] = d.perm
        sc[:, g] = (d.n_reads, d.n_sites, d.q_break, d.min0, d.max0, covs[g])
    return GapBatch(ids=ids, has_mmr=has_mmr, hp_init=hp_init,
                    seed_ok=seed_ok, perm=perm,
                    n_reads=sc[0], n_sites=sc[1], q_break=sc[2],
                    min0=sc[3], max0=sc[4], cov=sc[5],
                    n_cand=np.full(G, n_cand, dtype=np.int32),
                    D=D, nc_cap=nc_cap, S=S, blk=blk, b0=b0)


def batch_args(batch: GapBatch, max_iters: int):
    """The engine's positional numpy arguments (the JAX package's order)."""
    G = batch.shape3[0]
    grid = (batch.ids,) if batch.blk is None else (batch.blk, batch.b0)
    return grid + (batch.has_mmr, batch.hp_init, batch.seed_ok,
                   batch.n_reads, batch.n_sites, batch.q_break, batch.min0,
                   batch.max0, batch.cov, batch.n_cand,
                   np.full(G, max_iters, dtype=np.int32))


_LOOP_KEYS = ("has_mmr", "hp_init", "seed_ok", "n_reads", "n_sites",
              "q_break", "min0", "max0", "cov", "n_cand", "max_iters")


def batch_tensors(batch: GapBatch, max_iters: int,
                  device) -> Dict[str, torch.Tensor]:
    """The packed batch as tensors on `device`, keyed by argument name
    ("ids", or "blk" and "b0", then _LOOP_KEYS). dtypes are kept: ids stay
    int8 when D <= 127. A CUDA upload goes through pinned host memory with
    non_blocking copies on the current stream."""
    device = torch.device(device)
    grid = ("ids",) if batch.blk is None else ("blk", "b0")
    out = {}
    for name, a in zip(grid + _LOOP_KEYS, batch_args(batch, max_iters)):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[name] = t
    return out


def densify_runs(blk: torch.Tensor, b0: torch.Tensor, S: int,
                 dtype=torch.int32) -> torch.Tensor:
    """Dense (G, R, S) mer-id grid from the runs layout by index gather
    (batch._densify_runs builds it with a one-hot einsum): row (g, r) holds
    blk[g, r, s - 128*b0[g, r]] - 1 inside its run of 128-site blocks and
    -1 elsewhere; rows with b0 < 0 carry no mers."""
    G, R, CB = blk.shape
    if S % 128 or CB % 128:
        raise ValueError(f"runs layout needs S and CB multiples of 128, "
                         f"got S={S} CB={CB}")
    C, B = CB // 128, S // 128
    out = torch.full((G, R, B, 128), -1, dtype=dtype, device=blk.device)
    g, r = torch.nonzero(b0 >= 0, as_tuple=True)
    vals = (blk[g, r].view(-1, C, 128).to(torch.int16) - 1).to(dtype)
    start = b0[g, r].to(torch.int64)
    for c in range(C):
        b = start + c
        ok = b < B
        out[g[ok], r[ok], b[ok]] = vals[ok, c]
    return out.view(G, R, S)


def _fused_gen() -> str:
    """Engine generation selector (pomfret_tpu.parallel.batch._fused_gen):
    POMFRET_FUSED_GEN in 1|2|3; the legacy POMFRET_FUSED_V2=0 selects 1;
    any other value warns and takes the default, 3."""
    gen = os.environ.get("POMFRET_FUSED_GEN")
    if gen:
        if gen in ("1", "2", "3"):
            return gen
        from ..utils.log import log_warn
        log_warn("fused_gen",
                 f"POMFRET_FUSED_GEN={gen!r} is not one of 1|2|3; "
                 "using the default engine (3)")
        return "3"
    if os.environ.get("POMFRET_FUSED_V2") == "0":
        return "1"
    return "3"


def _loop_for(engine: str, gen: str):
    """The loop that runs a batch: the kernel wrappers' for "cuda", their
    plain versions' for "torch"."""
    if engine == "cuda":
        return {"1": run_batch_fused, "2": run_batch_fused2,
                "3": run_batch_fused3}[gen]
    if engine == "torch":
        return {"1": functools.partial(run_batch_fused, score=score_plain),
                "2": functools.partial(run_batch_fused2,
                                       step=score_commit_plain),
                "3": loop_plain}[gen]
    raise ValueError(f"unknown device engine {engine!r}")


# the kernel wrappers by kernel name; each counts its launches
KERNELS = {"loop_kernel": run_batch_fused3,
           "score_kernel": score_candidates_batch,
           "score_commit_kernel": step_fused2}


def _run_batch(t: Dict[str, torch.Tensor], batch: GapBatch, engine: str):
    """Densify if needed, then run the selected engine generation; returns
    (hp, stats). Kernel launches add to DISPATCH_STATS["kernel_launches"]
    by kernel name."""
    S, D = batch.S, batch.D
    loop = _loop_for(engine, _fused_gen())
    if "ids" in t:
        ids = t["ids"]
    else:
        ids = densify_runs(t["blk"], t["b0"], S,
                           torch.int8 if D <= 127 else torch.int32)
    if engine == "cuda" and ids.device.type != "cuda":
        raise ValueError(f"engine 'cuda' needs CUDA tensors, got "
                         f"{ids.device}")
    before = {name: fn.launches for name, fn in KERNELS.items()}
    out = loop(ids, *[t[k] for k in _LOOP_KEYS], D=D, nc_cap=batch.nc_cap)
    for name, fn in KERNELS.items():
        DISPATCH_STATS["kernel_launches"][name] += fn.launches - before[name]
    return out


# dispatch observability, the keys of pomfret_tpu.parallel.batch's
# DISPATCH_STATS plus kernel_launches (launches by kernel name) and shapes
# (batches dispatched by (G, R, S, D, nc_cap, layout), layout "runs" or
# "dense")
DISPATCH_STATS = {"n_dispatches": 0, "n_devices_last": 1, "lanes_last": 0,
                  "window_reads": 0,
                  "gaps_decided": 0, "device_wait_s": 0.0, "real_lanes": 0,
                  "prefetch_put_wait_s": 0.0, "prefetch_get_wait_s": 0.0,
                  "prefetch_groups": 0, "prefetch_queue_depth_sum": 0,
                  "kernel_launches": {name: 0 for name in KERNELS},
                  "shapes": {}}


class PendingBatch:
    """(G, R) tag matrix of a batch dispatched to one device. np.asarray
    waits for the event recorded after the device-to-host copy (CUDA),
    then returns the host array; stats() gives the loop's (G, 8) stats."""

    def __init__(self, host: torch.Tensor, event=None, stats=None):
        self._host = host
        self._event = event
        self._stats = stats

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out if dtype is None else out.astype(dtype, copy=False)

    def stats(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._stats.cpu().numpy()


class ShardedBatch:
    """(G, R) tag matrix of a batch split over a mesh: np.asarray waits for
    every shard and stacks their rows in lane order; stats() likewise."""

    def __init__(self, shards):
        self._shards = shards  # [PendingBatch, ...] in lane order

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([np.asarray(s) for s in self._shards])
        return out if dtype is None else out.astype(dtype, copy=False)

    def stats(self) -> np.ndarray:
        return np.concatenate([s.stats() for s in self._shards])


Mesh = Tuple[torch.device, ...]


def make_gap_mesh(devices: Sequence) -> Mesh:
    """A mesh over `devices` (torch.device or its name): shard k of every
    batch runs on devices[k]. A device may be named more than once; its
    shards then run on streams of their own on that one device."""
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh or len({d.type for d in mesh}) != 1:
        raise ValueError(f"a mesh needs one or more devices of one type, "
                         f"got {devices}")
    return mesh


def production_mesh(device) -> Optional[Mesh]:
    """The mesh of this process's production gap batches, or None for one
    device. `device` is where the engine runs (resolve_device): a CUDA
    device without an index means every GPU this process sees
    (CUDA_VISIBLE_DEVICES restricts them), torch.cuda.device_count() of
    them; an indexed one (cuda:1), the CPU, or the host engine (None) means
    that device alone. As in the JAX package, POMFRET_NO_MESH=1 forces one
    device and POMFRET_MESH_DEVICES=N caps the count. Several processes
    compose: each splits its own round-robin share of the gaps over its
    own mesh."""
    if device is None or os.environ.get("POMFRET_NO_MESH"):
        return None
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return None
    n = torch.cuda.device_count()
    cap = os.environ.get("POMFRET_MESH_DEVICES")
    if cap:
        n = min(n, int(cap))
    if n <= 1:
        return None
    return make_gap_mesh([f"cuda:{i}" for i in range(n)])


def upload_gap_batch(batch: GapBatch, max_iters: Optional[int] = None, *,
                     device) -> Dict[str, torch.Tensor]:
    """batch_tensors with the default iteration cap (2R + 64)."""
    if max_iters is None:
        max_iters = 2 * batch.shape3[1] + 64
    return batch_tensors(batch, max_iters, device)


_LANE_FIELDS = ("ids", "has_mmr", "hp_init", "seed_ok", "perm", "n_reads",
                "n_sites", "q_break", "min0", "max0", "cov", "n_cand", "blk",
                "b0")


def _lanes(batch: GapBatch, lo: int, hi: int) -> GapBatch:
    """Lanes [lo, hi) of a batch (views of its arrays)."""
    return dataclasses.replace(batch, **{
        f: getattr(batch, f)[lo:hi] for f in _LANE_FIELDS
        if getattr(batch, f) is not None})


def _dispatch(batch: GapBatch, max_iters: Optional[int], engine: str,
              device: torch.device) -> PendingBatch:
    """Upload and run a batch on one device without waiting for it. On a
    GPU the work goes on a new stream of that device, so the host packs the
    next group while this one runs, and two shards on one card overlap."""
    if device.type != "cuda":
        hp, stats = _run_batch(upload_gap_batch(batch, max_iters,
                                                device=device),
                               batch, engine)
        return PendingBatch(hp, stats=stats)
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        hp, stats = _run_batch(upload_gap_batch(batch, max_iters,
                                                device=device),
                               batch, engine)
        host = torch.empty(hp.shape, dtype=hp.dtype, pin_memory=True)
        host.copy_(hp, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return PendingBatch(host, event, stats)


def run_gap_batch_async(batch: GapBatch, max_iters: Optional[int] = None, *,
                        engine: str, device=None,
                        mesh: Optional[Mesh] = None):
    """Upload and run a batch without waiting for it: on `device`, or split
    over `mesh` (a PendingBatch, or a ShardedBatch for a mesh of several
    devices). Raises if the mesh's device count does not divide G."""
    devices = mesh if mesh is not None else (torch.device(device),)
    G = batch.shape3[0]
    n = len(devices)
    if G % n:
        raise ValueError(f"a batch of {G} lanes does not split over {n} "
                         f"devices (pack it with lane_multiple={n})")
    DISPATCH_STATS["n_dispatches"] += 1
    DISPATCH_STATS["n_devices_last"] = n
    DISPATCH_STATS["lanes_last"] = G
    shape = batch.shape3 + (batch.D, batch.nc_cap,
                            "dense" if batch.blk is None else "runs")
    DISPATCH_STATS["shapes"][shape] = DISPATCH_STATS["shapes"].get(shape,
                                                                   0) + 1
    if n == 1:
        return _dispatch(batch, max_iters, engine, devices[0])
    step = G // n
    return ShardedBatch([_dispatch(_lanes(batch, k * step, (k + 1) * step),
                                   max_iters, engine, d)
                         for k, d in enumerate(devices)])


def run_gap_batch(batch: GapBatch, max_iters: Optional[int] = None, *,
                  engine: str, device=None,
                  mesh: Optional[Mesh] = None) -> np.ndarray:
    """Run a packed (gap, direction) batch; returns (G, R) tag vectors."""
    return np.asarray(run_gap_batch_async(batch, max_iters, engine=engine,
                                          device=device, mesh=mesh))


class StitchedGroupResult:
    """Lazy (L, R) tag matrix for a group dispatched as >1 layout sub-batch
    (pack_group's mixed-layout split). np.asarray blocks on every part and
    stitches each sub-batch's real lanes back into pack order; rows beyond
    a part's padded R stay at the unphased state (2)."""

    def __init__(self, parts, n_lanes: int):
        self._parts = parts  # [(lane_indices, pending result), ...]
        self._n = n_lanes

    def __array__(self, dtype=None, copy=None):
        mats = [(idx, np.asarray(dev)) for idx, dev in self._parts]
        R = max(m.shape[1] for _, m in mats)
        out = np.full((self._n, R), 2, dtype=np.int32)
        for idx, m in mats:
            out[idx, : m.shape[1]] = m[: len(idx)]
        if dtype is not None:
            out = out.astype(dtype, copy=False)
        return out


def run_gap_batch_group_async(parts, n_lanes: Optional[int] = None, *,
                              engine: str, device=None,
                              mesh: Optional[Mesh] = None):
    """Dispatch a packed group's sub-batches (pack_group's parts list).
    One part returns its pending result; a mixed group dispatches every
    sub-batch before blocking on any and returns a StitchedGroupResult."""
    kw = dict(engine=engine, device=device, mesh=mesh)
    if len(parts) == 1:
        return run_gap_batch_async(parts[0][1], **kw)
    futs = [(idx, run_gap_batch_async(b, **kw)) for idx, b in parts]
    if n_lanes is None:
        n_lanes = int(max(i.max() for i, _ in futs)) + 1
    return StitchedGroupResult(futs, n_lanes)
