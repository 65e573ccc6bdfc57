"""Run the Mosaic feasibility probes of tools/probe_*.py on the port's
kernels.

    python -m pomfret_tpu_torch.tools.probes [probe_file [variant ...]]
                                             [--device cuda|cpu]

Every probe and variant of the JAX package's tools/ (43 variants of
probe_dma.py, probe_dma2-6.py, probe_v3_parts.py and probe_v3_feasibility.py,
plus probe_stile.py and probe_stile2.py) has an entry in PROBES, keyed by
the file's stem and the variant's name (`main` for a file without
variants). An entry makes the probe's inputs, runs them through one of the
four kernels of kernels/probes.py and checks the output against the probe's
own numpy oracle, with scratch zero-filled: exact for the integer sums and
bit for bit for the ratio sums (their f64 sums are exact). It prints one
`<file> <variant>: OK ...` or `FAIL ...` line, and the command exits 1 if
any entry failed (the JAX probes print FAIL and exit 0).

The kernels run on the card (the default); `--device cpu` runs their plain
versions instead. Where the probe's copy is at a static row in Pallas and
at a traced one in another variant, both read the row from device memory
here: a CUDA kernel has no such distinction to make.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..kernels import probes as kp

BG, R, S, NC = 8, 64, 256, 4       # the probes' lane block, reads, sites


@dataclass
class Probe:
    """One probe variant: `make()` gives its numpy inputs; `call(fn, t)`
    runs them (torch tensors `t`) through `fn`, the wrapper of its kernel
    or its plain version (kernels/probes.py PROBE_KERNELS, PROBE_PLAIN),
    and returns the raw outputs; `result(raw)` gives the arrays the JAX
    probe's pallas_calls return, by name; `expect(inputs)` the probe's
    oracle, with the same names."""
    stem: str
    variant: str
    kernel: str
    make: Callable[[], Dict[str, np.ndarray]]
    call: Callable
    result: Callable[[Tuple], Dict[str, np.ndarray]]
    expect: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]
    kw: dict = field(default_factory=dict)
    # the JAX probe reads scratch it never wrote: its result is undefined
    undefined_in_jax: bool = False


def _ids(dt, shape=(BG, R, S)):
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.int64) % 5 - 1).astype(dt).reshape(shape)


def _col(a):
    return np.asarray(a, dtype=np.int64).reshape(-1, 1)


PROBES: Dict[Tuple[str, str], Probe] = {}


def _add(p: Probe):
    PROBES[(p.stem, p.variant)] = p


# ---------------------------------------------------------------------------
# K1 entries: rows (-1 = no copy), slots (-1 = no placement), W, NB (0 where
# the probe's scratch is the copy's destination alone, so the stage is all)
# ---------------------------------------------------------------------------

def _k1(stem, variant, dt, rows, slots, W, NB, out, expect, sum_stage=False,
        src_lanes=BG, undefined=False):
    rows = np.asarray(rows, dtype=np.int32)
    slots = np.asarray(slots, dtype=np.int32)

    def make():
        return dict(src=_ids(dt)[:src_lanes], rows=rows, slots=slots)

    def call(fn, t):
        return fn(t["src"], t["rows"], t["slots"], W=W, NB=NB,
                  sum_stage=sum_stage)

    def result(raw):
        lane_sum, total = (np.asarray(x.cpu(), dtype=np.int64)
                           for x in raw[:2])
        if out == "lanes":
            return {"out": _col(lane_sum)}
        if out == "total":
            return {"out": total.reshape(1, 1)}
        return {"out": np.full((BG, 1), total[0], dtype=np.int64)}  # bcast

    _add(Probe(stem, variant, "probe_row_copy", make, call, result,
               lambda i: {"out": np.asarray(expect(i["src"]), np.int64)},
               dict(W=W, NB=NB, sum_stage=sum_stage), undefined))


_LANES = np.arange(BG)

# probe_dma.py: lane l copies W rows at row l into slot l % 4 of (8, S)
for _v in ("static_i32", "static_i8", "traced_row_i32", "traced_row_i8",
           "traced_both_i32", "traced_both_i8", "chunk_i8", "chunk_i32"):
    _W = 4 if _v.startswith("chunk") else 1

    def _dma_expect(ids, W=_W):
        cids = np.zeros((BG, 8, S), np.int64)
        for l in range(BG):
            cids[l, l % 4:l % 4 + W] = ids[l, l:l + W]
        return _col(cids.sum(axis=(1, 2)))

    _k1("probe_dma", _v, np.int8 if _v.endswith("i8") else np.int32, _LANES,
        _LANES % 4, _W, 8, "lanes", _dma_expect,
        undefined=_v.endswith("i8"))

# probe_dma2.py: one copy, the total of the whole scratch
_NONE7 = [-1] * (BG - 1)
_NOSLOT = [-1] * BG
_k1("probe_dma2", "full3d", np.int32, [0] * BG, _NOSLOT, R, 0, "total",
    lambda ids: ids.astype(np.int64).sum().reshape(1, 1), sum_stage=True)
_k1("probe_dma2", "lane3d", np.int32, [0] + _NONE7, _NOSLOT, R, 0, "total",
    lambda ids: ids[0].astype(np.int64).sum().reshape(1, 1), sum_stage=True)
for _v in ("row2d", "row2d_ds", "row2d_sq", "interp"):
    _k1("probe_dma2", _v, np.int32, [0] + _NONE7, _NOSLOT, 1, 0, "total",
        lambda ids: ids[0, 0].astype(np.int64).sum().reshape(1, 1),
        sum_stage=True)
_k1("probe_dma2", "row_flat", np.int32, [0], [-1], 1, 0, "total",
    lambda ids: ids[0, 0].astype(np.int64).sum().reshape(1, 1),
    sum_stage=True, src_lanes=1)

# probe_dma3.py: lane 0 copies W rows at row W (3 when unaligned)
for _v in ("c8_static", "c8_dyn_aligned", "c8_dyn_unaligned", "c16_i8",
           "c32_i8", "c32_i8_dyn"):
    _W = int(_v[1:3].rstrip("_"))
    _r0 = 3 if "unaligned" in _v else _W
    _k1("probe_dma3", _v, np.int8 if "i8" in _v else np.int32,
        [_r0] + _NONE7, _NOSLOT, _W, 0, "total",
        lambda ids, W=_W, r0=_r0: ids[0, r0:r0 + W].astype(np.int64)
        .sum().reshape(1, 1), sum_stage=True, undefined="i8" in _v)

# probe_dma4.py: (BG, R, 1, S) ids; one row at row 5, or per-lane rows
# l + 2 placed in slot l % NC of (BG, NC, S)
for _dt in ("i32", "i8"):
    _k1("probe_dma4", f"lead_{_dt}", np.int32 if _dt == "i32" else np.int8,
        [5] + _NONE7, _NOSLOT, 1, 0, "total",
        lambda ids: ids[0, 5].astype(np.int64).sum().reshape(1, 1),
        sum_stage=True)
    _k1("probe_dma4", f"lead_{_dt}_multi",
        np.int32 if _dt == "i32" else np.int8, _LANES + 2, _LANES % NC, 1, NC,
        "lanes", lambda ids: _col([ids[l, l + 2].astype(np.int64).sum()
                                   for l in range(BG)]),
        undefined=_dt == "i8")

# probe_dma5.py: per-lane rows l + 2 of an SMEM row table; the stage sums


def _dma5_expect(copied):
    return lambda ids: _col([ids[l, l + 2].astype(np.int64).sum()
                             if l in copied else 0 for l in range(BG)])


for _v, _copied, _place in (("semarr", (0,), False), ("stage_l", (0, 1), False),
                            ("placement", (), True), ("bcast", (), True),
                            ("multi_noplace", tuple(range(BG)), False),
                            ("multi_full", tuple(range(BG)), True)):
    _k1("probe_dma5", _v, np.int32,
        [l + 2 if l in _copied else -1 for l in range(BG)],
        _LANES % NC if _place else [-1] * BG, 1, NC, "lanes",
        _dma5_expect(_copied), sum_stage=True)

# probe_dma6.py: one row at row 5 into lane 0's stage; t3-t5 add a cids
# buffer of (BG, 4|8, S), t5 places every lane's stage in its slot 2
for _v, _nb, _slot, _out in (("t1", 0, -1, "bcast"), ("t2", 0, -1, "lanes"),
                             ("t3", NC, -1, "lanes"), ("t4", 8, -1, "lanes"),
                             ("t5", 8, 2, "lanes")):
    _k1("probe_dma6", _v, np.int32, [5] + _NONE7, [_slot] * BG, 1, _nb, _out,
        (lambda ids: np.full((BG, 1), ids[0, 5].astype(np.int64).sum()))
        if _out == "bcast" else
        (lambda ids: _col([ids[0, 5].astype(np.int64).sum()] + [0] * 7)),
        sum_stage=True)


def _dma_dyn_expect(ids):
    cids = np.zeros((BG, 4, S), np.int64)
    for l in range(BG):
        cids[l, l % 4] = ids[l, l]
    return _col(cids.sum(axis=(1, 2)))


_k1("probe_v3_parts", "dma_dyn", np.int8, _LANES, _LANES % 4, 1, 4, "lanes",
    _dma_dyn_expect, undefined=True)


# ---------------------------------------------------------------------------
# K2 entries: probe_v3_parts.py on hp = 2 everywhere
# ---------------------------------------------------------------------------

def _k2(variant, n_iter=0, dyn=0):
    def make():
        return dict(hp=np.full((BG, R), 2, np.int32))

    def call(fn, t):
        return (fn(t["hp"], variant, n_iter=n_iter, dyn=dyn),)

    def expect(i):
        hp = i["hp"].astype(np.int64)
        if variant == "store2d":
            return {"out": _col(hp.min(axis=1))}
        if variant == "whileloop":
            return {"out": _col(n_iter * hp.sum(axis=1))}
        v = hp.min(axis=1) + np.arange(BG)
        return {"out": np.full((BG, 1), v.sum())}

    _add(Probe("probe_v3_parts", variant, "probe_lane_vec", make, call,
               lambda raw: {"out": _col(raw[0].cpu())}, expect,
               dict(mode=variant, n_iter=n_iter, dyn=dyn)))


for _v in ("store2d", "sload", "smem_dma"):
    _k2(_v)
_k2("sload_dyn", dyn=0)          # hp[0, 0] * 0 in the probe: 0 at run time
_k2("whileloop", n_iter=5)


# ---------------------------------------------------------------------------
# K3 entry: probe_v3_feasibility.py
# ---------------------------------------------------------------------------

V3_ITERS = 3


def _v3_make():
    hp = np.full((BG, R), 2, np.int32)
    hp[:, ::3] = 0
    return dict(ids=_ids(np.int32), hp=hp)


def _v3_expect(i):
    ids, hp = i["ids"], i["hp"]
    cids = np.zeros((BG, NC, S), np.int64)
    acc = np.zeros(BG, np.int64)
    for it in range(V3_ITERS):
        for l in range(BG):
            cand = [q for q in range(R) if hp[l, q] == 2 and q >= it * 2]
            cids[l, it % NC] = ids[l, cand[0] if cand else R - 1]
        acc += cids.sum(axis=(1, 2))
    return {"out": _col(acc)}


_add(Probe("probe_v3_feasibility", "main", "probe_v3_loop", _v3_make,
           lambda fn, t: (fn(t["ids"], t["hp"], NC=NC, n_iter=V3_ITERS),),
           lambda raw: {"out": _col(raw[0].cpu())}, _v3_expect,
           dict(NC=NC, n_iter=V3_ITERS)))


# ---------------------------------------------------------------------------
# K4 entries: probe_stile.py (one iteration) and probe_stile2.py (400)
# ---------------------------------------------------------------------------

STILE_SHAPE = dict(bg=32, nc=16, S=1536, D=4)
STILE_RANGE = (128, 640)


def stile_make():
    """probe_stile.py's inputs, from the same numpy stream."""
    bg, nc, s, d = (STILE_SHAPE[k] for k in ("bg", "nc", "S", "D"))
    rng = np.random.default_rng(0)
    cnt = rng.integers(0, 5, size=(bg, 2 * d, s)).astype(np.float32)
    cids = rng.integers(-1, d, size=(bg, nc, s)).astype(np.int32)
    ranges = np.stack([np.full(bg, STILE_RANGE[0]),
                       np.full(bg, STILE_RANGE[1])], 1).astype(np.int32)
    return dict(cnt=cnt, cids=cids, ranges=ranges)


def stile_expect(i, n_iter):
    """numpy oracle: the exact f64 sum of each iteration's f32 ratios,
    rounded to f32, accumulated in f32."""
    cnt, cids, ranges = i["cnt"], i["cids"], i["ranges"]
    B, D2, Sn = cnt.shape
    ok = (cids >= 0) & (cids < D2 // 2)
    c0 = np.take_along_axis(cnt[:, 0::2], np.where(ok, cids, 0), axis=1)
    site = np.arange(Sn)
    keep = (ok & (c0 > 0) & ((site >= ranges[:, :1]) &
                             (site < ranges[:, 1:]))[:, None, :])
    seg = np.broadcast_to(np.arange(B * cids.shape[1]).reshape(
        B, -1, 1), keep.shape)[keep]
    vals = c0[keep]
    acc = np.zeros(B * cids.shape[1], np.float32)
    for it in range(n_iter):
        div = np.float32(7.0) + np.float32(it) * np.float32(1e-6)
        r = (vals / div).astype(np.float32).astype(np.float64)
        acc = (acc + np.bincount(seg, weights=r, minlength=acc.size)
               .astype(np.float32)).astype(np.float32)
    return acc.reshape(B, -1)


for _stem, _n in (("probe_stile", 1), ("probe_stile2", 400)):
    def _call(fn, t, n=_n):
        return tuple(fn(t["cnt"], t["cids"], t["ranges"], tiled=tiled,
                        n_iter=n) for tiled in (False, True))

    def _exp(i, n=_n):
        e = stile_expect(i, n)
        return {"full": e, "tiled": e}

    _add(Probe(_stem, "main", "probe_stile", stile_make, _call,
               lambda raw: {"full": raw[0].cpu().numpy(),
                            "tiled": raw[1].cpu().numpy()}, _exp,
               dict(n_iter=_n)))


def tensors(inputs, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in inputs.items()}


def compared(p: Probe):
    """(wrapper, plain version) of p's kernel as the checks of the kernel
    against its plain version call them: K1 also writes back its buffer,
    so that placement is compared too."""
    fns = kp.PROBE_KERNELS[p.kernel], kp.PROBE_PLAIN[p.kernel]
    if p.kernel == "probe_row_copy":
        return tuple(functools.partial(f, keep_buf=True) for f in fns)
    return fns


def launch_shape(p: Probe, inputs):
    """(grid (x, y), threads a block, cluster size or 0) of one launch of
    p's kernel on these inputs, from the plans its wrapper launches it
    at: the shape at which kernels/probes.launch_floor measures its launch
    floor."""
    if p.kernel == "probe_row_copy":
        return kp.row_copy_shape(inputs["src"].shape[0])
    if p.kernel == "probe_lane_vec":
        return kp.lane_vec_shape(inputs["hp"].shape[0], p.kw["mode"])
    if p.kernel == "probe_v3_loop":
        L, R, S = inputs["ids"].shape
        wpb = kp.v3_loop_plan(L, R, p.kw["NC"], S)[0]
        return (-(-L // wpb), 1), 32 * wpb, 0
    B, NC = inputs["cids"].shape[:2]
    kpb = kp.stile_plan(NC, inputs["cids"].shape[2],
                        inputs["cnt"].shape[1] // 2)[0]
    return (-(-NC // kpb), B), 32 * kpb, 0


def run_probe(p: Probe, device):
    """Run one entry on `device` through its kernel's wrapper (on the CPU,
    the plain version); returns (inputs, raw outputs, result, ok,
    message)."""
    inputs = p.make()
    raw = p.call(kp.PROBE_KERNELS[p.kernel], tensors(inputs, device))
    res = p.result(raw)
    want = p.expect(inputs)
    bad = [k for k in want if not np.array_equal(res[k], want[k])]
    if bad:
        k = bad[0]
        d = np.abs(res[k].astype(np.float64) - want[k].astype(np.float64))
        msg = (f"FAIL {k}: max |got - oracle| {d.max()} "
               f"got {res[k].ravel()[:8].tolist()} "
               f"oracle {want[k].ravel()[:8].tolist()}")
    elif p.kernel == "probe_stile":
        msg = (f"OK full == tiled == oracle bit for bit "
               f"({'x'.join(map(str, res['full'].shape))}, "
               f"{p.kw['n_iter']} iteration(s))")
    else:
        msg = f"OK out={res['out'].ravel().tolist()}"
    return inputs, raw, res, not bad, msg


def select(probe_file=None, variants=()):
    """The entries of one probe file (a stem or a path) and variants, or all
    of them in registry order."""
    if probe_file is None:
        return list(PROBES.values())
    stem = os.path.splitext(os.path.basename(probe_file))[0]
    sel = [p for (s, v), p in PROBES.items()
           if s == stem and (not variants or v in variants)]
    missing = set(variants) - {p.variant for p in sel}
    if not sel or missing:
        raise KeyError(f"no probe {stem} {sorted(missing) or ''}; known: "
                       f"{sorted({s for s, _ in PROBES})}")
    return sel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pomfret_tpu_torch.tools.probes",
        description="The tools/probe_*.py Mosaic probes on the port's "
                    "kernels (the card), or their plain versions "
                    "(--device cpu).")
    ap.add_argument("probe_file", nargs="?",
                    help="probe file or stem (default: every probe)")
    ap.add_argument("variant", nargs="*", help="variants (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (the "
                         "plain versions)")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("probes: no CUDA device; pass --device cpu for the plain "
              "versions", file=sys.stderr)
        return 2
    if dev.type not in ("cuda", "cpu"):
        print(f"probes: unsupported device {dev}", file=sys.stderr)
        return 2
    try:
        entries = select(a.probe_file, a.variant)
    except KeyError as e:
        print(f"probes: {e.args[0]}", file=sys.stderr)
        return 2
    failed = 0
    for p in entries:
        try:
            ok, msg = run_probe(p, dev)[3:]
        except Exception as e:  # a failed build or launch is a FAIL too
            ok, msg = False, f"FAIL {type(e).__name__} {str(e).splitlines()[0][:160]}"
        failed += not ok
        print(f"{p.stem} {p.variant}: {msg}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
