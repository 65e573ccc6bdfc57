"""The Mosaic feasibility probes of tools/probe_*.py: kernels and plain
versions.

Four kernels (csrc/probe_kernels.cu) take the sixteen pallas_call sites of
the JAX package's tools/ probes; pomfret_tpu_torch/tools/probes.py maps
each probe and variant to one of them:

- `row_copy` (K1): per lane, a bulk async copy of W rows at a row index
  held in device memory into a staged buffer, its placement at the lane's
  slot of a zero (NB, S) buffer, and int32 sums (probe_dma*.py,
  probe_v3_parts.py dma_dyn);
- `lane_vec` (K2): per-lane vector and scalar scratch moves and a loop with
  a runtime trip count (probe_v3_parts.py store2d, sload, sload_dyn,
  smem_dma, whileloop);
- `v3_loop` (K3): a loop in the kernel of candidate pick, row copy into a
  slot and sum (probe_v3_feasibility.py);
- `stile` (K4): a masked ratio sum over all sites or only the site tiles
  of the batch's range, for n_iter iterations (probe_stile.py,
  probe_stile2.py).

Each wrapper launches its kernel for CUDA tensors and counts the launch in
`<wrapper>.launches`; for CPU tensors it runs the plain version beside it
(`<name>_plain`, the same function as gathers, scatters, masks and sums,
called as the wrapper is); any other device raises. Scratch reads as
zero where the TPU probes read scratch rows they never wrote.
"""
from __future__ import annotations

import functools

import torch

from .engine_fused import _check, _launch

LANE_VEC_MODES = ("store2d", "sload", "sload_dyn", "smem_dma", "whileloop")
TILE = 256                       # probe_stile.py's TS
MAX_SHARED_BYTES = 232_448       # one block's shared memory on an H100
MAX_VEC_LANES = 32               # lane_vec: one warp per lane, one block
MAX_CLUSTER_LANES = 16           # row_copy: the lanes are one block cluster
ROW_COPY_THREADS = 256           # row_copy: the threads of a lane's block
COPY_CHUNKS = 4                  # row_copy: a lane's copy in up to 4 pieces,
MIN_CHUNK_BYTES = 4096           # each on its own mbarrier, of >= 4 KB
STILE_WARPS = 4                  # stile: the k's (warps) of a block
V3_LOOP_WARPS = 4                # v3_loop: the lanes (warps) of a block


def _device_of(name, t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# K1: row copy
# ---------------------------------------------------------------------------

def row_copy_plain(src, rows, slots, *, W: int, NB: int,
                   sum_stage: bool = False, keep_buf: bool = False):
    """(lane_sum (L,) int32, total (1,) int32, buf (L,NB,S) of src's dtype
    or None). Lane l's stage is src[l, rows[l]:rows[l]+W] when that lies
    inside [0, R), else zeros; it is written into buf[l, slots[l]:
    slots[l]+W] when that lies inside [0, NB) (NB may be 0); lane_sum sums
    the stage (sum_stage) or the buffer, total the lanes. buf is returned
    only with keep_buf: no probe returns it, the checks of placement read
    it."""
    L, R, S = src.shape
    dev = src.device
    i64 = torch.int64
    w = torch.arange(W, device=dev, dtype=i64)
    rows, slots = rows.to(i64), slots.to(i64)
    copy = (rows >= 0) & (rows <= R - W)
    idx = rows.clamp(0, max(R - W, 0))[:, None] + w              # (L, W)
    stage = src.gather(1, idx[:, :, None].expand(L, W, S))
    stage = torch.where(copy[:, None, None], stage, torch.zeros_like(stage))
    buf = torch.zeros((L, NB, S), dtype=src.dtype, device=dev)
    place = (slots >= 0) & (slots <= NB - W)
    if bool(place.any()):
        lanes = torch.nonzero(place).squeeze(1)
        dest = slots[lanes][:, None] + w                          # (n, W)
        buf[lanes[:, None], dest] = stage[lanes]
    lane_sum = (stage if sum_stage else buf).to(torch.int32).sum(
        dim=(1, 2), dtype=torch.int32)
    return (lane_sum, lane_sum.sum(dtype=torch.int32).view(1),
            buf if keep_buf else None)


def row_copy_plan(W: int, S: int, elt: int):
    """(dynamic shared bytes of a block, chunks, chunk bytes) of row_copy's
    kernel for a stage of W rows of S elements of elt bytes (W*S*elt a
    multiple of 16): 256 bytes of barriers and sums, then the stage,
    copied in up to COPY_CHUNKS pieces of at least MIN_CHUNK_BYTES, each a
    multiple of 16 bytes but the last, which ends the stage."""
    nbytes = W * S * elt
    chunks = max(1, min(COPY_CHUNKS, nbytes // MIN_CHUNK_BYTES))
    size = (-(-nbytes // chunks) + 15) // 16 * 16
    return 256 + nbytes, -(-nbytes // size), size


def row_copy_shape(L: int):
    """(grid (x, y), threads a block, cluster size) of row_copy's launch for
    L lanes: a block of ROW_COPY_THREADS a lane, the L blocks one cluster.
    The wrapper passes it to the launcher, which refuses any other."""
    return (L, 1), ROW_COPY_THREADS, L


def row_copy(src, rows, slots, *, W: int, NB: int, sum_stage: bool = False,
             keep_buf: bool = False):
    """K1 (see row_copy_plain for what it returns). CUDA tensors: one block
    per lane, the L blocks one thread block cluster (so 1 <= L <= 16), the
    copy by cp.async.bulk in up to four pieces, each completing on its own
    mbarrier and summed as it lands, the total added up in block 0 from the
    others' shared memory (one launch, no state shared between launches,
    so launches on several streams at once are independent); the source
    rows must be 16-byte multiples (S * itemsize) and the stage must fit
    one block's shared memory; the buffer is never built on the card but
    written to global memory with keep_buf. CPU tensors: the plain
    version."""
    dev = _device_of("row_copy", src)
    if dev.type == "cpu":
        return row_copy_plain(src, rows, slots, W=W, NB=NB,
                              sum_stage=sum_stage, keep_buf=keep_buf)
    L, R, S = src.shape
    _check("src", src, (torch.int8, torch.int32), (L, R, S), dev)
    _check("rows", rows, (torch.int32,), (L,), dev)
    _check("slots", slots, (torch.int32,), (L,), dev)
    elt = src.element_size()
    if W < 1 or NB < 0:
        raise ValueError(f"row_copy: W={W} must be positive, NB={NB} not "
                         "negative")
    if not 1 <= L <= MAX_CLUSTER_LANES:
        raise ValueError(f"row_copy: {L} lanes; one block cluster takes "
                         f"1-{MAX_CLUSTER_LANES}")
    if (S * elt) % 16 or src.data_ptr() % 16:
        raise ValueError(f"row_copy: a bulk copy needs 16-byte aligned rows "
                         f"(S={S} x {elt} bytes, base {src.data_ptr():#x})")
    shm, chunks, chunk = row_copy_plan(W, S, elt)
    if shm > MAX_SHARED_BYTES - 1024:
        raise ValueError(f"row_copy: {shm} bytes of shared memory per block")
    buf = (torch.empty((L, NB, S), dtype=src.dtype, device=dev)
           if keep_buf else None)
    lane_sum = torch.empty(L, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    _, threads, cluster = row_copy_shape(L)
    _launch(dev, "pomfret_probe_row_copy_launch", elt, src.data_ptr(),
            rows.data_ptr(), slots.data_ptr(),
            None if buf is None else buf.data_ptr(), lane_sum.data_ptr(),
            total.data_ptr(), L, R, S, W, NB, int(bool(sum_stage)), chunks,
            chunk, threads, cluster)
    row_copy.launches += 1
    return lane_sum, total, buf


row_copy.launches = 0


# ---------------------------------------------------------------------------
# K2: lane vectors
# ---------------------------------------------------------------------------

def lane_vec_plain(hp, mode: str, *, n_iter: int = 0, dyn: int = 0):
    """(L,) int32 for hp (L,Rh) int32: store2d min_q hp[l,q]; sload and
    smem_dma sum_l (min_q hp[l,q] + l), the same in every lane; sload_dyn
    the same sum read at index (l + dyn) % L; whileloop n_iter * sum_q
    hp[l,q], summed one iteration at a time."""
    L = hp.shape[0]
    m = hp.amin(dim=1)
    if mode == "store2d":
        return m.to(torch.int32)
    if mode == "whileloop":
        acc = torch.zeros(L, dtype=torch.int32, device=hp.device)
        for _ in range(n_iter):
            acc = acc + hp.sum(dim=1, dtype=torch.int32)
        return acc
    v = m + torch.arange(L, device=hp.device, dtype=m.dtype)
    if mode == "sload_dyn":
        v = v[(torch.arange(L, device=hp.device) + dyn) % L]
    elif mode not in ("sload", "smem_dma"):
        raise ValueError(f"unknown lane_vec mode {mode!r}")
    return v.sum(dtype=torch.int32).expand(L).clone()


def lane_vec_shape(L: int, mode: str):
    """(grid (x, y), threads a block, cluster size) of lane_vec's launch:
    one block of a warp a lane, a one-block cluster for smem_dma (its
    shared-to-shared bulk copy needs a cluster launch), else no cluster.
    The wrapper passes it to the launcher, which refuses any other."""
    return (1, 1), 32 * L, int(mode == "smem_dma")


def lane_vec(hp, mode: str, *, n_iter: int = 0, dyn: int = 0):
    """K2: one block, one warp per lane; a block barrier only where warps
    exchange values (sload, sload_dyn, smem_dma), each lane vector summed in
    one warp reduction. CUDA: the kernel (smem_dma moves the lane vector by
    a shared-to-shared bulk copy in a one-block cluster launch, so L must be
    a multiple of 4); CPU: the plain version."""
    dev = _device_of("lane_vec", hp)
    if mode not in LANE_VEC_MODES:
        raise ValueError(f"unknown lane_vec mode {mode!r}")
    if dev.type == "cpu":
        return lane_vec_plain(hp, mode, n_iter=n_iter, dyn=dyn)
    L, Rh = hp.shape
    _check("hp", hp, (torch.int32,), (L, Rh), dev)
    if not 0 < L <= MAX_VEC_LANES or (mode == "smem_dma" and L % 4):
        raise ValueError(f"lane_vec: {L} lanes (1-{MAX_VEC_LANES}, a "
                         "multiple of 4 for smem_dma)")
    if Rh < 1:
        raise ValueError("lane_vec: no values in a lane's row")
    out = torch.empty(L, dtype=torch.int32, device=dev)
    _, threads, cluster = lane_vec_shape(L, mode)
    _launch(dev, "pomfret_probe_lane_vec_launch", hp.data_ptr(),
            out.data_ptr(), L, Rh, LANE_VEC_MODES.index(mode), n_iter, dyn,
            threads, cluster)
    lane_vec.launches += 1
    return out


lane_vec.launches = 0


# ---------------------------------------------------------------------------
# K3: the v3 loop
# ---------------------------------------------------------------------------

def v3_loop_plain(ids, hp, *, NC: int, n_iter: int):
    """(L,) int32: n_iter iterations of r = the first q with hp[l,q] == 2
    and q >= 2 it (else R-1), cids[l, it % NC] = ids[l, r] in a zero-filled
    (NC, S) buffer, acc += cids[l].sum()."""
    L, R, S = ids.shape
    dev = ids.device
    q = torch.arange(R, device=dev)
    cids = torch.zeros((L, NC, S), dtype=torch.int32, device=dev)
    acc = torch.zeros(L, dtype=torch.int32, device=dev)
    ar = torch.arange(L, device=dev)
    for it in range(n_iter):
        elig = (hp == 2) & (q[None, :] >= 2 * it)
        r = torch.where(elig, q[None, :], R - 1).amin(dim=1)
        cids[:, it % NC] = ids[ar, r]
        acc = acc + cids.sum(dim=(1, 2), dtype=torch.int32)
    return acc


@functools.lru_cache(maxsize=None)   # a Python loop, once per shape
def v3_loop_plan(L: int, R: int, NC: int, S: int):
    """(lanes a block, dynamic shared bytes of a block) of v3_loop's kernel:
    one warp per lane, up to V3_LOOP_WARPS lanes (and at most L) a block,
    fewer where their shared memory would not fit one block. A warp keeps
    an 8-byte mbarrier, NC slot sums and ceil(R / 32) ballot words of 4
    bytes, and, from the next 16-byte boundary after every warp's, NC slot
    rows of S int32."""
    nw = -(-R // 32)

    def shm(w):
        return -(-(8 * w + 4 * w * (NC + nw)) // 16) * 16 + 4 * w * NC * S
    wpb = max(1, min(V3_LOOP_WARPS, L))
    while wpb > 1 and shm(wpb) > MAX_SHARED_BYTES - 1024:
        wpb -= 1
    return wpb, shm(wpb)


def v3_loop(ids, hp, *, NC: int, n_iter: int):
    """K3: one warp per lane, no block barrier; each iteration's row
    arrives straight in its slot by cp.async.bulk on the warp's mbarrier,
    and only the changed slot is summed. CUDA: the kernel (16-byte rows:
    S a multiple of 4; one warp's NC rows must fit one block's shared
    memory); CPU: the plain version."""
    return _v3_loop(ids, hp, NC, n_iter, bulk=True)


def v3_loop_loaded(ids, hp, *, NC: int, n_iter: int):
    """v3_loop, with each row copied into its slot by the warp's own
    16-byte loads (no bulk copy, no mbarrier): the same bits, so that the
    two copies can be timed against each other."""
    return _v3_loop(ids, hp, NC, n_iter, bulk=False)


def _v3_loop(ids, hp, NC, n_iter, *, bulk):
    dev = _device_of("v3_loop", ids)
    if dev.type == "cpu":
        return v3_loop_plain(ids, hp, NC=NC, n_iter=n_iter)
    L, R, S = ids.shape
    _check("ids", ids, (torch.int32,), (L, R, S), dev)
    _check("hp", hp, (torch.int32,), (L, R), dev)
    if S == 0 or (S * 4) % 16 or ids.data_ptr() % 16:
        raise ValueError(f"v3_loop: a row copy needs 16-byte aligned rows "
                         f"(S={S})")
    if NC <= 0 or R <= 0 or n_iter < 0:
        raise ValueError(f"v3_loop: NC={NC}, R={R}, n_iter={n_iter}")
    wpb, shm = v3_loop_plan(L, R, NC, S)
    if shm > MAX_SHARED_BYTES - 1024:
        raise ValueError(f"v3_loop: NC={NC} x S={S} does not fit one block")
    out = torch.empty(L, dtype=torch.int32, device=dev)
    _launch(dev, "pomfret_probe_v3_loop_launch", ids.data_ptr(),
            hp.data_ptr(), out.data_ptr(), L, R, S, NC, n_iter, wpb,
            int(bool(bulk)))
    v3_loop.launches += 1
    return out


v3_loop.launches = 0


# ---------------------------------------------------------------------------
# K4: the site-tiled ratio sum
# ---------------------------------------------------------------------------

def tile_bounds(ranges, S: int):
    """Sites [s0, s1) of the 256-wide tiles between the whole batch's range
    bounds (probe_stile.py:51-52), clipped to [0, S)."""
    mn, mx = int(ranges[:, 0].min()), int(ranges[:, 1].max())
    return max(mn // TILE, 0) * TILE, min((mx + TILE - 1) // TILE * TILE, S)


def stile_plain(cnt, cids, ranges, *, tiled: bool, n_iter: int = 1):
    """(B,NC) f32. c0 = cnt[b, 2 cids[b,k,s], s] where 0 <= cids < D, else
    0; each iteration i sums the f32 ratios c0 / (7 + f32(i) 1e-6) over the
    sites with c0 > 0 and lo_b <= s < hi_b in f64 and rounds once to f32;
    the result is the f32 sum of the iterations' scores in order. tiled:
    only the sites of tile_bounds, one tile at a time."""
    B, D2, S = cnt.shape
    D = D2 // 2
    dev = cnt.device
    f32, f64 = torch.float32, torch.float64
    s0, s1 = tile_bounds(ranges, S) if tiled else (0, S)
    site = torch.arange(S, device=dev)
    ok = (cids >= 0) & (cids < D)
    c0 = cnt[:, 0::2].gather(1, torch.where(ok, cids, 0).long())
    in_range = (site[None, :] >= ranges[:, :1]) & (site[None, :] < ranges[:, 1:])
    keep = ok & (c0 > 0) & in_range[:, None, :]
    c0 = torch.where(keep, c0, torch.zeros_like(c0))
    seven = torch.tensor(7.0, dtype=f32, device=dev)
    step = torch.tensor(1e-6, dtype=f32, device=dev)
    acc = torch.zeros(cids.shape[:2], dtype=f32, device=dev)
    for i in range(n_iter):
        div = seven + torch.tensor(float(i), dtype=f32, device=dev) * step
        score = torch.zeros(cids.shape[:2], dtype=f64, device=dev)
        for t0 in range(s0, s1, TILE if tiled else S):
            t1 = min(t0 + (TILE if tiled else S), s1)
            score += (c0[:, :, t0:t1] / div).sum(dim=2, dtype=f64)
        acc = acc + score.to(f32)
    return acc


def stile_plan(NC: int, S: int, D: int):
    """(k's of a block, dynamic shared bytes of a block) of stile's kernel:
    one warp per (b, k), up to STILE_WARPS k's of one b a block; a block
    stages the D even count planes, a plane of zeros and its id rows over
    S sites (rounded up to a multiple of 4) after a 128-byte barrier,
    whatever the ranges."""
    kpb = max(1, min(STILE_WARPS, NC))
    return kpb, 128 + (D + 1 + kpb) * (-(-S // 4) * 4) * 4


def stile(cnt, cids, ranges, *, tiled: bool, n_iter: int = 1):
    """K4: one warp per (b, k), the inputs staged in shared memory once per
    block, the tile bounds computed in the kernel from the ranges, the
    quotients by reciprocal and FMA. CUDA: the kernel (D + 5 rows of S
    sites must fit one block's shared memory); CPU: the plain version."""
    return stile_divided(cnt, cids, ranges, tiled=tiled, n_iter=n_iter,
                         rcp=True)


def stile_divided(cnt, cids, ranges, *, tiled: bool, n_iter: int = 1,
                  rcp: bool):
    """stile, with its quotients by the reciprocal of each iteration's
    divisor and an FMA correction (rcp) or by __fdiv_rn: the same bits
    either way, so that the two divisions can be timed against each
    other."""
    dev = _device_of("stile", cnt)
    if dev.type == "cpu":
        return stile_plain(cnt, cids, ranges, tiled=tiled, n_iter=n_iter)
    B, D2, S = cnt.shape
    NC = cids.shape[1]
    _check("cnt", cnt, (torch.float32,), (B, D2, S), dev)
    _check("cids", cids, (torch.int32,), (B, NC, S), dev)
    _check("ranges", ranges, (torch.int32,), (B, 2), dev)
    kpb, shm = stile_plan(NC, S, D2 // 2)
    if shm > MAX_SHARED_BYTES - 1024:
        raise ValueError(f"stile: {D2 // 2} count planes and {kpb} id rows "
                         f"of {S} sites need {shm} bytes of shared memory")
    out = torch.empty((B, NC), dtype=torch.float32, device=dev)
    _launch(dev, "pomfret_probe_stile_launch", cnt.data_ptr(),
            cids.data_ptr(), ranges.data_ptr(), out.data_ptr(), B, NC, S,
            D2 // 2, int(bool(tiled)), n_iter, kpb, int(bool(rcp)))
    stile.launches += 1
    return out


stile.launches = 0


def stile_ratios_plain(c0, n_iter: int):
    """(n_iter, n) f32: each f32 c0 (n,) divided by each iteration's
    divisor 7 + f32(i) 1e-6, as stile_plain divides."""
    f32 = torch.float32
    i = torch.arange(n_iter, device=c0.device).to(f32)
    div = torch.tensor(7.0, dtype=f32, device=c0.device) + i * torch.tensor(
        1e-6, dtype=f32, device=c0.device)
    return c0[None, :] / div[:, None]


def stile_ratios(c0, n_iter: int, *, rcp: bool = True):
    """stile's quotients alone, for the check of its division: CUDA, the
    kernel's division (rcp as in stile_divided) in a kernel of its own;
    CPU, the plain version."""
    dev = _device_of("stile_ratios", c0)
    if dev.type == "cpu":
        return stile_ratios_plain(c0, n_iter)
    _check("c0", c0, (torch.float32,), c0.shape, dev)
    if c0.dim() != 1:
        raise ValueError("stile_ratios: c0 must be one-dimensional")
    out = torch.empty((n_iter, c0.numel()), dtype=torch.float32, device=dev)
    _launch(dev, "pomfret_probe_stile_ratio_launch", c0.data_ptr(),
            out.data_ptr(), c0.numel(), n_iter, int(bool(rcp)))
    stile_ratios.launches += 1
    return out


stile_ratios.launches = 0

# ---------------------------------------------------------------------------
# The launch floor
# ---------------------------------------------------------------------------

def launch_floor(device, grid, block: int, cluster: int = 0):
    """Launch the empty kernel on `device` (CUDA only) at a probe's launch
    shape: a grid of (x, y) blocks of `block` threads, in clusters of
    `cluster` blocks along x (0: no cluster launch). Its device time is
    what a launch of that shape costs before any work."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"launch_floor: {dev} is not a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _launch(dev, "pomfret_probe_empty_launch", grid[0], grid[1], block,
            cluster)
    launch_floor.launches += 1


launch_floor.launches = 0

# the probe kernels' wrappers by kernel name; each counts its launches
PROBE_KERNELS = {"probe_row_copy": row_copy, "probe_lane_vec": lane_vec,
                 "probe_v3_loop": v3_loop, "probe_stile": stile}
# their plain versions, called as the wrappers are
PROBE_PLAIN = {"probe_row_copy": row_copy_plain,
               "probe_lane_vec": lane_vec_plain,
               "probe_v3_loop": v3_loop_plain, "probe_stile": stile_plain}
