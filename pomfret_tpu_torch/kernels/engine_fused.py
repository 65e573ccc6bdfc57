"""The per-iteration engines (v1, v2) and the batched helpers of the loop.

Counterpart of pomfret_tpu/kernels/engine_fused.py:
- the XLA (not Pallas) pieces: the closed-form valid-site range
  (_range_from_seed_b, :156-171), the seed count table
  (_seed_count_table_b, :174-184) and the candidate collection of each
  iteration (_candidates_b, :213-223);
- the two Pallas kernels, each as a plain PyTorch version and the wrapper
  of a hand-written CUDA kernel (csrc/score_kernel.cu,
  csrc/score_commit_kernel.cu): `score_plain`/`score_candidates_batch`
  for `_score_kernel` (:80-120) and `score_commit_plain`/`step_fused2`
  for `_score_commit_kernel` (:273-373). A wrapper launches its kernel
  for CUDA tensors, runs the plain version only for tensors on the CPU and
  raises on any other device; each counts its launches in `.launches`;
- the two loops that call them once per greedy iteration,
  `run_batch_fused` (v1, :187-266) and `run_batch_fused2` (v2, :413-468).
  They return (hp, stats) as engine_fused3.loop_plain does, with each
  lane's own iteration count.

Count-table layout is (G, 2D, S): row 2d+h holds haplotype h's count of
mer id d at each site. Scores are summed in f64 and rounded once to f32,
as loop_plain does (see engine_fused3.py), so the three engine generations
agree bit for bit; the Pallas kernels sum in f32 in Mosaic's order.
"""
from __future__ import annotations

import ctypes

import torch


def _range_from_seed_b(tot: torch.Tensor, cov: torch.Tensor,
                       min0: torch.Tensor, max0: torch.Tensor,
                       n_sites: torch.Tensor):
    """Batched closed-form update_available_methmer_range
    (blockjoin.c:3669-3691): min_i/max_i are the ends of the contiguous
    >= cov runs through the seeds; the site at max_i is then excluded by
    the query's exclusive bound. tot (G, S) f32; the rest (G,) int32.
    Returns (min_i, max_i), each (G,) int32."""
    G, S = tot.shape
    idx = torch.arange(S, device=tot.device, dtype=torch.int32)[None, :]
    ok = (tot >= cov[:, None].to(tot.dtype)) & (idx < n_sites[:, None])
    blocked_r = (~ok & (idx >= max0[:, None])) | (idx >= n_sites[:, None])
    fb = torch.where(blocked_r, idx, S).amin(dim=1)
    max_i = torch.where(fb > max0, fb - 1, max0)
    blocked_l = ~ok & (idx <= min0[:, None]) & (min0[:, None] >= 0)
    lnb = torch.where(blocked_l, idx, -1).amax(dim=1)
    min_i = torch.where(min0 < 0, min0,
                        torch.where(lnb == min0, min0,
                                    torch.where(lnb >= 0, lnb + 1, 0)))
    return min_i.to(torch.int32), max_i.to(torch.int32)


def _seed_count_table_b(ids: torch.Tensor, hp_init: torch.Tensor,
                        seed_ok: torch.Tensor, has_mmr: torch.Tensor,
                        D: int) -> torch.Tensor:
    """(G, 2D, S) f32 seed counts (insert_ref_reads_methmer_counts,
    blockjoin.c:3776-3810). ids (G, R, S) any int type, -1 = absent.

    One (G,2,R)x(G,R,S) product per mer id: the operands are 0/1 and the
    sums are integers below 2**24, so the f32 result is exact whatever the
    summation order."""
    seeded = seed_ok & has_mmr
    w = torch.stack([(hp_init == 0) & seeded, (hp_init == 1) & seeded],
                    dim=1).to(torch.float32)                  # (G, 2, R)
    rows = [torch.bmm(w, (ids == d).to(torch.float32)) for d in range(D)]
    return torch.cat(rows, dim=1)                             # (G, 2D, S)


def _candidates_b(hp: torch.Tensor, q_last: torch.Tensor,
                  n_reads: torch.Tensor, n_slots: torch.Tensor, nc_cap: int):
    """The first n_slots untagged rows >= q_last of each lane
    (blockjoin.c:4037-4051). hp (G, R) int32; the rest (G,). Returns
    (cand_read (G, nc_cap) int64, cand_valid (G, nc_cap) bool); an empty
    slot holds read row 0, as in the JAX loops."""
    G, R = hp.shape
    q = torch.arange(R, device=hp.device, dtype=torch.int64)[None, :]
    elig = ((hp != 0) & (hp != 1) & (q >= q_last[:, None].to(torch.int64))
            & (q < n_reads[:, None].to(torch.int64)))
    rank = torch.cumsum(elig.to(torch.int64), dim=1)
    sel = elig & (rank <= n_slots[:, None])
    slot = torch.where(sel, rank - 1, nc_cap)  # unselected -> spill slot
    cand = torch.full((G, nc_cap + 1), -1, dtype=torch.int64,
                      device=hp.device)
    cand.scatter_(1, slot, q.expand(G, R))
    cand = cand[:, :nc_cap]
    valid = cand >= 0
    return cand.clamp(min=0), valid


def _gather_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x (G, R, S) at rows (G, NC) int64 -> (G, NC, S), x's dtype."""
    G, NC = rows.shape
    return x.gather(1, rows[:, :, None].expand(G, NC, x.shape[2]))


# ---------------------------------------------------------------------------
# plain versions of the two Pallas kernels
# ---------------------------------------------------------------------------

def score_plain(cnt: torch.Tensor, sums: torch.Tensor, cids: torch.Tensor,
                min_i: torch.Tensor, max_i: torch.Tensor,
                D: int) -> torch.Tensor:
    """Scores of every candidate slot (the math of _score_kernel,
    engine_fused.py:87-120). cnt (G, 2D, S) f32; sums (G, 2, S) f32;
    cids (G, NC, S) int8|int32, -1 = absent; min_i, max_i (G,) int32.
    Returns (G, 8, NC) f32 rows [score0, score1, l_found0, l_found1,
    l_nonzero0, l_nonzero1, 0, 0]. Every slot is scored, empty ones too."""
    G, NC, S = cids.shape
    f32 = torch.float32
    ids = cids.to(torch.int64)
    covered = (ids >= 0) & (ids < D)
    idc = torch.where(covered, ids, 0)
    c0 = cnt[:, 0::2].gather(1, idc)                          # (G, NC, S)
    c1 = cnt[:, 1::2].gather(1, idc)
    site = torch.arange(S, device=cids.device, dtype=torch.int32)[None, :]
    in_range = (site >= min_i[:, None]) & (site < max_i[:, None])
    found = ((c0 + c1) > 0) & covered & in_range[:, None, :]
    t0 = sums[:, 0:1, :]
    t1 = sums[:, 1:2, :]
    f0 = found & (t0 > 0)
    f1 = found & (t1 > 0)
    r0 = torch.where(f0, c0 / torch.clamp(t0, min=1.0), 0.0)
    r1 = torch.where(f1, c1 / torch.clamp(t1, min=1.0), 0.0)
    out = torch.zeros((G, 8, NC), dtype=f32, device=cids.device)
    out[:, 0] = r0.sum(dim=2, dtype=torch.float64).to(f32)
    out[:, 1] = r1.sum(dim=2, dtype=torch.float64).to(f32)
    out[:, 2] = f0.sum(dim=2).to(f32)
    out[:, 3] = f1.sum(dim=2).to(f32)
    out[:, 4] = (r0 > 0).sum(dim=2).to(f32)
    out[:, 5] = (r1 > 0).sum(dim=2).to(f32)
    return out


def _commit_best(blk, cand_read, commit_ok, cids, active, cnt, hp, D: int):
    """Decide and commit (blockjoin.c:3645-3765): the best-separated
    committable candidate (ties -> the highest slot) of each active lane is
    tagged in hp and its mers added to cnt, both in place. blk (G, 8, NC)
    score rows; cand_read (G, NC); commit_ok, active bool. Returns
    (do_commit (G,) bool, tag (G,) int64, upd (G, S) bool)."""
    G, NC, S = cids.shape
    score0, score1 = blk[:, 0], blk[:, 1]
    l0 = (blk[:, 2] + blk[:, 4]).to(torch.int32)  # score_l double count
    l1 = (blk[:, 3] + blk[:, 5]).to(torch.int32)
    diff = (score0 - score1).abs()
    ok = commit_ok & ~((diff < 3.0) & ((l0 < 3) | (l1 < 3)))
    tag = torch.where(score0 > score1, 0, 1)
    eff = torch.where(ok, diff, -1.0)
    best = eff.amax(dim=1)
    slots = torch.arange(NC, device=cids.device)[None, :]
    best_k = torch.where(ok & (eff == best[:, None]), slots, -1).amax(dim=1)
    do_commit = (best >= 0) & active
    bk = best_k.clamp(min=0)
    rid = cand_read.gather(1, bk[:, None])[:, 0].to(torch.int64)
    t = tag.gather(1, bk[:, None])[:, 0]
    rids = cids[torch.arange(G, device=cids.device), bk].to(torch.int64)
    upd = (rids >= 0) & (rids < D) & do_commit[:, None]
    row = 2 * torch.where(upd, rids, 0) + t[:, None]
    cnt.scatter_add_(1, row[:, None, :], upd[:, None, :].to(cnt.dtype))
    rid = rid[:, None]  # a lane that does not commit writes its tag back
    hp.scatter_(1, rid, torch.where(do_commit[:, None],
                                    t[:, None].to(hp.dtype), hp.gather(1, rid)))
    return do_commit, t, upd


def score_commit_plain(scal: torch.Tensor, cmeta: torch.Tensor,
                       cids: torch.Tensor, cnt: torch.Tensor,
                       hp: torch.Tensor, D: int):
    """One greedy iteration of every lane (the math of
    _score_commit_kernel, engine_fused.py:289-373): the valid-site range
    from the count table, scoring, the gate and the best pick, the commit
    into cnt and hp in place (the Pallas call aliases both).
    scal (G, 8) int32 [min0, max0, cov, n_sites, active, 0, 0, 0];
    cmeta (G, 4, NC) int32 [cand_read, cand_valid, has_mmr_c, 0];
    cids (G, NC, S) int8|int32; cnt (G, 2D, S) f32; hp (G, R) int32.
    Returns (cnt, hp, flags (G, 8) int32, every column do_commit)."""
    G, NC, S = cids.shape
    c4 = cnt.view(G, D, 2, S)
    sums = torch.stack([c4[:, :, 0].sum(dim=1), c4[:, :, 1].sum(dim=1)],
                       dim=1)                      # integer-valued, exact
    min_i, max_i = _range_from_seed_b(sums.sum(dim=1), scal[:, 2], scal[:, 0],
                                      scal[:, 1], scal[:, 3])
    blk = score_plain(cnt, sums, cids, min_i, max_i, D)
    commit_ok = (cmeta[:, 1] > 0) & (cmeta[:, 2] > 0)
    do_commit, _, _ = _commit_best(blk, cmeta[:, 0], commit_ok, cids,
                                   scal[:, 4] > 0, cnt, hp, D)
    flags = do_commit.to(torch.int32)[:, None].expand(G, 8).contiguous()
    return cnt, hp, flags


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, t, dtypes, shape, dev):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != dev:
        raise ValueError(f"all inputs must be on {dev}, got {t.device}")


def _launch(dev, fn_name: str, *args):
    """Call a launcher of the kernel library on `dev`'s current stream;
    raises with CUDA's message when the launch is refused."""
    from ._build import get_lib
    lib = get_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, fn_name)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: "
                           f"{lib.pomfret_error_string(rc).decode()} ({rc})")


_IDS = (torch.int8, torch.int32)

# placement bits of the kernels' plans (csrc/common.cuh Place): the
# per-lane buffers a block keeps in shared memory
SUMS_SHARED, TABLE_SHARED, ROWS_SHARED, SLOTS_SHARED = 1, 2, 4, 8
_PLANS: dict = {}


def _plan(dev, fn_name: str, *shape):
    """(placement bits, dynamic shared bytes of a block, bytes of one
    lane's slot arrays) of a kernel at this shape on `dev`, from the kernel
    library's own layout (`fn_name`: pomfret_loop_plan or
    pomfret_step_plan, `shape` its integer arguments)."""
    key = (dev.index, fn_name) + shape
    if key not in _PLANS:
        from ._build import get_lib
        lib = get_lib()
        out = [ctypes.c_int() for _ in range(3)]
        with torch.cuda.device(dev):
            rc = getattr(lib, fn_name)(*shape,
                                       *(ctypes.byref(o) for o in out))
        if rc != 0:
            raise RuntimeError(f"{fn_name} failed: "
                               f"{lib.pomfret_error_string(rc).decode()} "
                               f"({rc}) at {shape}")
        _PLANS[key] = tuple(o.value for o in out)
    return _PLANS[key]


def _count_placement(counts: dict, place: int, everything: int, G: int):
    """Adds G lanes to `counts` by placement: "shared" (every buffer in
    `everything` shared), "mixed" or "global"; and by where the slot
    arrays live, "slots_shared" or "slots_global"."""
    counts["shared" if place == everything else "mixed"
           if place & everything else "global"] += G
    counts["slots_shared" if place & SLOTS_SHARED else "slots_global"] += G


def _placements():
    return {k: 0 for k in ("shared", "mixed", "global", "slots_shared",
                           "slots_global")}


def _scratch(place: int, bit: int, nbytes: int, dev):
    """A per-lane global buffer of `nbytes` in all for a buffer whose
    placement bit is clear, else None (it lives in shared memory)."""
    if place & bit:
        return None
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def score_candidates_batch(cnt, sums, cids, min_i, max_i, *, D: int):
    """(G, 8, NC) score rows (see score_plain). CUDA tensors: launches
    csrc/score_kernel.cu on the current stream, counted in
    `score_candidates_batch.launches`, its lanes by where their buffers
    live in `.placements` (see _count_placement: the slots' sums, the
    sums and the table slice in shared memory, or some in global memory).
    CPU tensors: score_plain. Any other device raises; so does a build or
    launch failure."""
    dev = cids.device
    if dev.type == "cpu":
        return score_plain(cnt, sums, cids, min_i, max_i, D)
    if dev.type != "cuda":
        raise ValueError(f"score_candidates_batch: unsupported device {dev}")
    G, NC, S = cids.shape
    _check("cids", cids, _IDS, (G, NC, S), dev)
    _check("cnt", cnt, (torch.float32,), (G, 2 * D, S), dev)
    _check("sums", sums, (torch.float32,), (G, 2, S), dev)
    _check("min_i", min_i, (torch.int32,), (G,), dev)
    _check("max_i", max_i, (torch.int32,), (G,), dev)
    allowed = SLOTS_SHARED
    # bulk copies of the table and sums rows need 16-byte aligned rows
    if S % 4 == 0 and cnt.data_ptr() % 16 == 0 and sums.data_ptr() % 16 == 0:
        allowed |= SUMS_SHARED | TABLE_SHARED
    place, _, slot_bytes = _plan(dev, "pomfret_step_plan", NC, S, D, allowed)
    slots = _scratch(place, SLOTS_SHARED, G * slot_bytes, dev)
    out = torch.empty((G, 8, NC), dtype=torch.float32, device=dev)
    _launch(dev, "pomfret_score_launch", cids.element_size(), cnt.data_ptr(),
            sums.data_ptr(), cids.data_ptr(), min_i.data_ptr(),
            max_i.data_ptr(), out.data_ptr(), _ptr(slots), G, NC, S, D,
            place)
    score_candidates_batch.launches += 1
    _count_placement(score_candidates_batch.placements, place,
                     SLOTS_SHARED | SUMS_SHARED | TABLE_SHARED, G)
    return out


score_candidates_batch.launches = 0
score_candidates_batch.placements = _placements()


def step_fused2(scal, cmeta, cids, cnt, hp, *, D: int):
    """One greedy iteration of every lane (see score_commit_plain); cnt
    and hp are updated in place and returned with the flags. CUDA tensors:
    launches csrc/score_commit_kernel.cu on the current stream, counted in
    `step_fused2.launches`, its lanes by where their buffers live in
    `.placements` (see _count_placement: the slots' sums, the sums and the
    count table in shared memory, or some in global memory). CPU tensors:
    score_commit_plain. Any other device raises; so does a build or launch
    failure."""
    dev = cids.device
    if dev.type == "cpu":
        return score_commit_plain(scal, cmeta, cids, cnt, hp, D)
    if dev.type != "cuda":
        raise ValueError(f"step_fused2: unsupported device {dev}")
    G, NC, S = cids.shape
    R = hp.shape[1]
    _check("cids", cids, _IDS, (G, NC, S), dev)
    _check("scal", scal, (torch.int32,), (G, 8), dev)
    _check("cmeta", cmeta, (torch.int32,), (G, 4, NC), dev)
    _check("cnt", cnt, (torch.float32,), (G, 2 * D, S), dev)
    _check("hp", hp, (torch.int32,), (G, R), dev)
    allowed = SLOTS_SHARED | SUMS_SHARED
    # one bulk copy of each lane's table needs 16-byte aligned tables
    if (D * S) % 2 == 0 and cnt.data_ptr() % 16 == 0:
        allowed |= TABLE_SHARED
    place, _, slot_bytes = _plan(dev, "pomfret_step_plan", NC, S, D, allowed)
    sums = _scratch(place, SUMS_SHARED, G * 2 * S * 4, dev)
    slots = _scratch(place, SLOTS_SHARED, G * slot_bytes, dev)
    flags = torch.empty((G, 8), dtype=torch.int32, device=dev)
    _launch(dev, "pomfret_score_commit_launch", cids.element_size(),
            scal.data_ptr(), cmeta.data_ptr(), cids.data_ptr(),
            cnt.data_ptr(), hp.data_ptr(), flags.data_ptr(), _ptr(sums),
            _ptr(slots), G, NC, S, D, R, place)
    step_fused2.launches += 1
    _count_placement(step_fused2.placements, place,
                     SLOTS_SHARED | SUMS_SHARED | TABLE_SHARED, G)
    return cnt, hp, flags


step_fused2.launches = 0
step_fused2.placements = _placements()


# ---------------------------------------------------------------------------
# the two loops
# ---------------------------------------------------------------------------

def _stats(it, q_last, failed, ncom):
    z = torch.zeros_like(it)
    return torch.stack([it, q_last, failed, ncom, z, z, z, z],
                       dim=1).to(torch.int32)


def run_batch_fused(ids, has_mmr, hp_init, seed_ok, n_reads, n_sites,
                    q_break, min0, max0, cov, n_cand, max_iters,
                    D: int, nc_cap: int, score=score_candidates_batch):
    """v1 greedy loop (run_batch_fused_core): per iteration, the range from
    the kept sums, the candidates and their mer rows (plain torch), the
    scores (`score`: the kernel wrapper, or score_plain), then the
    decision and commit in plain torch. Arguments as
    engine_fused3.loop_plain's; returns (hp, stats), stats rows
    [iterations, q_last, failed, commits, 0, 0, 0, 0]. Every update is
    gated on the lane being active, so a converged lane changes nothing;
    the loop ends when no lane is active (one device sync per iteration)."""
    G, R, S = ids.shape
    i32 = torch.int32
    cnt = _seed_count_table_b(ids, hp_init, seed_ok, has_mmr, D).contiguous()
    sums = cnt.view(G, D, 2, S).sum(dim=1)                 # (G, 2, S) exact
    hp = hp_init.to(i32).clone()
    q_last = torch.zeros(G, dtype=i32, device=ids.device)
    failed, it, ncom = (torch.zeros_like(q_last) for _ in range(3))
    n_slots = torch.clamp(n_cand.to(torch.int64), max=nc_cap)
    while True:
        active = (q_last < q_break) & (failed <= 10) & (it < max_iters)
        if not bool(active.any()):
            break
        min_i, max_i = _range_from_seed_b(sums.sum(dim=1), cov, min0, max0,
                                          n_sites)
        cand_read, cand_valid = _candidates_b(hp, q_last, n_reads, n_slots,
                                              nc_cap)
        cids = _gather_rows(ids, cand_read)
        blk = score(cnt, sums, cids, min_i, max_i, D=D)
        commit_ok = cand_valid & has_mmr.gather(1, cand_read)
        do_commit, t, upd = _commit_best(blk, cand_read, commit_ok, cids,
                                         active, cnt, hp, D)
        sums.scatter_add_(1, t[:, None, None].expand(G, 1, S),
                          upd[:, None, :].to(sums.dtype))
        fail = active & ~do_commit
        failed = torch.where(do_commit, 0, failed + fail.to(i32))
        q_last = torch.where(fail, q_last + n_cand, q_last)
        ncom += do_commit.to(i32)
        it += active.to(i32)
    return hp, _stats(it, q_last, failed, ncom)


def run_batch_fused2(ids, has_mmr, hp_init, seed_ok, n_reads, n_sites,
                     q_break, min0, max0, cov, n_cand, max_iters,
                     D: int, nc_cap: int, step=step_fused2):
    """v2 greedy loop (run_batch_fused2_core): per iteration, the
    candidates and their mer rows (plain torch), then one `step` (the
    kernel wrapper, or score_commit_plain) that recomputes the range from
    the count table, scores, picks and commits in place. Arguments and
    result as run_batch_fused's."""
    G, R, S = ids.shape
    i32 = torch.int32
    cnt = _seed_count_table_b(ids, hp_init, seed_ok, has_mmr, D).contiguous()
    hp = hp_init.to(i32).clone()
    q_last = torch.zeros(G, dtype=i32, device=ids.device)
    failed, it, ncom = (torch.zeros_like(q_last) for _ in range(3))
    n_slots = torch.clamp(n_cand.to(torch.int64), max=nc_cap)
    zero = torch.zeros_like(q_last)
    while True:
        active = (q_last < q_break) & (failed <= 10) & (it < max_iters)
        if not bool(active.any()):
            break
        cand_read, cand_valid = _candidates_b(hp, q_last, n_reads, n_slots,
                                              nc_cap)
        cids = _gather_rows(ids, cand_read)
        scal = torch.stack([min0, max0, cov, n_sites, active.to(i32), zero,
                            zero, zero], dim=1).to(i32)
        cmeta = torch.stack([cand_read.to(i32), cand_valid.to(i32),
                             has_mmr.gather(1, cand_read).to(i32),
                             torch.zeros_like(cand_valid, dtype=i32)], dim=1)
        cnt, hp, flags = step(scal, cmeta, cids, cnt, hp, D=D)
        do_commit = flags[:, 0] > 0
        fail = active & ~do_commit
        failed = torch.where(do_commit, 0, failed + fail.to(i32))
        q_last = torch.where(fail, q_last + n_cand, q_last)
        ncom += do_commit.to(i32)
        it += active.to(i32)
    return hp, _stats(it, q_last, failed, ncom)
