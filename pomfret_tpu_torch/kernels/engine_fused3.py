"""The whole greedy loop of a batch of lanes: CUDA kernel and plain version.

Counterpart of pomfret_tpu/kernels/engine_fused3.py. A lane is one
(gap, direction); every argument carries a leading G (lane) axis:

    ids (G,R,S) int8|int32 mer ids, -1 = absent; has_mmr, seed_ok (G,R)
    bool; hp_init (G,R) int32; n_reads, n_sites, q_break, min0, max0, cov,
    n_cand, max_iters (G,) int32; D (mer-id capacity) and nc_cap
    (candidate-slot capacity) are ints.

Both functions return (hp (G,R) int32, stats (G,8) int32) with stats rows
[iterations, q_last, failed, commits, 0, 0, 0, 0]. The iteration count is
the lane's own (the Pallas kernel reported its lane block's).

- `run_batch_fused3` is the wrapper of the hand-written kernel
  (csrc/loop_kernel.cu), which also builds the seed count table. It
  launches the kernel for CUDA tensors and runs `loop_plain` only for
  tensors on the CPU.
- `loop_plain` is the same loop in plain PyTorch, batched by hand as
  engine_fused.run_batch_fused_core batches run_direction_core
  (engine_jax.py:340-444). Lanes leave the loop one by one, as vmap's
  while-loop rule freezes them: a lane that has converged changes nothing
  while the others iterate.

Scores are summed in f64 and rounded once to f32: the sum is then exact
(see loop_kernel.cu) and the kernel, whatever its reduction order, agrees
with this version bit for bit.
"""
from __future__ import annotations

import torch

from .engine_fused import (ROWS_SHARED, SLOTS_SHARED, SUMS_SHARED,
                           TABLE_SHARED, _candidates_b, _check,
                           _count_placement, _launch, _placements, _plan,
                           _ptr, _range_from_seed_b, _scratch,
                           _seed_count_table_b, _stats)


def loop_plain(ids, has_mmr, hp_init, seed_ok, n_reads, n_sites, q_break,
               min0, max0, cov, n_cand, max_iters, D: int, nc_cap: int,
               work: dict | None = None, table_out=None):
    """Plain PyTorch greedy loop (see the module docstring); runs on the
    device its tensors are on. Each iteration works on the lanes still
    active and writes only theirs back, so a lane that has converged keeps
    its state while the others iterate.

    `work`, if given, is filled with what the loop kernel must do on these
    inputs: "slot_sites", the valid candidate slots scored times the sites
    of their lane's range [lo, hi), summed over lanes and iterations;
    "mer_slot_sites", those (slot, site) pairs where the slot's read holds
    a mer id in [0, D), the ones that take a ratio; and
    "id_cells", the ids cells those slots and the commits read, each cell
    once (per read row, the hull of its ranges, or its whole n_sites once
    committed). `table_out`, if given, a (G, 2D, S) f32 tensor, receives
    the final count table."""
    G, R, S = ids.shape
    dev = ids.device
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    cnt = _seed_count_table_b(ids, hp_init, seed_ok, has_mmr, D)
    hp = hp_init.to(i32).clone()
    q_last = torch.zeros(G, dtype=i32, device=dev)
    failed = torch.zeros_like(q_last)
    it = torch.zeros_like(q_last)
    ncom = torch.zeros_like(q_last)
    slots = torch.arange(nc_cap, device=dev, dtype=i64)[None, :]
    site = torch.arange(S, device=dev, dtype=i32)[None, :]
    n_slots = torch.clamp(n_cand.to(i64), max=nc_cap)
    if work is not None:
        work["slot_sites"] = work["mer_slot_sites"] = 0
        row_lo = torch.full((G * R,), S, dtype=i64, device=dev)
        row_hi = torch.zeros(G * R, dtype=i64, device=dev)
    while True:
        active = (q_last < q_break) & (failed <= 10) & (it < max_iters)
        L = torch.nonzero(active).squeeze(1)         # the active lanes
        n = L.numel()
        if n == 0:
            break
        ar = torch.arange(n, device=dev)
        c = cnt[L]                                   # (n, 2D, S)
        c4 = c.view(n, D, 2, S)
        s0 = c4[:, :, 0].sum(dim=1)                  # integer-valued, exact
        s1 = c4[:, :, 1].sum(dim=1)
        min_i, max_i = _range_from_seed_b(s0 + s1, cov[L], min0[L], max0[L],
                                          n_sites[L])

        # --- candidates: first n_cand untagged rows >= q_last ---
        h = hp[L]
        crow, valid = _candidates_b(h, q_last[L], n_reads[L], n_slots[L],
                                    nc_cap)

        # --- scoring (blockjoin.c:3487-3656) ---
        cids = ids[L[:, None], crow].to(i64)                  # (n, NC, S)
        covered = (cids >= 0) & (cids < D) & valid[:, :, None]
        idc = torch.where(covered, cids, 0)
        c0 = c[:, 0::2].gather(1, idc)
        c1 = c[:, 1::2].gather(1, idc)
        in_range = (site >= min_i[:, None]) & (site < max_i[:, None])
        found = ((c0 + c1) > 0) & covered & in_range[:, None, :]
        t0 = s0[:, None, :]
        t1 = s1[:, None, :]
        con0 = found & (t0 > 0)
        con1 = found & (t1 > 0)
        r0 = torch.where(con0, c0 / torch.clamp(t0, min=1.0), 0.0)
        r1 = torch.where(con1, c1 / torch.clamp(t1, min=1.0), 0.0)
        score0 = r0.sum(dim=2, dtype=torch.float64).to(f32)
        score1 = r1.sum(dim=2, dtype=torch.float64).to(f32)
        l0 = con0.sum(dim=2) + (r0 > 0).sum(dim=2)   # score_l double count
        l1 = con1.sum(dim=2) + (r1 > 0).sum(dim=2)

        # --- decide + commit best (blockjoin.c:3645-3765) ---
        diff = (score0 - score1).abs()
        tag_ok = ~((diff < 3.0) & ((l0 < 3) | (l1 < 3)))
        tag = torch.where(score0 > score1, 0, 1).to(i32)
        commit_ok = tag_ok & valid & has_mmr[L].gather(1, crow)
        eff = torch.where(commit_ok, diff, -1.0)
        best = eff.amax(dim=1)
        best_k = torch.where(commit_ok & (eff == best[:, None]), slots,
                             -1).amax(dim=1)
        do_commit = best >= 0
        bk = best_k.clamp(min=0)
        rid = crow.gather(1, bk[:, None])[:, 0]
        t = tag.gather(1, bk[:, None])[:, 0]
        rids = cids[ar, bk]                                    # (n, S)
        upd = (rids >= 0) & (rids < D) & do_commit[:, None]
        row = 2 * torch.where(upd, rids, 0) + t[:, None].to(i64)
        c.scatter_add_(1, row[:, None, :], upd[:, None, :].to(f32))
        cnt[L] = c
        h[ar[do_commit], rid[do_commit]] = t[do_commit]
        hp[L] = h
        if work is not None:  # the kernel's lo, hi (loop_kernel.cu)
            lo = min_i.clamp(min=0).to(i64)
            hi = max_i.clamp(max=S).to(i64)
            span = (hi - lo).clamp(min=0)
            work["slot_sites"] += int((valid.sum(dim=1) * span).sum())
            work["mer_slot_sites"] += int((covered & in_range[:, None, :])
                                          .sum())
            flat = L[:, None] * R + crow
            m = valid & (span > 0)[:, None]
            row_lo.scatter_reduce_(0, flat[m], lo[:, None].expand_as(flat)[m],
                                   "amin")
            row_hi.scatter_reduce_(0, flat[m], hi[:, None].expand_as(flat)[m],
                                   "amax")
            won = L[do_commit] * R + rid[do_commit]
            row_lo[won] = 0
            row_hi[won] = torch.maximum(row_hi[won],
                                        n_sites[L[do_commit]].to(i64))

        # --- failure bookkeeping (blockjoin.c:4046-4070) ---
        failed[L] = torch.where(do_commit, 0, failed[L] + 1)
        q_last[L] = torch.where(do_commit, q_last[L], q_last[L] + n_cand[L])
        ncom[L] += do_commit.to(i32)
        it[L] += 1
    if work is not None:
        work["id_cells"] = int((row_hi - row_lo).clamp(min=0).sum())
    if table_out is not None:
        table_out.copy_(cnt)
    return hp, _stats(it, q_last, failed, ncom)


def run_batch_fused3(ids, has_mmr, hp_init, seed_ok, n_reads, n_sites,
                     q_break, min0, max0, cov, n_cand, max_iters,
                     D: int, nc_cap: int, *, phase_cycles=None,
                     table_out=None):
    """Whole greedy loop for every lane; returns (hp, stats).

    CUDA tensors: launches loop_kernel.cu once on the current stream (the
    kernel seeds its count table itself); the launch is counted in
    `run_batch_fused3.launches`, its lanes by where their buffers live in
    `.placements` ("shared": slot arrays, table, sums and candidate rows in
    shared memory; "mixed": some in global memory; "global": none shared;
    and "slots_shared" or "slots_global" by where the slot arrays live,
    global past ~950 row slots) and by
    how candidate rows arrive in `.row_routes` ("bulk": cp.async.bulk,
    "loads": ordinary loads, when a row's bytes are not a multiple of 16;
    "global": rows read in place). CPU tensors: loop_plain. Any other
    device raises. A build or launch failure raises; nothing falls back.

    Keyword-only outputs, off by default: phase_cycles, a (G, 6) int64
    CUDA tensor the kernel fills with each lane's clock cycles by phase
    (prologue, range, candidates, scoring, decide, commit; the CPU path has
    no clock and refuses it); table_out, a (G, 2D, S) f32 tensor that
    receives the final count table (the seed table at max_iters 0)."""
    dev = ids.device
    if dev.type == "cpu" and phase_cycles is not None:
        raise ValueError("phase_cycles is measured by the CUDA kernel only")
    if dev.type == "cpu":
        return loop_plain(ids, has_mmr, hp_init, seed_ok, n_reads, n_sites,
                          q_break, min0, max0, cov, n_cand, max_iters, D,
                          nc_cap, table_out=table_out)
    if dev.type != "cuda":
        raise ValueError(f"run_batch_fused3: unsupported device {dev}")
    G, R, S = ids.shape
    _check("ids", ids, (torch.int8, torch.int32), (G, R, S), dev)
    for name, t in (("has_mmr", has_mmr), ("seed_ok", seed_ok)):
        _check(name, t, (torch.bool,), (G, R), dev)
    _check("hp_init", hp_init, (torch.int32,), (G, R), dev)
    scal = torch.stack([min0, max0, cov, n_sites, n_reads, q_break, n_cand,
                        max_iters], dim=1)
    _check("scal", scal, (torch.int32,), (G, 8), dev)
    if phase_cycles is not None:
        _check("phase_cycles", phase_cycles, (torch.int64,), (G, 6), dev)
    if table_out is not None:
        _check("table_out", table_out, (torch.float32,), (G, 2 * D, S), dev)

    ib = ids.element_size()
    place, _, slot_bytes = _plan(dev, "pomfret_loop_plan", ib, R, S, D,
                                 nc_cap)
    cnt = _scratch(place, TABLE_SHARED, G * 2 * D * S * 4, dev)
    sums = _scratch(place, SUMS_SHARED, G * 2 * S * 4, dev)
    slots = _scratch(place, SLOTS_SHARED, G * slot_bytes, dev)
    rows_shared = bool(place & ROWS_SHARED)
    # a bulk copy moves 16-byte multiples between 16-byte aligned addresses
    bulk = rows_shared and (S * ib) % 16 == 0 and ids.data_ptr() % 16 == 0
    hp = torch.empty((G, R), dtype=torch.int32, device=dev)
    stats = torch.empty((G, 8), dtype=torch.int32, device=dev)
    _launch(dev, "pomfret_loop_launch", ib, ids.data_ptr(),
            has_mmr.data_ptr(), seed_ok.data_ptr(), scal.data_ptr(),
            hp_init.data_ptr(), _ptr(cnt), _ptr(sums), _ptr(slots),
            hp.data_ptr(), stats.data_ptr(), _ptr(table_out),
            _ptr(phase_cycles), G, R, S, D, nc_cap, place, int(bulk))
    run_batch_fused3.launches += 1
    _count_placement(run_batch_fused3.placements, place,
                     SLOTS_SHARED | SUMS_SHARED | TABLE_SHARED | ROWS_SHARED,
                     G)
    run_batch_fused3.row_routes[
        "bulk" if bulk else "loads" if rows_shared else "global"] += G
    return hp, stats


run_batch_fused3.launches = 0
run_batch_fused3.placements = _placements()
run_batch_fused3.row_routes = {"bulk": 0, "loads": 0, "global": 0}
