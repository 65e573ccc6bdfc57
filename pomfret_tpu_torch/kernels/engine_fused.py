"""Batched helpers of the greedy loop, in plain PyTorch.

Counterpart of the XLA (not Pallas) pieces of
pomfret_tpu/kernels/engine_fused.py: the closed-form valid-site range
(_range_from_seed_b, :156-171) and the seed count table
(_seed_count_table_b, :174-184). Count-table layout is (G, 2D, S): row
2d+h holds haplotype h's count of mer id d at each site.
"""
from __future__ import annotations

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
