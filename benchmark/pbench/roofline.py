"""The table of peaks and the loop kernel's byte count.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB of HBM3 at 3.35 TB/s),
stated at its 700 W limit; the run records the card's own limit beside
its numbers.

The loop kernel (pomfret_tpu_torch/kernels/csrc/loop_kernel.cu, launched
by kernels/engine_fused3.run_batch_fused3) is bound by memory: it reads
each lane's methmer ids and per-read rows and writes each read's tag. The
count is taken from a launch's inputs, each byte once: every lane's valid
ids region (n_reads x n_sites cells), its per-read rows (has_mmr, seed_ok,
hp_init) over its n_reads, and what the launch returns (the tags of its
n_reads, the per-lane stats). The kernel reads ids again as its greedy
loop goes, so the true traffic is larger and the share a lower bound of
the time the bytes would allow.
"""
from __future__ import annotations

PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                                   "power_limit_w": 700.0}}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"


def hbm_bytes_per_s(kind: str) -> float:
    return PEAKS.get(kind, PEAKS[DEFAULT_PEAK])["hbm_bytes_per_s"]


class LoopBytes:
    """Wraps run_batch_fused3 from outside: each call's bytes counted
    (on the device, read once the window has closed) beside the launch."""

    def __init__(self, fn):
        self.fn = fn
        self.counts = []

    def __call__(self, ids, has_mmr, hp_init, seed_ok, n_reads, n_sites,
                 *args, **kw):
        out = self.fn(ids, has_mmr, hp_init, seed_ok, n_reads, n_sites,
                      *args, **kw)
        hp, stats = out
        nr, ns = n_reads.long(), n_sites.long()
        per_read = (has_mmr.element_size() + seed_ok.element_size()
                    + hp_init.element_size() + hp.element_size())
        self.counts.append(((nr * ns).sum() * ids.element_size()
                            + nr.sum() * per_read
                            + stats.numel() * stats.element_size()))
        return out

    def total_bytes(self) -> int:
        return int(sum(int(c) for c in self.counts))
