"""The hand-written CUDA loop kernel vs its plain PyTorch version, on the
card. Marked `cuda`: without a GPU every test here skips (the same checks
run as phase 3 of chip_smoke.py). Tolerance: exact — hp by array_equal and
all of stats, including each lane's own iteration count."""
import numpy as np
import pytest
import torch

from pomfret_tpu_torch.kernels import engine_fused3 as tf3
from pomfret_tpu_torch.parallel import batch as tb
from pomfret_tpu_torch.testing import (N_FUZZ_CARD, bench_gap_batch,
                                       fuzz_args, near_tie_args)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both(args, D, nc_cap, device):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args]
    n0 = tf3.run_batch_fused3.launches
    hk, sk = tf3.run_batch_fused3(*t, D=D, nc_cap=nc_cap)
    assert tf3.run_batch_fused3.launches == n0 + 1
    hpl, spl = tf3.loop_plain(*t, D=D, nc_cap=nc_cap)
    torch.cuda.synchronize()
    assert torch.equal(hk, hpl)
    assert torch.equal(sk, spl)
    return hk.cpu().numpy(), sk.cpu().numpy()


@pytest.mark.parametrize("trial", range(N_FUZZ_CARD))
def test_kernel_matches_plain_fuzz(cuda, trial):
    args, D, nc_cap = fuzz_args(trial)
    _both(args, D, nc_cap, cuda)


def test_kernel_matches_plain_near_tie(cuda):
    args, D, nc_cap, layout = near_tie_args()
    hp, _ = _both(args, D, nc_cap, cuda)
    g, _, row = layout["gate"]
    assert hp[g, row] == 0       # the exact sum 3.0 passes the gate


def test_kernel_matches_plain_bench_shape(cuda):
    batch, _ = bench_gap_batch(G=64)
    hp, st = _both(tb.batch_args(batch, 2 * batch.shape3[1] + 64), batch.D,
                   batch.nc_cap, cuda)
    assert (hp <= 1).sum() > 0 and (st[:, 3] > 0).all()


def test_dispatch_engines_agree(cuda):
    batch, _ = bench_gap_batch(G=32)
    hk = tb.run_gap_batch(batch, engine="cuda", device=cuda)
    hpl = tb.run_gap_batch(batch, engine="torch", device=cuda)
    assert np.array_equal(hk, hpl)
