"""Batched permutation voting through the port's pipeline, against the JAX
package's host engine, on the fixture of tests/test_permutation.py::
test_batched_permutation_pipeline_matches_host: `methphase --engine torch
--n-permutations N` rides one grouped dispatch holding N lanes per (gap,
direction), and its .mp.gtf and .mp.vcf are byte-identical to
`pomfret_tpu methphase --engine host`'s, which draws the same per-gap
srand48 streams. Tolerance: exact.
"""
import pytest
import torch

from pomfret_tpu.cli import main as tpu_main
from pomfret_tpu_torch import testing as T
from pomfret_tpu_torch.cli import main as port_main
from pomfret_tpu_torch.parallel import batch as tb
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

torch.set_num_threads(1)


@pytest.mark.parametrize("n_perm", [3, 11])
def test_batched_permutation_pipeline_matches_host(tmp_path, n_perm):
    bam, vcf, _ = T.make_multi_block_scenario(
        str(tmp_path), n_blocks=3,
        cfg=T.SynthConfig(noise=0.06, nocall=0.06, seed=5))
    args = ["-c", "50", "--vcf", vcf, "--n-permutations", str(n_perm), bam]
    p_h = str(tmp_path / "host")
    assert tpu_main(["methphase", "-o", p_h, "--engine", "host", *args]) == 0
    before = tb.DISPATCH_STATS["n_dispatches"]
    p_t = str(tmp_path / "torch")
    assert port_main(["methphase", "-o", p_t, "--engine", "torch",
                      *args]) == 0
    assert tb.DISPATCH_STATS["n_dispatches"] == before + 1, \
        "permutation voting did not ride the single grouped dispatch"
    assert tb.DISPATCH_STATS["lanes_last"] >= 2 * 2 * n_perm
    for ext in (".mp.gtf", ".mp.vcf"):
        with open(p_h + ext, "rb") as f1, open(p_t + ext, "rb") as f2:
            a = f1.read()
            assert a == f2.read(), ext
            assert a, ext
