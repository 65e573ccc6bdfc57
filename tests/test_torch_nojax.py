"""The port never loads jax.

Checked in a subprocess: tests/conftest.py imports jax for the whole test
session, so sys.modules here always holds it.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import os, sys
import pomfret_tpu_torch.cli as cli
import pomfret_tpu_torch.kernels._build
import pomfret_tpu_torch.kernels.engine_fused
import pomfret_tpu_torch.kernels.engine_fused3
import pomfret_tpu_torch.parallel.batch as batch
import pomfret_tpu_torch.pipeline
from pomfret_tpu.testing import make_two_block_scenario

d = sys.argv[1]
bam, vcf, truth = make_two_block_scenario(d)
rc = cli.main(["methphase", "-o", os.path.join(d, "out"), "-c", "50",
               "--engine", "torch", "--vcf", vcf, bam])
assert rc == 0, rc
assert batch.DISPATCH_STATS["n_dispatches"] > 0
assert os.path.getsize(os.path.join(d, "out.mp.gtf")) > 0
os.environ["POMFRET_FUSED_GEN"] = "2"
n0 = batch.DISPATCH_STATS["n_dispatches"]
rc = cli.main(["report", "-o", os.path.join(d, "rep"), "-c", "50",
               "--chunk-size", "40000", "--chunk-stride", "30000",
               "--engine", "torch", "--vcf", vcf, bam])
assert rc == 0, rc
assert batch.DISPATCH_STATS["n_dispatches"] > n0
assert os.path.getsize(os.path.join(d, "rep.report.tsv")) > 0
print("jax" in sys.modules, "pomfret_tpu.kernels.engine_jax" in sys.modules)
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    # report prints its totals first; the last line is the child's answer
    assert res.stdout.splitlines()[-1].split() == ["False", "False"], \
        res.stdout
