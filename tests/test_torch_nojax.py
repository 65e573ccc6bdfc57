"""The port never loads jax, nor anything of the JAX package.

- In a subprocess (tests/conftest.py imports jax for the whole test
  session, so sys.modules here always holds it), every subcommand of
  pomfret_tpu_torch.cli runs on data from the port's own testing.py:
  methphase, report, methstat, varhaptag, bam2cram and warmup, and the
  probes entry point runs one probe on the CPU. After them
  sys.modules holds no jax and no pomfret_tpu or pomfret_tpu.* module.
- Statically, no .py under pomfret_tpu_torch/, nor chip_smoke.py, imports
  pomfret_tpu, jax, bench.py or the root tools/ scripts in any form
  (import, from-import, importlib.import_module or __import__ of a name in
  them).
"""
import ast
import glob
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
import pomfret_tpu_torch.tools.accuracy_scale
import pomfret_tpu_torch.tools.probes as probes
from pomfret_tpu_torch.kernels.engine_torch import run_gap
from pomfret_tpu_torch.testing import SynthConfig, make_two_block_scenario

d = sys.argv[1]
bam, vcf, truth = make_two_block_scenario(d)
out = lambda name: os.path.join(d, name)


def run(*args):
    rc = cli.main(list(args))
    assert rc == 0, (args, rc)


run("methphase", "-o", out("out"), "-c", "50", "--engine", "torch",
    "--vcf", vcf, bam)
assert batch.DISPATCH_STATS["n_dispatches"] > 0
assert os.path.getsize(out("out.mp.gtf")) > 0
os.environ["POMFRET_FUSED_GEN"] = "2"
n0 = batch.DISPATCH_STATS["n_dispatches"]
run("report", "-o", out("rep"), "-c", "50", "--chunk-size", "40000",
    "--chunk-stride", "30000", "--engine", "torch", "--vcf", vcf, bam)
assert batch.DISPATCH_STATS["n_dispatches"] > n0
assert os.path.getsize(out("rep.report.tsv")) > 0
run("methstat", "-o", out("ms"), "-c", "50", "--vcf", vcf, bam)
assert os.path.getsize(out("ms.methstat.tsv")) > 0
run("varhaptag", "-o", out("vh.bam"), vcf, bam)
assert os.path.getsize(out("vh.bam.varhaptag.tsv")) > 0
assert os.path.getsize(out("vh.bam.bai")) > 0
small = os.path.join(d, "small")
os.makedirs(small)
sbam, _, _ = make_two_block_scenario(small,
                                     cfg=SynthConfig(read_stagger=2800))
run("bam2cram", sbam, out("x.cram"), "--no-ref")
assert os.path.getsize(out("x.cram.crai")) > 0
n0 = batch.DISPATCH_STATS["n_dispatches"]
run("warmup", "-o", out("w"), "-c", "50", "--engine", "torch", "--vcf",
    vcf, bam)
assert batch.DISPATCH_STATS["n_dispatches"] > n0
assert probes.main(["probe_v3_feasibility", "--device", "cpu"]) == 0
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "pomfret_tpu"
                or m.startswith("pomfret_tpu."))
print("LOADED", *loaded)
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
    assert res.stdout.splitlines()[-1] == "LOADED", res.stdout[-2000:]


def _names_imported(tree):
    """Every module name a file imports: import, absolute from-import, and
    importlib.import_module / __import__ of a string constant."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def test_no_import_of_the_jax_package():
    assert {"tools", "bench", "jax"} <= {
        n.split(".")[0] for n in _names_imported(ast.parse(
            "import bench\nfrom tools.accuracy_scale import main\n"
            "import jax.numpy"))}
    files = sorted(glob.glob(os.path.join(REPO, "pomfret_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 30
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for name in _names_imported(tree):
            if name.split(".")[0] in ("pomfret_tpu", "jax", "bench",
                                      "tools"):
                bad.append((os.path.relpath(path, REPO), name))
    assert not bad, bad
