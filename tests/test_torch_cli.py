"""The port's warmup and methphase --profile, on the CPU.

- `warmup --engine host` has nothing to warm; `warmup --engine torch` packs
  every gap group and runs the plain loop once per packed shape, at
  max_iters=0 (no iteration);
- `methphase --profile --engine torch` writes a torch.profiler Chrome trace
  under <prefix>.profile/ that holds the run's CPU operators, and the same
  outputs as the run without it.
"""
import json
import os

import pytest
import torch

from pomfret_tpu_torch.cli import main as port_main
from pomfret_tpu_torch.parallel.batch import DISPATCH_STATS
from pomfret_tpu_torch.testing import make_multichrom_multigap_scenario

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("multi"))
    bam, vcf, _ = make_multichrom_multigap_scenario(d, n_chroms=2,
                                                    n_blocks=3)
    return bam, vcf


@pytest.mark.parametrize("engine", ["host", "torch"])
def test_warmup(scenario, tmp_path, capsys, engine):
    bam, vcf = scenario
    n0 = DISPATCH_STATS["n_dispatches"]
    assert port_main(["warmup", "-o", str(tmp_path / "w"), "--engine",
                      engine, "-c", "50", "--vcf", vcf, bam]) == 0
    err = capsys.readouterr().err
    if engine == "host":
        assert "nothing to warm" in err
        assert DISPATCH_STATS["n_dispatches"] == n0
    else:
        # both chromosomes' groups pack to one shape: one dispatch
        assert "1 engine shape(s) run" in err
        assert DISPATCH_STATS["n_dispatches"] == n0 + 1
    assert not os.listdir(tmp_path)  # warmup writes no output


def test_methphase_profile(scenario, tmp_path):
    bam, vcf = scenario
    args = ["--engine", "torch", "-c", "50", "--vcf", vcf, bam]
    p_prof, p_plain = str(tmp_path / "prof"), str(tmp_path / "plain")
    assert port_main(["methphase", "-o", p_prof, "--profile", *args]) == 0
    assert port_main(["methphase", "-o", p_plain, *args]) == 0
    with open(os.path.join(p_prof + ".profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert "aten::bmm" in ops   # the seed count table of the plain loop
    for ext in (".mp.vcf", ".mp.gtf"):
        with open(p_prof + ext, "rb") as a, open(p_plain + ext, "rb") as b:
            assert a.read() == b.read()
    assert not os.path.exists(p_plain + ".profile")
