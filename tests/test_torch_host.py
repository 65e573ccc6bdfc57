"""The port's own host layers vs the JAX package's, on the CPU.

The data comes from the port's scenario makers (pomfret_tpu_torch.testing,
seeded); each subcommand runs through pomfret_tpu_torch.cli and through
pomfret_tpu.cli on the same inputs, and the outputs must be byte-identical:
- methphase (the port's --engine host and --engine torch against the JAX
  package's --engine host) on the cis and trans two-block scenarios and a
  2-chromosome x 6-gap scenario: .mp.vcf, .mp.gtf and .mp.tsv;
- report (the port's --engine host and --engine torch against the JAX
  package's --engine host): .report.tsv.
Tolerance: exact.
"""
import pytest
import torch

from pomfret_tpu.cli import main as tpu_main
from pomfret_tpu_torch.cli import main as port_main
from pomfret_tpu_torch.testing import (make_multichrom_multigap_scenario,
                                       make_two_block_scenario)
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

torch.set_num_threads(1)

SCENARIOS = ("cis", "trans", "multi")
_REPORT_ARGS = ["-c", "50", "--chunk-size", "40000", "--chunk-stride",
                "30000"]


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    """{name: (bam, vcf)}: the two-block scenarios and 2 chromosomes x 6
    gaps."""
    out = {}
    for name in SCENARIOS:
        d = str(tmp_path_factory.mktemp(name))
        if name == "multi":
            # every second read of chip_smoke.py's: the host oracle's
            # time grows with the reads per window
            bam, vcf, _ = make_multichrom_multigap_scenario(
                d, n_chroms=2, n_blocks=7, read_stagger=1400)
        else:
            bam, vcf, _ = make_two_block_scenario(d, trans=name == "trans")
        out[name] = (bam, vcf)
    return out


def _same_files(p1, p2, exts):
    for ext in exts:
        with open(p1 + ext, "rb") as f1, open(p2 + ext, "rb") as f2:
            a = f1.read()
            assert a == f2.read(), ext
            assert a, ext


@pytest.fixture(scope="module")
def jax_methphase(scenarios, tmp_path_factory):
    """pomfret_tpu methphase --engine host: {scenario: output prefix}."""
    out = {}
    for name, (bam, vcf) in scenarios.items():
        prefix = str(tmp_path_factory.mktemp(f"jax_{name}") / "out")
        assert tpu_main(["methphase", "-o", prefix, "--engine", "host",
                         "--output-tsv", "-c", "50", "--vcf", vcf, bam]) == 0
        out[name] = prefix
    return out


@pytest.mark.parametrize("engine", ["host", "torch"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_methphase_matches_jax(scenarios, jax_methphase, tmp_path, name,
                               engine):
    bam, vcf = scenarios[name]
    prefix = str(tmp_path / "port")
    assert port_main(["methphase", "-o", prefix, "--engine", engine,
                      "--output-tsv", "-c", "50", "--vcf", vcf, bam]) == 0
    _same_files(prefix, jax_methphase[name], (".mp.vcf", ".mp.gtf", ".mp.tsv"))


@pytest.mark.parametrize("name,engine", [("cis", "host"), ("trans", "host"),
                                         ("trans", "torch")])
def test_report_matches_jax(scenarios, tmp_path, name, engine):
    bam, vcf = scenarios[name]
    p_j, p_p = str(tmp_path / "jax"), str(tmp_path / "port")
    assert tpu_main(["report", "-o", p_j, "--engine", "host", *_REPORT_ARGS,
                     "--vcf", vcf, bam]) == 0
    assert port_main(["report", "-o", p_p, "--engine", engine,
                      *_REPORT_ARGS, "--vcf", vcf, bam]) == 0
    _same_files(p_p, p_j, (".report.tsv",))
    with open(p_p + ".report.tsv") as f:
        assert "correct" in f.read()
