"""The port's IO copies vs the JAX package's, on the CPU.

- the scenario makers of pomfret_tpu_torch.testing write the same VCF
  text and the same BAM records as pomfret_tpu.testing's for the same
  arguments;
- `varhaptag`: .varhaptag.tsv and .bai byte-identical to
  `pomfret_tpu.cli varhaptag`'s, the retagged BAM's records equal;
- `methstat`: .methstat.tsv byte-identical to `pomfret_tpu.cli methstat`'s;
- `bam2cram`: the CRAM's records, read back through the port's reader and
  through the JAX package's, equal the BAM's; its bytes equal the JAX
  package's where both native IO libraries load (at one fixed clock: the
  CRAM's gzip blocks carry the time);
- the port's native IO library, loaded by 4 processes at once into an
  empty build directory, is built once: all 4 load it and one library
  file is left.
Tolerance: exact.
"""
import gzip
import os
import subprocess
import sys
import time

import pytest

import pomfret_tpu.io.native as tpu_native
import pomfret_tpu.testing as tpu_testing
from pomfret_tpu.cli import main as tpu_main
from pomfret_tpu.io.cram import CramReader as TpuCramReader
from pomfret_tpu_torch import testing as port_testing
from pomfret_tpu_torch.cli import main as port_main
from pomfret_tpu_torch.io import native as port_native
from pomfret_tpu_torch.io.bam import BamReader
from pomfret_tpu_torch.io.bam_writer import encode_record
from pomfret_tpu_torch.io.cram import CramReader
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(path):
    return [encode_record(r) for r in BamReader(path).fetch_all()]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


MAKERS = {
    "two_block": lambda m, d: m.make_two_block_scenario(d, trans=True),
    "two_chrom": lambda m, d: m.make_two_chrom_scenario(d),
    "multichrom": lambda m, d: m.make_multichrom_multigap_scenario(
        d, n_chroms=2, n_blocks=3, trans_alternate=True),
    "multi_block": lambda m, d: m.make_multi_block_scenario(d, n_blocks=3),
}


@pytest.mark.parametrize("maker", sorted(MAKERS))
def test_scenario_makers_match(tmp_path, maker):
    outs = []
    for mod in (port_testing, tpu_testing):
        d = str(tmp_path / mod.__name__)
        os.makedirs(d)
        outs.append(MAKERS[maker](mod, d)[:2])
    (bam_p, vcf_p), (bam_j, vcf_j) = outs
    with gzip.open(vcf_p, "rb") as a, gzip.open(vcf_j, "rb") as b:
        text = a.read()
        assert text == b.read()
    assert text.count(b"\n") > 10
    recs = _records(bam_p)
    assert recs and recs == _records(bam_j)
    assert _read(bam_p + ".bai") == _read(bam_j + ".bai")


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    """{name: (bam, vcf)}: an untagged cis two-block scenario (varhaptag's
    use), the tagged trans one, and 2 chromosomes x 2 gaps."""
    out = {}
    d = str(tmp_path_factory.mktemp("untagged"))
    out["untagged"] = port_testing.make_two_block_scenario(d, tagged=False)[:2]
    d = str(tmp_path_factory.mktemp("trans"))
    out["trans"] = port_testing.make_two_block_scenario(d, trans=True)[:2]
    d = str(tmp_path_factory.mktemp("multi"))
    out["multi"] = port_testing.make_multichrom_multigap_scenario(
        d, n_chroms=2, n_blocks=3)[:2]
    return out


@pytest.mark.parametrize("name,write_bam", [("untagged", True),
                                            ("multi", True),
                                            ("trans", False)])
def test_varhaptag_matches_jax(scenarios, tmp_path, name, write_bam):
    bam, vcf = scenarios[name]
    extra = [] if write_bam else ["--dont-write-bam"]
    o_j, o_p = str(tmp_path / "jax.bam"), str(tmp_path / "port.bam")
    assert tpu_main(["varhaptag", "-o", o_j, *extra, vcf, bam]) == 0
    assert port_main(["varhaptag", "-o", o_p, *extra, vcf, bam]) == 0
    tsv = _read(o_p + ".varhaptag.tsv")
    assert tsv == _read(o_j + ".varhaptag.tsv")
    assert tsv.count(b"\n") > 100
    assert os.path.exists(o_p) == write_bam
    if write_bam:
        recs = _records(o_p)
        assert recs == _records(o_j)
        assert len(recs) == tsv.count(b"\n") - 1   # one line per record
        assert _read(o_p + ".bai") == _read(o_j + ".bai")


@pytest.mark.parametrize("name", ["trans", "multi"])  # tags select sites
def test_methstat_matches_jax(scenarios, tmp_path, name):
    bam, vcf = scenarios[name]
    p_j, p_p = str(tmp_path / "jax"), str(tmp_path / "port")
    assert tpu_main(["methstat", "-o", p_j, "-c", "50", "--vcf", vcf,
                     bam]) == 0
    assert port_main(["methstat", "-o", p_p, "-c", "50", "--vcf", vcf,
                      bam]) == 0
    tsv = _read(p_p + ".methstat.tsv")
    assert tsv == _read(p_j + ".methstat.tsv")
    assert tsv.count(b"\n") > 100


def _same_record(a, b):
    assert (a.qname, a.flag, a.refID, a.pos, a.mapq, a.cigar, a.seq(),
            a.qual) == (b.qname, b.flag, b.refID, b.pos, b.mapq, b.cigar,
                        b.seq(), b.qual)
    for tag in ("HP", "MM", "ML", "MD", "de"):
        assert a.get_tag(tag) == b.get_tag(tag), tag


@pytest.mark.parametrize("mode", ["embed", "no_ref"])
def test_bam2cram_roundtrip(tmp_path, monkeypatch, mode):
    # a sparser read set than the default keeps the pure-Python encoder short
    bam, _, _ = port_testing.make_two_block_scenario(
        str(tmp_path), cfg=port_testing.SynthConfig(read_stagger=2800))
    extra = ["--no-ref"] if mode == "no_ref" else []
    # one file name in two directories: the .crai's gzip header holds it
    c_p, c_j = (str(tmp_path / d / "x.cram") for d in ("port", "jax"))
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
    assert port_main(["bam2cram", bam, c_p, *extra]) == 0
    orig = list(BamReader(bam).fetch_all())
    assert len(orig) > 50
    for reader in (CramReader, TpuCramReader):
        got = list(reader(c_p).fetch_all())
        assert len(got) == len(orig)
        for a, b in zip(orig, got):
            _same_record(a, b)
    assert os.path.getsize(c_p + ".crai") > 0
    if port_native.native_available() and tpu_native.native_available():
        monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
        assert port_main(["bam2cram", bam, c_p, *extra]) == 0
        assert tpu_main(["bam2cram", bam, c_j, *extra]) == 0
        assert _read(c_p) == _read(c_j)
        assert _read(c_p + ".crai") == _read(c_j + ".crai")


_LOAD = r"""
import sys
import pomfret_tpu_torch.io.native as native
native.BUILD_DIR = sys.argv[1]
assert native.native_available()
"""


def test_native_build_is_atomic(tmp_path):
    """4 processes load the native library into one empty build directory
    at once: each loads a whole library, built once."""
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(build)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    libs = [f for f in os.listdir(build) if f.endswith(".so")]
    assert len(libs) == 1, sorted(os.listdir(build))
    failed = [f for f in os.listdir(build) if f.endswith(".so.failed")]
    assert sorted(os.listdir(build)) == sorted(libs + failed + ["lock"])


def test_native_failed_rung_is_remembered(tmp_path, monkeypatch):
    """A rung that fails to build is tried once: later loads skip it and
    build the next rung, also once."""
    calls = []

    def fake_compile(out, extra):
        calls.append(extra)
        if extra:
            return False
        open(out, "w").close()  # not a library: CDLL refuses it
        return True

    monkeypatch.setattr(port_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(port_native, "_compile", fake_compile)
    ladder = (["-lno_such_library"], [])
    monkeypatch.setattr(port_native, "_LINK_LADDER", ladder)
    assert port_native._load() is None
    assert port_native._load() is None
    assert calls == list(ladder)
    assert os.path.exists(port_native.library_path(ladder[0]) + ".failed")
    assert not os.path.exists(port_native.library_path(ladder[1]) + ".failed")
