"""The probe kernels' plain versions vs the JAX package's tools/probe_*.py.

Each registry entry of pomfret_tpu_torch.tools.probes runs twice on the
same inputs: the JAX probe file, loaded by path, with
jax.experimental.pallas.pallas_call patched to run in interpret mode and to
record the array each pallas_call returns (several probes only print a
string); and the port's plain version on the CPU. Tolerance: the integer
sums exact; the ratio sums of probe_stile and probe_stile2 within rtol=1e-5,
atol=1e-4 (f32 summation order: the JAX probe's own full-S and tiled-S
sums differ by up to 2.3e-5).

Nine variants read scratch rows that the Pallas kernel never wrote, which
interpret mode fills with values of its own (int8 scratch comes back
non-zero): probe_dma static/traced_row/traced_both/chunk _i8, probe_dma3
c16_i8, c32_i8, c32_i8_dyn, probe_dma4 lead_i8_multi and probe_v3_parts
dma_dyn. The port zero-fills scratch, so on those the plain version is held
against the probe's numpy oracle with zeros there, not against interpret
mode. Every entry is also held against that oracle.
"""
import contextlib
import importlib.util
import io
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pomfret_tpu_torch.kernels import probes as kp
from pomfret_tpu_torch.tools import probes as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = sorted(tp.PROBES)
UNDEFINED = {("probe_dma", v) for v in ("static_i8", "traced_row_i8",
                                        "traced_both_i8", "chunk_i8")} | {
    ("probe_dma3", v) for v in ("c16_i8", "c32_i8", "c32_i8_dyn")} | {
    ("probe_dma4", "lead_i8_multi"), ("probe_v3_parts", "dma_dyn")}

_MODULES = {}


def _probe_module(stem):
    if stem not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"_jax_{stem}", os.path.join(REPO, "tools", f"{stem}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[stem] = mod
    return _MODULES[stem]


def _run_jax_probe(monkeypatch, stem, variant):
    """The first array returned by each pallas_call the probe builds, in
    the order it builds them."""
    orig = pl.pallas_call
    first = []

    def recording(kernel, *args, **kwargs):
        kwargs["interpret"] = True
        f = orig(kernel, *args, **kwargs)
        k = len(first)
        first.append(None)

        def keep(out):
            if first[k] is None:
                first[k] = np.asarray(out)

        def g(*a):
            out = f(*a)
            jax.debug.callback(keep, out)
            return out
        return g

    monkeypatch.setattr(pl, "pallas_call", recording)
    mod = _probe_module(stem)
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            if variant == "main":
                mod.main()
            else:
                mod.run(variant)
        except AssertionError:
            # the probe's own assert on an undefined-scratch variant
            assert (stem, variant) in UNDEFINED
    jax.effects_barrier()
    return first


def test_registry_covers_every_probe():
    assert len(tp.PROBES) == 45
    assert UNDEFINED == {k for k, p in tp.PROBES.items()
                         if p.undefined_in_jax}
    stems = {os.path.splitext(f)[0] for f in os.listdir(
        os.path.join(REPO, "tools")) if f.startswith("probe_")}
    assert stems == {s for s, _ in tp.PROBES}


@pytest.mark.parametrize("stem,variant", KEYS)
def test_plain_matches_jax_probe(monkeypatch, stem, variant):
    p = tp.PROBES[(stem, variant)]
    _, _, got, ok, msg = tp.run_probe(p, torch.device("cpu"))
    assert ok, msg                       # the probe's oracle, zero scratch
    recorded = _run_jax_probe(monkeypatch, stem, variant)
    names = ["full", "tiled"] if p.kernel == "probe_stile" else ["out"]
    assert len(recorded) == len(names)
    if (stem, variant) in UNDEFINED:
        return                           # interpret mode's scratch values
    for name, want in zip(names, recorded):
        assert got[name].shape == want.shape, name
        if p.kernel == "probe_stile":
            np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-4)
        else:
            assert np.array_equal(got[name], want.astype(np.int64)), \
                (name, got[name].ravel()[:8], want.ravel()[:8])


@pytest.mark.parametrize("n_iter", [1, 3])
def test_stile_plain_full_equals_tiled(n_iter):
    """Full-S and tiled-S sum the same exact f64 values: equal bit for bit,
    here with a range of its own per batch row."""
    inp = tp.stile_make()
    rng = np.random.default_rng(7)
    lo = rng.integers(0, 900, size=len(inp["ranges"]))
    inp["ranges"] = np.stack([lo, lo + rng.integers(0, 600, size=len(lo))],
                             1).astype(np.int32)
    t = tp.tensors(inp, "cpu")
    full = kp.stile(t["cnt"], t["cids"], t["ranges"], tiled=False,
                    n_iter=n_iter)
    tiled = kp.stile(t["cnt"], t["cids"], t["ranges"], tiled=True,
                     n_iter=n_iter)
    assert torch.equal(full, tiled)
    assert np.array_equal(full.numpy(), tp.stile_expect(inp, n_iter))
    assert kp.tile_bounds(t["ranges"], 1536) == (
        int(lo.min()) // 256 * 256,
        min(-(-int(t["ranges"][:, 1].max()) // 256) * 256, 1536))


def test_row_copy_plain_edges():
    """A row range outside [0, R) copies nothing; a slot range outside
    [0, NB) places nothing; the total is the sum of the lanes; the buffer
    comes back only with keep_buf, and NB=0 has none."""
    src = torch.arange(4 * 6 * 16, dtype=torch.int32).view(4, 6, 16)
    rows = torch.tensor([0, 5, -1, 3], dtype=torch.int32)   # 5 + 2 > 6
    slots = torch.tensor([1, 0, 0, 3], dtype=torch.int32)   # 3 + 2 > 4
    lane_sum, total, buf = kp.row_copy(src, rows, slots, W=2, NB=4,
                                       keep_buf=True)
    want = torch.zeros(4, 4, 16, dtype=torch.int32)
    want[0, 1:3] = src[0, 0:2]
    assert torch.equal(buf, want)
    assert lane_sum.tolist() == [int(src[0, :2].sum()), 0, 0, 0]
    assert int(total) == int(lane_sum.sum())
    assert kp.row_copy(src, rows, slots, W=2, NB=4)[2] is None
    stage_sums = [int(src[0, :2].sum()), 0, 0, int(src[3, 3:5].sum())]
    for nb in (4, 0):
        staged, total, _ = kp.row_copy(src, rows, slots, W=2, NB=nb,
                                       sum_stage=True)
        assert staged.tolist() == stage_sums
        assert int(total) == sum(stage_sums)


def test_entry_point_exit_codes(capsys):
    assert tp.main(["probe_dma6", "t1", "t5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["probe_dma6 t1: OK out=[254, 254, 254, 254, 254, 254, "
                   "254, 254]", "probe_dma6 t5: OK out=[254, 0, 0, 0, 0, 0, "
                   "0, 0]"]
    assert tp.main(["probe_dma6", "t9", "--device", "cpu"]) == 2


def test_entry_point_fails_on_a_wrong_result(monkeypatch, capsys):
    p = tp.PROBES[("probe_v3_parts", "whileloop")]
    wrong = tp.Probe(p.stem, p.variant, p.kernel, p.make,
                     lambda fn, t: (fn(t["hp"], "whileloop", n_iter=4),),
                     p.result, p.expect)
    monkeypatch.setitem(tp.PROBES, ("probe_v3_parts", "whileloop"), wrong)
    assert tp.main(["tools/probe_v3_parts.py", "whileloop", "--device",
                    "cpu"]) == 1
    assert "whileloop: FAIL out" in capsys.readouterr().out
