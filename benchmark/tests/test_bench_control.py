"""The controls at a size a test run holds: the reference put in the
port's place with its windows reaching 25 kb where the configuration says
50 kb comes out not correct; in bfloat16 it changes no output of these
sets (why: PERF.md, "How correct is decided")."""
from __future__ import annotations

import os
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(TESTS)
sys.path[:0] = [BENCH, TESTS, os.path.dirname(BENCH)]

import bench_cases  # noqa: E402
import control  # noqa: E402
from pbench import check  # noqa: E402


@pytest.mark.parametrize("name,correct", [("readback25k", False),
                                          ("bfloat16", True)])
def test_control_on_a_tiny_methphase_set(tmp_path, name, correct):
    cache = str(tmp_path / "cache")
    spec = bench_cases.tiny_spec("ont60x-methphase", cache)
    got = control.control(spec, 2**34 + 1, cache, 2, name)
    nums = {k: got[k] for k in check.LIMITS}
    assert check.report(nums)[0] is correct, got
    if not correct:
        assert got["tags_differing"] > 0
