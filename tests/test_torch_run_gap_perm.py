"""run_gap(engine="torch") with 5 permutations per direction, drawn from a
per-gap srand48 stream, vs run_gap_jax and the host oracle on the fixtures
of tests/test_engine_jax.py. The five seeds of a direction run as five
lanes of one batch; run_gap_jax runs them one dispatch each, the host one
after another. Split from test_torch_run_gap.py for the test workers.
Tolerance: exact.
"""
import pytest

from torch_run_gap_cases import JAX_CASES, case_data, check_three_ways


@pytest.mark.parametrize("case", JAX_CASES)
def test_run_gap_permutations_match_jax_and_host(tmp_path_factory, case):
    check_three_ways(*case_data(tmp_path_factory, case), 5, 4242)
