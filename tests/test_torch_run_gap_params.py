"""run_gap(engine="torch") vs run_gap_jax and the host oracle across the
methmer parameters of tests/test_engine_params.py (3 cases), and on the
3-permutation fixture of tests/test_permutation.py::
test_permutation_voting_device_matches_host (the process-global srand48
stream of each package, reset first). Split from test_torch_run_gap.py
for the test workers. Tolerance: exact.
"""
import pytest

from torch_run_gap_cases import (PARAM_CASES, case_data, check_three_ways,
                                 vote_fixture)


@pytest.mark.parametrize("case", PARAM_CASES)
def test_run_gap_params_match_jax_and_host(tmp_path_factory, case):
    check_three_ways(*case_data(tmp_path_factory, case), 1, None)


def test_permutation_voting_3_matches_jax_and_host(tmp_path):
    check_three_ways(*vote_fixture(str(tmp_path), False, 0.0), 3, None)
