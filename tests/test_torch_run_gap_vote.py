"""run_gap(engine="torch") vs run_gap_jax and the host oracle on the
7-permutation fixtures of tests/test_permutation.py::
test_permutation_voting_device_matches_host (the process-global srand48
stream of each package, reset first; the 3-permutation one is in
test_torch_run_gap_params.py). Tolerance: exact.
"""
import pytest

from torch_run_gap_cases import check_three_ways, vote_fixture


@pytest.mark.parametrize("trans,noise", [(False, 0.08), (True, 0.05)])
def test_permutation_voting_7_matches_jax_and_host(tmp_path, trans, noise):
    check_three_ways(*vote_fixture(str(tmp_path), trans, noise), 7, None)
