"""Kernel A's nearest-centre branch against the Pallas kernel on the film box
split into a 10 x 2 x 2 grid, 40 centres: the JAX kernel's fori_loop over its SMEM
centre table (beyond 32, nanokappa_tpu/ops/megastep.py:464-481). The check and its tolerances are
tests/test_torch_subvol_nearest.py:check_branch_against_pallas.
"""

from test_torch_subvol_nearest import build_centre_pair, check_branch_against_pallas


def test_nearest_centre_branch_matches_pallas():
    check_branch_against_pallas(*build_centre_pair("grid40"))
