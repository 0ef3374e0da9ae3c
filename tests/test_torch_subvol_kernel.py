"""Kernel A's nearest-centre branch against the Pallas kernel on the film box
split into 8 Voronoi centres: the JAX kernel's unrolled argmin over centres baked in
as constants (up to 32, nanokappa_tpu/ops/megastep.py:448-462). The check and its tolerances are
tests/test_torch_subvol_nearest.py:check_branch_against_pallas.
"""

from test_torch_subvol_nearest import build_centre_pair, check_branch_against_pallas


def test_nearest_centre_branch_matches_pallas():
    check_branch_against_pallas(*build_centre_pair("voronoi8"))
