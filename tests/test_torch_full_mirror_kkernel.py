"""Kernel A's full-mirror branch against Pallas on the k film's pool
(tests/test_torch_full_mirror_kernel.py says what is held and to which
tolerance; one Pallas compile per file keeps each under 30 s)."""

from test_torch_full_mirror_kernel import check_full_mirror


def test_full_mirror_k_matches_pallas():
    check_full_mirror("k")
