"""Marks the `slow` tier: the tests that tier-1 (`-m 'not slow'`) leaves out.

A test is marked `slow` only if, alone, it takes longer than tier-1's whole
1,470 s limit. SLOW is that list, and the only place a test is marked
`slow`; `tests/test_slow_tier.py` holds the suite to it. Run the tier by
hand with `JAX_PLATFORMS=cpu python -m pytest tests/ -m slow`."""

import pytest

# each is 20-24 calls of a 10-step Pallas-interpret step on the
# 40,000-particle wire at 115-123 s a call: 38-49 min alone
SLOW = frozenset({
    # 24 calls x 115-123 s = 46-49 min
    "tests/test_diffuse_kernel.py::test_dkern_matches_narrow_machinery",
    # 20 calls x 115-123 s = 38-41 min; red: the octagon has no specular
    # coverage, so both eta give the same flux
    "tests/test_diffuse_kernel.py::test_dkern_kappa_eta_monotone",
})


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # before `-m` deselects anything
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
