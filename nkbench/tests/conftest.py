"""The benchmark's own tests: nkbench/ and the checkout's root on the
path. Tests that need an NVIDIA card carry the repository's `gpu` marker
and decide in the `card` fixture whether there is one."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return "cuda"
