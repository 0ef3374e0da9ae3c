"""tests/torch_parity.py's thread budget: under pytest-xdist each worker's
torch takes max(1, cores // workers) threads; without xdist nothing is set.
A worker is stood in for by a fresh interpreter that imports torch_parity
with PYTEST_XDIST_WORKER_COUNT set, as xdist sets it before a worker
collects."""

import os
import subprocess
import sys

import pytest

from torch_parity import thread_budget

TESTS = os.path.dirname(os.path.abspath(__file__))

# a worker: its torch's threads before torch_parity and after
WORKER = f"""
import sys
sys.path.insert(0, {TESTS!r})
import torch
before = torch.get_num_threads()
import torch_parity
print(before, torch.get_num_threads(), torch.get_num_interop_threads())
"""


@pytest.mark.parametrize("workers, cores, budget", [
    ("6", 8, 1),
    ("2", 8, 4),
    ("16", 8, 1),
    (None, 8, None),
])
def test_budget_shares_the_cores_over_the_workers(workers, cores, budget):
    assert thread_budget(workers, cores) == budget


@pytest.mark.parametrize("workers", ["6", "2", None])
def test_a_worker_holds_the_budget(workers):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTEST_XDIST_WORKER_COUNT", "OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    if workers is not None:
        env["PYTEST_XDIST_WORKER_COUNT"] = workers
    res = subprocess.run([sys.executable, "-c", WORKER], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    before, intra, interop = (int(x) for x in res.stdout.split())
    budget = thread_budget(workers, os.cpu_count() or 1)
    if budget is None:
        assert intra == before
    else:
        assert (intra, interop) == (budget, budget)
