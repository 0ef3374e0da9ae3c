"""The torch threads of a rank that nanokappa_torch/parallel/launch.py
starts on the CPU: its share of the cores, os.cpu_count() // n_ranks, or
the count its process already starts with when that is less. A spawned
rank starts with OMP_NUM_THREADS threads where that is set, and a thread a
core where it is not. The test takes the xdist worker count out of the
ranks' environment, so that tests/torch_parity.py's budget (which the
ranks import) leaves them alone."""

import os

import numpy as np
import pytest

from torch_shard_ranks import report_threads, start_ranks


@pytest.mark.parametrize("omp", ["1", None])
def test_cpu_ranks_take_the_lesser_of_their_share_and_a_set_count(monkeypatch, tmp_path, omp):
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "PYTEST_XDIST_WORKER_COUNT"):
        monkeypatch.delenv(name, raising=False)
    if omp is not None:
        monkeypatch.setenv("OMP_NUM_THREADS", omp)
    threads = 1 if omp == "1" else max(1, (os.cpu_count() or 1) // 2)
    start_ranks(report_threads, 2, str(tmp_path))(120)
    assert [int(np.load(tmp_path / f"rank{r}.npz")["threads"]) for r in range(2)] == [threads] * 2
