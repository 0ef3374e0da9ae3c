"""A tiny run of the harness on the CPU, the kernels' plain paths: its last
line has the contract's keys, no metric is filled from a CPU run, and the
check reads the program correct; the command refuses to run without a
card and prints no result."""

import json
import os
import subprocess
import sys

import pytest

import harness

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def tiny(name, seed, trace=False, **kw):
    import torch

    torch.set_num_threads(2)
    return harness.run_cell(name, seed, 0.5, trace, device="cpu", mesh=6, particles=8000,
                            log=lambda *a, **k: None, **kw)


@pytest.mark.parametrize("name,trace,seed", [("film-1e6", False, 2**31 + 977), ("film-1e6", False, 5),
                                             ("film-1e6", True, 2**31 + 978)])
def test_dry_run_on_the_cpu(name, trace, seed):
    out = tiny(name, seed, trace)
    assert KEYS <= set(out) and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 100
    assert out["metrics"] == {}  # nothing measured on a CPU
    assert out["device"]["platform"] == "cpu" and "busy_s" not in out["device"]
    assert "breakdown" not in out
    for k, c in out["checks"].items():
        assert c["value"] <= c["limit"], k
    json.dumps(out)


def test_the_command_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, os.path.join(harness.BENCH, "run.py"), "--workload",
                        "film-1e6", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "card" in r.stderr
