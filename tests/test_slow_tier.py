"""The `slow` tier is exactly the list in the repo-root `conftest.py`.

A change that marks another test `slow` changes that list on purpose; a
`slow` mark anywhere else fails here. The test collects the suite in a
fresh pytest (about 20 s alone on the CPU) and runs no test."""

import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slow_list():
    # by path: `import conftest` would find tests/conftest.py
    spec = importlib.util.spec_from_file_location(
        "repo_root_conftest", os.path.join(REPO, "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SLOW


def test_the_slow_tier_is_the_list():
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "--collect-only", "-q",
         "-m", "slow", "-p", "no:cacheprovider"],
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    ids = {line for line in res.stdout.splitlines() if "::" in line}
    assert ids == _slow_list()
