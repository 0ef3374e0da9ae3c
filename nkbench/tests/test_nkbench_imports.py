"""Nothing the benchmark loads is JAX or the JAX package, compared by the
whole top-level module name (the part before the first dot: the port's
name begins with the JAX package's), and the reference loads nothing of
the program."""

import ast
import os
import subprocess
import sys

import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "nanokappa_tpu"}

PROBE = r"""
import sys
sys.path[:0] = [{bench!r}, {root!r}]
import torch
torch.set_num_threads(2)
{body}
tops = sorted({{m.split(".")[0] for m in list(sys.modules)}})
print("TOPS", " ".join(tops))
"""


def loaded_tops(body: str) -> set[str]:
    code = PROBE.format(bench=harness.BENCH, root=harness.ROOT, body=body)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       cwd=harness.ROOT, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("TOPS ")][-1]
    return set(line.split()[1:])


def test_a_run_loads_no_jax():
    tops = loaded_tops(
        "import run, harness, control\n"
        "harness.run_cell('film-1e6', 5, 0.5, True, device='cpu', mesh=6, particles=4000,"
        " control=True, log=lambda *a, **k: None)\n")
    assert "nanokappa_torch" in tops and "reference" in tops
    assert not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded_tops(
        "import reference.check\n"
        "from reference.material import synthetic_material\n"
        "m = synthetic_material(mesh=(4, 4, 4))\n"
        "import json\n"
        "cfg = json.load(open('nkbench/configs/si_film.json'))\n"
        "reference.check.Reference(cfg['args'], m, 1000, 'cpu')\n")
    assert "reference" in tops
    assert not tops & (FORBIDDEN | {"nanokappa_torch", "harness"})


def test_the_reference_sources_name_no_program_module():
    top = os.path.join(harness.BENCH, "reference")
    for d, _, files in os.walk(top):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in FORBIDDEN | {"nanokappa_torch"}, (f, n)
