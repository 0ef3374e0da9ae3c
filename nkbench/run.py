"""Run one cell of the benchmark once and print its result line.

    python3 nkbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: it needs the card(s) the cell asks for
and exits with a code other than 0, printing no result, without them. The
last line of standard output is the result (JSON); the last lines of
standard error give each number the correctness check compared beside its
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# one host thread for the math libraries, set before they load: the
# driver's host work is one thread's dispatch and formatting, and idle
# worker pools on a shared host only add to the runs' spread
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import harness
    import torch

    torch.set_num_threads(1)
    try:
        out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except harness.NoCard as e:
        print(f"nkbench: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # the run failed: no result line
        import traceback

        traceback.print_exc()
        print(f"nkbench: the run failed: {e}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:  # whatever the run or the check loaded: no result
        print(f"nkbench: the process holds {found}: the benchmark runs no JAX", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
