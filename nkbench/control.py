"""The control of the benchmark's correctness check, the planted faults,
and the readings its limits were set from. Not run by the benchmark's own
runs.

    python3 nkbench/control.py --workload <name> --seeds 1,2,3 [--seconds 1] [--faults all]

In one process (the raw material made once), for each seed it runs the
cell as run.py does (set-up, the warm-up batch, a window of at least one
whole batch at the cell's own size) and prints one JSON line: every number
the check compares for the program's outputs ("program") and for the
control, the plain reference computed in bfloat16 and put in the
program's place ("control"). With --faults it then runs each planted
fault (faults.py) on each seed and prints its numbers and `correct`. The
last line gives, for each number, the largest program reading and the
smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--faults", default="", help="comma-separated faults of faults.py, or 'all'")
    p.add_argument("--no-control", action="store_true", help="the program's readings only")
    a = p.parse_args(argv)
    import faults
    import harness

    spec = harness.load_cell(a.workload)
    raw = harness.raw_material(spec.config)
    seeds = [int(x) for x in a.seeds.split(",")]

    def log(*x, **k):
        print(*x, file=sys.stderr, flush=True)

    lo, up = {}, {}
    for s in seeds:
        out = harness.run_cell(a.workload, s, a.seconds, False, control=not a.no_control, raw=raw, log=log)
        prog = {k: c["value"] for k, c in out["checks"].items()}
        print(json.dumps({"seed": s, "correct": out["correct"], "program": prog,
                          "control": out.get("control")}), flush=True)
        for k, v in prog.items():
            lo[k] = max(lo.get(k, v), v)
        for k, v in (out.get("control") or {}).items():
            up[k] = min(up.get(k, v), v)
    names = faults.FAULTS if a.faults == "all" else [f for f in a.faults.split(",") if f]
    for f in names:
        for s in seeds:
            with faults.plant(f):
                out = harness.run_cell(a.workload, s, a.seconds, False, raw=raw, log=log)
            over = {k: c["value"] for k, c in out["checks"].items() if c["value"] > c["limit"]}
            print(json.dumps({"fault": f, "seed": s, "correct": out["correct"], "over": over,
                              "numbers": {k: c["value"] for k, c in out["checks"].items()}}), flush=True)
    print(json.dumps({"workload": a.workload, "program_max": lo, "control_min": up}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
