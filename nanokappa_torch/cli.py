"""Command-line entry point (reference nanokappa.py; the JAX package's
nanokappa_tpu/cli.py).

Run e.g.:
    python -m nanokappa_torch.cli -ff parameters.txt    # on the card
    python -m nanokappa_torch.cli --geometry box ... --device cpu    # on the CPU
With -ff the file's words are all the arguments (as in the JAX CLI): a file
that says `--device cpu` runs on the CPU. Configurations outside the fused
step's envelope (e.g. examples/voronoi_star.txt: radial temperatures) run
the v1 step; the driver prints why.

The figures (--fig_plot, the init and postprocess plots, --postprocess) are
not ported yet (ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import os
import sys
import time
from datetime import datetime

from nanokappa_torch.io.config import generate_results_folder, read_args


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--postprocess" in argv:
        raise NotImplementedError(
            "--postprocess (the figures) is not ported yet (ROADMAP queue 1, item 13)"
        )
    args = generate_results_folder(read_args(argv))

    out_mode = args.output if isinstance(args.output, str) else args.output[0]
    redirect = out_mode == "file"
    if redirect:
        sys.stdout = open(os.path.join(args.results_folder, "output.txt"), "w", buffering=1)

    t0 = time.time()
    print("---------- o ----------- o ------------- o ------------")
    print("NANOKAPPA (PyTorch/CUDA) - phonon Monte Carlo BTE solver")
    print("Simulation started at", datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
    print("Arguments file:", getattr(args, "from_file", "(command line)"))
    print("Results folder:", args.results_folder)
    print("---------- o ----------- o ------------- o ------------", flush=True)

    from nanokappa_torch.driver import Simulation

    try:
        sim = Simulation(args)
        print(
            f"Material: {sim.material.name} — {sim.material.n_qpoints} q-points, "
            f"{sim.material.n_branches} branches, {sim.material.n_active_modes} active modes"
        )
        print(
            f"Domain: {sim.domain.mesh.n_facets} facets, "
            f"{sim.domain.n_of_subvols} subvolumes ({sim.domain.subvol_type}), "
            f"{sim.domain.n_of_reservoirs} reservoirs"
        )
        print(f"Particles: {sim.n_p_target} (pool capacity {sim.params.n_cap}) on {sim.device}",
              flush=True)
        sim.run(profile_dir=(str(args.profile[0]) or None))

        dt = time.time() - t0
        print("---------- o ----------- o ------------- o ------------")
        print(f"Simulation finished at {datetime.now().strftime('%Y-%m-%d %H:%M:%S')} after {dt:.1f} s")
        print("Results in", args.results_folder)
    finally:
        if redirect:
            sys.stdout.close()
            sys.stdout = sys.__stdout__


if __name__ == "__main__":
    main()
