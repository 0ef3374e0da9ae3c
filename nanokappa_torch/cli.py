"""Command-line entry point (reference nanokappa.py; the JAX package's
nanokappa_tpu/cli.py).

Run e.g.:
    python -m nanokappa_torch.cli -ff parameters.txt    # on the card
    python -m nanokappa_torch.cli --geometry box ... --device cpu    # on the CPU
With -ff the file's words are all the arguments (as in the JAX CLI): a file
that says `--device cpu` runs on the CPU. Configurations outside the fused
step's envelope (e.g. examples/voronoi_star.txt: radial temperatures) run
the v1 step; the driver prints why.

The figures are the JAX CLI's (visual.py): the material and geometry plots
at the start, the postprocess figures at the end of every run, and
    python -m nanokappa_torch.cli --postprocess RESULTS_FOLDER
rebuilds them from a finished results folder's files alone and exits (no
simulation, no card). A plot that fails (e.g. no matplotlib) is reported
and never stops the run.

`--n_shards S` splits the particles over S ranks (parallel/launch.py): on
cards one rank a card over NCCL (S above the visible cards is refused),
with `--device cpu` S processes over gloo; 0, the default, is one rank,
as in the JAX driver. Rank 0 writes the output and every result file.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from datetime import datetime

from nanokappa_torch.io.config import generate_results_folder, read_args


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # offline postprocess: parsed before the full parser, so the required
    # -pf/-hf flags are not demanded; the rest comes from the folder's
    # arguments.txt (nanokappa_tpu/cli.py:18-30)
    if "--postprocess" in argv:
        from nanokappa_torch.visual import postprocess_folder

        postprocess_folder(argv[argv.index("--postprocess") + 1])
        return
    args = generate_results_folder(read_args(argv))
    from nanokappa_torch.parallel.launch import launch, rank_devices, shard_count

    n = shard_count(int(args.n_shards[0]), str(args.device[0]))
    if n > 1:
        backend, devices = rank_devices(n, str(args.device[0]))
        with tempfile.TemporaryDirectory() as rdv:
            launch(run_rank, n, rdv, backend, devices, args)
        return
    run(args)


def run_rank(comm, args):
    """One rank of a sharded CLI run (parallel/launch.py launch)."""
    if comm.rank != 0:
        sys.stdout = open(os.devnull, "w")
    run(args, comm)


def run(args, comm=None):
    """The CLI's run of parsed arguments: one process, or rank comm.rank."""
    out_mode = args.output if isinstance(args.output, str) else args.output[0]
    redirect = out_mode == "file" and (comm is None or comm.rank == 0)
    if redirect:
        sys.stdout = open(os.path.join(args.results_folder, "output.txt"), "w", buffering=1)

    t0 = time.time()
    print("---------- o ----------- o ------------- o ------------")
    print("NANOKAPPA (PyTorch/CUDA) - phonon Monte Carlo BTE solver")
    print("Simulation started at", datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
    print("Arguments file:", getattr(args, "from_file", "(command line)"))
    print("Results folder:", args.results_folder)
    if comm is not None:
        print(f"Particle shards: {comm.size} ranks")
    print("---------- o ----------- o ------------- o ------------", flush=True)

    from nanokappa_torch.driver import Simulation

    try:
        sim = Simulation(args, comm=comm)
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
        if sim.writes:
            try:
                from nanokappa_torch.visual import plot_geometry, plot_material

                plot_material(sim.material, args.results_folder)
                plot_geometry(sim.domain, args.results_folder)
            except Exception as e:
                print("init plots failed:", e)

        sim.run(profile_dir=(str(args.profile[0]) or None))

        if sim.writes:
            try:
                from nanokappa_torch.visual import postprocess

                postprocess(sim)
            except Exception as e:  # plots must never kill a finished simulation
                print("postprocess failed:", e)

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
