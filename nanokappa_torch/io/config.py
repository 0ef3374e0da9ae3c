"""Argparse-compatible CLI surface (the JAX package's nanokappa_tpu/io/config.py,
copied; the port adds --device).

Flag-for-flag parity with the reference parser (argument_parser.py:6-110):
the same long/short names, nargs and defaults, the hidden debug tier, file
based parameter sets via --from_file, auto-indexed results folders
(name_0, name_1, ...), and the arguments.txt round trip (a results folder's
arguments.txt is itself a valid parameter file, nanokappa.py:32-50)."""

from __future__ import annotations

import argparse
import os
import sys


def initialise_parser(debug_flag: bool = True) -> argparse.ArgumentParser:
    def dbg(helptext):
        return helptext if debug_flag else argparse.SUPPRESS

    p = argparse.ArgumentParser(prog="nanokappa", description="Phonon Monte Carlo BTE solver (PyTorch/CUDA)")
    p.add_argument("--from_file", "-ff", type=str, nargs=1, default="", help="Import arguments from file.")
    p.add_argument("--geometry", "-g", type=str, nargs=1, default=["cuboid"], help="Domain geometry: box/cuboid, cylinder/rod/bar, or an .stl file path.")
    p.add_argument("--dimensions", "-d", type=float, nargs="*", default=[10e3, 1e3, 1e3], help="Dimensions in angstroms (3 for box; radius, height for cylinder).")
    p.add_argument("--scale", "-s", type=float, nargs=3, default=[1, 1, 1], help="Scale factors (x, y, z) applied to the geometry.")
    p.add_argument("--geo_rotation", "-gr", nargs="*", default=[0, 0, 0, "xyz"], help="Euler angles in degrees + order applied to the geometry.")
    p.add_argument("--mat_rotation", "-mr", nargs="*", default=[], help="Material index, Euler angles in degrees and order applied to the material.")
    p.add_argument("--isotope_scat", "-is", type=int, nargs="*", default=[], help="Material indices that include isotope (mass) scattering.")
    p.add_argument("--particles", "-p", nargs=2, default=["pmps", 1], help='Particle count: ("total", N), ("pmps", per-mode-per-subvol), or ("pv", per cubic angstrom).')
    p.add_argument("--timestep", "-ts", type=float, nargs=1, default=[1], help="Timestep in picoseconds.")
    p.add_argument("--iterations", "-i", type=int, nargs=1, default=[10000], help="Number of timesteps to run.")
    p.add_argument("--max_sim_time", "-mt", type=str, nargs=1, default=["1-00:00:00"], help="Wall-clock limit D-HH:MM:SS; 0-00:00:00 disables the limit.")
    p.add_argument("--subvolumes", "-sv", nargs="*", default=[], help='Subvolume spec: ("slice", N, axis), ("grid", nx, ny, nz) or ("voronoi", N).')
    p.add_argument("--temp_dist", "-td", type=str, nargs="*", default=["cold"], choices=["cold", "hot", "linear", "mean", "random", "custom"], help="Initial temperature distribution.")
    p.add_argument("--temp_interp", "-ti", type=str, nargs=1, default=["nearest"], choices=["nearest", "linear", "radial"], help="Particle temperature interpolation between subvolumes.")
    p.add_argument("--subvol_temp", "-st", type=float, nargs="*", default=[], help="Subvolume temperatures for the custom profile.")
    p.add_argument("--bound_cond", "-bc", type=str, nargs="*", default=[], choices=["T", "P", "R"], help="Boundary condition per specified facet; last value is the default for unspecified facets.")
    p.add_argument("--bound_pos", "-bp", nargs="*", default=[], help='Facet probe points: "relative"|"absolute" x1 y1 z1 x2 y2 z2 ...')
    p.add_argument("--bound_values", "-bv", type=float, nargs="*", default=[], help="Boundary values (temperature [K] or roughness [angstrom]).")
    p.add_argument("--connect_pos", "-cp", nargs="*", default=[], help="Probe points for periodic facet pairs, declared like --bound_pos.")
    p.add_argument("--fig_plot", "-fp", type=str, nargs="*", default=[], help="Particle scatter figures to save (T, omega, energy, n, subvolume).")
    p.add_argument("--colormap", "-cm", type=str, nargs=1, default=["jet"], help="Matplotlib colormap for all plots.")
    p.add_argument("--theme", "-th", type=str, nargs=1, default=["white"], choices=["white", "light", "dark"], help="Plot theme.")
    p.add_argument("--n_mean", "-nm", type=int, nargs=1, default=[100], help="Datapoints in the rolling mean/stdev window (1 datapoint = 10 timesteps).")
    p.add_argument("--conv_crit", "-cc", type=float, nargs=2, default=[0, 1], help="Convergence criterion value and number of consecutive checks.")
    p.add_argument("--mat_folder", "-mf", type=str, nargs="*", default=[""], help="Folder with material data.")
    p.add_argument("--poscar_file", "-pf", type=str, nargs="*", required=True, help="POSCAR file to read.")
    p.add_argument("--hdf_file", "-hf", type=str, nargs="*", required=True, help="phono3py kappa hdf5 file to read.")
    p.add_argument("--results_folder", "-rf", type=str, nargs="*", default=[], help="Results folder (auto-indexed name_0, name_1, ...).")

    # debug tier (reference argument_parser.py:82-108)
    p.add_argument("--part_dist", "-pd", type=str, nargs=1, default=["random_subvol"], help=dbg("Particle distribution: random/center _ domain/subvol, or a particle_data.txt path to resume."))
    p.add_argument("--empty_subvols", "-es", type=int, nargs="*", default=[], help=dbg("Subvolume indices kept empty at initialisation."))
    p.add_argument("--subvol_material", "-sm", type=int, nargs="*", default=[], help=dbg("Material index per subvolume."))
    p.add_argument("--reference_temp", "-rt", nargs=1, default=["local"], help=dbg('Reference temperature in K, or "local".'))
    p.add_argument("--reservoir_gen", "-gn", type=str, nargs="*", default=["constant"], choices=["fixed_rate", "one_to_one", "constant", "pooled"], help=dbg("Reservoir particle generation scheme."))
    p.add_argument("--path_points", "-pp", nargs="*", default=[], help=dbg("Points of the kappa path, declared like --bound_pos."))
    p.add_argument("--energy_normal", "-en", type=str, nargs=1, default=["mean"], help=dbg('Subvolume energy normalisation: "mean" or "fixed".'))
    p.add_argument("--bound_scat", "-bs", type=str, nargs="*", default=["velocity"], help=dbg('Specular reflection model: "velocity" or "k".'))
    p.add_argument("--output", "-op", type=str, nargs=1, default="file", help=dbg('"file" redirects stdout to output.txt; "screen" prints.'))

    # extensions (not in the reference)
    p.add_argument("--n_shards", "-ns", type=int, nargs=1, default=[0], help=dbg("Particle-axis shards, one rank each (0 = one rank, as 1)."))
    p.add_argument("--pool_margin", type=float, nargs=1, default=[1.4], help=dbg("Particle pool capacity / target population."))
    p.add_argument("--evt_cap", type=int, nargs=1, default=[0], help=dbg("Boundary-event buffer width (0 = autosize from the kinetic rough-wall collision rate)."))
    p.add_argument("--subvol_volume_algo", "-sva", type=str, nargs=1, default=["mc"], choices=["mc", "qmc"], help=dbg("Subvolume volume sampling: pseudo-random ('mc', reference default) or scrambled-Sobol ('qmc')."))
    p.add_argument("--seed", type=int, nargs=1, default=[0], help=dbg("PRNG seed."))
    p.add_argument("--profile", type=str, nargs=1, default=[""], help=dbg("Write a torch.profiler trace of one 100-step batch to this directory."))
    p.add_argument("--device", type=str, nargs=1, default=["cuda"], help=dbg('Torch device the simulation runs on: "cuda" (the card, the default) or "cpu".'))
    p.add_argument("--postprocess", type=str, nargs=1, default=[""], help="Rebuild every figure from a finished results folder's files alone, then exit (no simulation).")
    return p


def read_args(argv=None, debug_flag: bool = True, tolerant: bool = False) -> argparse.Namespace:
    """Parse argv, replaying a parameter file when -ff/--from_file is given.

    `tolerant=True` ignores unknown flags instead of erroring — used by the
    offline postprocess entry so a results folder's arguments.txt written
    by another solver (the reference's, with flags like --rt_plot, or the
    JAX package's) still parses."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = initialise_parser(debug_flag)

    def parse(tokens):
        if tolerant:
            ns, _ = parser.parse_known_args(tokens)
            return ns
        return parser.parse_args(tokens)

    if "-ff" in argv or "--from_file" in argv:
        i = argv.index("-ff") if "-ff" in argv else argv.index("--from_file")
        filename = argv[i + 1]
        with open(filename) as f:
            tokens = f.read().split()
        if tolerant and "--from_file" in tokens:
            # a replayed arguments.txt may itself carry a --from_file entry
            # pointing at a file that no longer exists; drop it
            j = tokens.index("--from_file")
            del tokens[j : j + 2]
        args = parse(tokens)
        args.from_file = filename
        return args
    return parse(argv)


def generate_results_folder(args) -> argparse.Namespace:
    """Create an auto-indexed results folder (argument_parser.py:142-175)."""
    if len(args.results_folder) == 0:
        args.results_folder = os.getcwd()
        return args
    loc = os.path.normpath(os.path.relpath(args.results_folder[0]))
    if not os.path.isabs(loc):
        loc = os.path.join(os.getcwd(), loc)
    i = _get_folder_index(loc)
    os.makedirs(f"{loc}_{i}", exist_ok=False)
    args.results_folder = f"{loc}_{i}"
    return args


def _get_folder_index(loc: str) -> int:
    base, dirname = os.path.basename(loc), os.path.dirname(loc)
    if not os.path.exists(dirname):
        return 0
    same = []
    for d in os.listdir(dirname):
        if d.startswith(base + "_"):
            tail = d.split("_")[-1]
            if tail.isdigit():
                same.append(int(tail))
    return max(same) + 1 if same else 0


def write_arguments_file(args, folder: str):
    """Echo the full argument set for exact replay (nanokappa.py:32-50)."""
    skip = {"from_file"}
    with open(os.path.join(folder, "arguments.txt"), "w") as f:
        for key, value in vars(args).items():
            if key in skip:
                continue
            if isinstance(value, (list, tuple)):
                value = " ".join(str(v) for v in value)
            value = str(value).strip()
            if value == "":  # an empty value would break the re-parse
                continue
            f.write(f"--{key} {value}\n")
