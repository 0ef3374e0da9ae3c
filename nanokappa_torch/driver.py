"""Host-side simulation driver: assembly, main loop, convergence machinery.

The JAX package's nanokappa_tpu/driver.py (`Simulation` :102), on the port:
the same setup (material, domain, parameters, boundary and reservoir
tables, initial state), the same result files, the same batched loop —
the block runner (parallel/sharding.py build_sharded_step: sim/step.py
build_step on one shard) at n_inner = 10 steps per convergence datapoint
and n_outer = 10 datapoints per host read, with a 1-datapoint runner for
the tail — and the same convergence test: rolling means over the last n_mean
datapoints, whose largest relative change must stay below conv_crit for
conv_count_min consecutive checks (classes/Visualisation.py:122-212,
classes/Population.py:1771-1839). Every 100 steps: the frozen-storm regrow
of the event window (at most 3 regrows, capped at n_cap/4; the runner is
rebuilt, nothing is recompiled), the lost-lane telemetry, the escape
repair, the residue and the particle_data.txt checkpoint.

It runs on the card unless --device names another device. Like the JAX
driver, it takes the fused v2 step wherever the configuration is eligible
and the general v1 step elsewhere (sim/fused.py v2_eligible), logging why
(nanokappa_tpu/driver.py:325-330); the v1 step has no deferred RTA, so
nothing is finalised before a particle_data.txt write. Every reservoir
scheme runs ('fixed_rate' and 'constant' on the autosized copy lattice).
With a ShardComm (parallel/sharding.py) the Simulation is one rank of a
sharded run: it builds the global initial state from the run's seed and
keeps its segment, its step sums reduce over the ranks once a step, and
rank 0 writes every result file, the particles of every rank gathered to
it. `python -m nanokappa_torch.cli --n_shards S` starts the S ranks
(parallel/launch.py; 0 = one, as in the JAX driver); a Simulation
built without a comm is one shard. Under --fig_plot the particle scatter
figures are refreshed at every checkpoint (visual.py runtime_figures;
matplotlib is imported there only, and a failed plot never stops the run).
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import fields, replace
from types import SimpleNamespace

import numpy as np
import torch

from nanokappa_torch.constants import EVPSA2_IN_WM2
from nanokappa_torch.geometry.device import build_device_geometry, resolve_device
from nanokappa_torch.geometry.domain import BC, Domain, build_domain
from nanokappa_torch.io import writers
from nanokappa_torch.io.config import write_arguments_file
from nanokappa_torch.io.trace import PhaseTimer, trace
from nanokappa_torch.material import load_material
from nanokappa_torch.material.tables import Material, bose_einstein
from nanokappa_torch.native import CheckpointFormatter, checkpoint_threads, usable_cores
from nanokappa_torch.parallel.sharding import build_sharded_step, shard_seed, shard_state
from nanokappa_torch.sim.boundary_tables import (
    build_boundary_tables, write_specular_correspondences,
)
from nanokappa_torch.sim.fused import (
    event_window, make_finalize, v2_fallback_reason,
)
from nanokappa_torch.sim.kappa import kappa_connections, kappa_slice
from nanokappa_torch.sim.repair import make_contains_check
from nanokappa_torch.sim.reservoir import (
    autosize_c_max, autosize_inj_cap, build_reservoir_tables,
)
from nanokappa_torch.sim.state import (
    C_ALIVE, C_DEV, C_MODE, C_SV, SimParams, init_state, particle_count, round_pool_cap,
)
from nanokappa_torch.sim.step import StepOutputs


def parse_max_time(s: str) -> float:
    """'D-HH:MM:SS' -> seconds; 0-00:00:00 disables (returns inf)."""
    days, hms = s.split("-") if "-" in s else ("0", s)
    h, m, sec = (int(x) for x in hms.split(":"))
    total = int(days) * 86400 + h * 3600 + m * 60 + sec
    return float("inf") if total == 0 else float(total)


def material_from_args(args) -> Material:
    """Load the material exactly as the driver does (shared with the offline
    postprocess entry, visual.py postprocess_folder). Multi-material runs
    are rejected, as in the JAX package (nanokappa_tpu/driver.py:49): the
    reference's multi-material path is dead code."""
    sv_mat = [str(x) for x in getattr(args, "subvol_material", []) or []]
    if len(set(sv_mat)) > 1 or len(args.mat_folder) > 1:
        raise SystemExit(
            "ERROR: multi-material simulations (--subvol_material with "
            "distinct indices / multiple --mat_folder entries) are not "
            "supported. Run one material per simulation."
        )
    rotation = None
    if len(args.mat_rotation) >= 4:
        rotation = (
            [float(x) for x in args.mat_rotation[1:4]],
            str(args.mat_rotation[4]) if len(args.mat_rotation) > 4 else "xyz",
        )
    return load_material(
        args.mat_folder[0], args.hdf_file[0], args.poscar_file[0],
        isotope_scattering=0 in list(args.isotope_scat), rotation=rotation,
    )


def domain_from_args(args) -> Domain:
    """Build the domain exactly as the driver does (shared with the offline
    postprocess entry)."""
    rot = None
    gr = list(args.geo_rotation)
    if len(gr) >= 4 and any(float(x) != 0 for x in gr[:-1]):
        rot = ([float(x) for x in gr[:-1]], str(gr[-1]))
    return build_domain(
        geometry=str(args.geometry[0]).replace("cuboid", "box"),
        dimensions=[float(d) for d in args.dimensions],
        scale=[float(s) for s in args.scale],
        rotation=rot,
        subvolumes=tuple(args.subvolumes),
        bound_pos=tuple(args.bound_pos),
        bound_cond=tuple(args.bound_cond),
        bound_values=tuple(args.bound_values),
        connect_pos=tuple(args.connect_pos),
        volume_algo=str(getattr(args, "subvol_volume_algo", ["mc"])[0]),
    )


N_DT_TO_CONV = 10  # timesteps per convergence datapoint (Population.py:41)
CONV_BATCH = 10  # datapoints per host read
MAX_REGROWS = 3  # event-window regrows of one run
# the pool rows host_state() reads, in the order of its host copy
HOST_ROWS = (0, 1, 2, C_MODE, C_SV, C_DEV, C_ALIVE)


def host_outputs(out: StepOutputs) -> StepOutputs:
    """StepOutputs as NumPy arrays, in ONE device-to-host copy: every field
    flattened into one float64 vector (the integer counts stay exact)."""
    fs = [getattr(out, f.name) for f in fields(StepOutputs)]
    flat = torch.cat([t.reshape(-1).double() for t in fs]).cpu().numpy()
    parts, o = {}, 0
    for f, t in zip(fields(StepOutputs), fs):
        n = t.numel()
        a = flat[o:o + n].reshape(tuple(t.shape))
        parts[f.name] = a if t.is_floating_point() else a.astype(np.int64)
        o += n
    return StepOutputs(**parts)


class Simulation:
    """Everything assembled from parsed args; run() is the main loop."""

    def __init__(self, args, material: Material | None = None, comm=None):
        self.args = args
        self.comm = comm
        self.writes = comm is None or comm.rank == 0  # rank 0 writes the files
        self.timer = timer = PhaseTimer()
        # an unindexed --results_folder arrives as a list (the CLI indexes
        # it first, io/config.py generate_results_folder)
        folder = args.results_folder
        if isinstance(folder, (list, tuple)):
            folder = folder[0] if len(folder) else os.getcwd()
        self.folder = str(folder)
        os.makedirs(self.folder, exist_ok=True)
        if self.writes:
            write_arguments_file(args, self.folder)
        n_shards = 1 if comm is None else comm.size
        asked = int(args.n_shards[0])
        if asked > 1 and asked != n_shards:
            raise ValueError(
                f"--n_shards {asked} runs {asked} ranks: start them with "
                f"python -m nanokappa_torch.cli or parallel/launch.py launch, "
                f"each with its ShardComm"
            )
        self.device = resolve_device(args.device[0]) if comm is None else comm.device

        # --- material -------------------------------------------------------
        with timer.phase("setup_material"):
            if material is None:
                material = material_from_args(args)
        self.material = material

        # --- geometry -------------------------------------------------------
        with timer.phase("setup_domain"):
            self.domain = domain_from_args(args)
            self.geo = build_device_geometry(self.domain, self.device)

        # --- parameters -----------------------------------------------------
        n_p, rho = particle_count(tuple(args.particles), material, self.domain)
        self.n_p_target = n_p
        dom = self.domain
        res_T = dom.res_values[dom.bound_cond[dom.res_facets] == BC.TEMPERATURE]
        ref = str(args.reference_temp[0])
        t_ref = (float(res_T.mean()) if len(res_T) else 300.0) if ref == "local" else float(ref)
        dt = float(args.timestep[0])
        res_gen = str(args.reservoir_gen[0])
        with timer.phase("setup_reservoirs"):
            self.rtab = build_reservoir_tables(material, dom, dt, rho, device=self.device)
        self.params = SimParams(
            dt=dt,
            n_cap=round_pool_cap(int(n_p * float(args.pool_margin[0])), n_shards),
            inj_cap=autosize_inj_cap(self.rtab, n_shards),
            # c_max autosized so the per-(reservoir, mode) loop can hold the
            # highest entry rate of one shard
            c_max=autosize_c_max(self.rtab, n_shards) if res_gen in ("constant", "fixed_rate") else 3,
            energy_normal=str(args.energy_normal[0]),
            temp_interp=str(args.temp_interp[0]),
            res_gen=res_gen,
            scat_model=str(args.bound_scat[0]),
            particle_density=rho,
            n_active_modes=material.n_active_modes,
            t_reference=t_ref,
            evt_cap=int(getattr(args, "evt_cap", [0])[0]),
            n_shards=n_shards,
        )

        # --- tables ---------------------------------------------------------
        with timer.phase("setup_boundary_tables"):
            self.btab = build_boundary_tables(
                material, dom, self.params.scat_model, device=self.device
            )
        if self.writes:
            write_specular_correspondences(self.btab, material, dom, self.folder)
        self.mtab = material.device_tables(self.device)

        # --- state ----------------------------------------------------------
        part_dist = str(args.part_dist[0])
        kw = {}
        if part_dist not in ("random_domain", "center_domain", "random_subvol", "center_subvol"):
            # resume from a particle_data.txt
            modes_qj, positions, occupation = writers.read_particle_data(part_dist)
            kw = dict(
                positions=positions,
                modes=material.mode_index(modes_qj[:, 0], modes_qj[:, 1]).astype(np.int32),
                occupation=occupation,
            )
            n_p = len(occupation)
            part_dist = "random_domain"
        with timer.phase("setup_state"):
            # a rank builds the global state on the host and keeps its
            # segment (the JAX driver's init_state + shard_state)
            self.state = init_state(
                material, dom, self.geo, self.params, n_p, self.btab,
                temp_dist=str(args.temp_dist[0]),
                part_dist=part_dist,
                subvol_temp=[float(t) for t in args.subvol_temp],
                seed=int(args.seed[0]),
                empty_subvols=[int(i) for i in args.empty_subvols],
                host_only=comm is not None,
                **kw,
            )
            self.state = shard_state(self.state, comm, self.geo, dt)

        # kappa path (reference --path_points / snap_path,
        # classes/Geometry.py:1070-1188)
        self.kappa_path = None
        if len(args.path_points) > 1:
            pts = np.asarray(args.path_points[1:], dtype=float).reshape(-1, 3)
            if args.path_points[0] == "relative":
                pts = pts * np.ptp(dom.bounds, axis=0) + dom.bounds[0]
            self.kappa_path = dom.find_path(pts)
            self.path_cons = dom.path_connections(self.kappa_path)

        # --- step programs ----------------------------------------------------
        self._build_runners()

        # --- convergence machinery ------------------------------------------
        self.conv_crit = float(args.conv_crit[0])
        self.conv_count_min = int(args.conv_crit[1])
        self.n_mean = int(args.n_mean[0])
        self.window: deque = deque(maxlen=self.n_mean)
        self.conv_count = 0
        self.finish_sim = False
        self.max_residue = 1.0
        self.max_residue_qt = "none"
        self.old_mean = None
        self.current_timestep = 0
        self.res_T_pad = res_T if len(res_T) >= 2 else np.array([300.0, 300.0])
        self.evt_regrows = 0
        self._frozen_prev = 0
        self._lost_prev = np.zeros(3, np.int64)

        # escape self-healing from a pool of interior points (reference
        # contains_check, classes/Population.py:1712-1722)
        interior = dom.mesh.sample_volume(1 << 13, np.random.default_rng(1))
        self.contains_check = make_contains_check(
            self.geo, torch.as_tensor(interior, dtype=torch.float32, device=self.device), dt
        )
        self._repair_gen = torch.Generator(device=self.device).manual_seed(
            shard_seed(int(args.seed[0]) + 777, 0 if comm is None else comm.rank)
        )
        self.n_escaped_total = 0
        self._host_cache = None  # (step, gathered particles) of a sharded run
        self._host_rows = None  # host copy of the pool's HOST_ROWS, made at first use
        # the occupation at T_ref of every mode, as occupation_of adds it
        self._checkpoint = CheckpointFormatter(
            bose_einstein(self.params.t_reference, material.omega.reshape(-1)),
            material.n_branches,
        )
        self._cores = None  # usable host cores, read at the first checkpoint
        self.checkpoint_threads = 0  # threads of the last checkpoint's formatting

        self.conv_writer = writers.ConvergenceWriter(
            self.folder, dom.n_of_subvols, dom.n_of_reservoirs, dom.subvol_type,
            dom.subvol_connections,
        ) if self.writes else None

    # ------------------------------------------------------------------ run

    def _build_runners(self):
        """The batched runner (CONV_BATCH datapoints per call), the lazily
        built 1-datapoint tail runner and the finaliser for the current
        parameters: the v2 step's applies its pending deferred RTA, the v1
        step has none. On the v1 step the reason is logged."""
        self.run_steps = self._runner(CONV_BATCH)
        self._run_tail = None
        self.v1_reason = v2_fallback_reason(self.geo, self.params)
        if self.v1_reason is None:
            self._finalize = make_finalize(self.geo, self.mtab, self.params)
        else:
            self._say(f"NOTE: running the v1 step (no fused drift kernel): {self.v1_reason}")
            self._finalize = lambda s: s

    def _runner(self, n_outer: int):
        return build_sharded_step(
            self.geo, self.mtab, self.btab, self.rtab, self.params, self.comm,
            n_inner=N_DT_TO_CONV, n_outer=n_outer,
        )

    def _say(self, msg: str):
        """Print on rank 0 (every rank holds the same outputs)."""
        if self.writes:
            print(msg, flush=True)

    def _rebuild_step(self, evt_cap: int):
        """Rebuild the runners with a wider event window (frozen-storm
        adaptation). The state carries over unchanged: only buffer widths
        inside the step grow."""
        self.params = replace(self.params, evt_cap=evt_cap)
        self._build_runners()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _observe(self, out):
        """One convergence datapoint from host StepOutputs."""
        dom = self.domain
        T = np.asarray(out.T_sv, dtype=float)
        E = np.asarray(out.E_sv, dtype=float)
        phi = np.asarray(out.phi_sv, dtype=float)
        Np = np.asarray(out.Np_sv, dtype=int)
        # reservoir ledgers, normalised like adjust_reservoir_balance
        # (classes/Population.py:1685-1693)
        mat = self.material
        dens = self.params.particle_density
        areas = dom.mesh.facet_areas[dom.res_facets]
        eb = np.asarray(out.res_energy_balance, dtype=float)
        hf = np.asarray(out.res_heat_flux, dtype=float)
        scale = mat.n_active_modes / (dens * self.params.dt * N_DT_TO_CONV)
        eb = eb * scale / (mat.n_qpoints * mat.volume_unitcell)
        hf = hf * (scale / np.maximum(areas, 1e-300))[:, None] / (
            mat.n_qpoints * mat.volume_unitcell
        ) * EVPSA2_IN_WM2

        row = dict(T=T, E=E, phi=phi, Np=Np, eb=eb, hf=hf,
                   total_energy=float(out.total_energy),
                   N_p=int(out.N_p), lost=int(out.lost),
                   lost_split=np.asarray(out.lost_split, dtype=int).reshape(-1),
                   frozen=int(out.frozen))
        if dom.subvol_type == "slice":
            ksv, ktot = kappa_slice(
                T, phi, Np, self.res_T_pad,
                float(np.ptp(dom.bounds[:, dom.slice_axis])), dom.slice_axis,
            )
            row["kappa_sv"] = ksv
            row["kappa_total"] = ktot
        else:
            row["kappa_con"] = kappa_connections(
                T, phi, dom.subvol_center, dom.subvol_connections
            )
        return row

    def _write_convergence(self, row):
        if self.conv_writer is None:
            return
        self.conv_writer.write_row(
            self.current_timestep,
            self.current_timestep * self.params.dt,
            row["total_energy"],
            row["eb"], row["hf"], row["N_p"],
            row["T"], row["E"], row["phi"], row["Np"],
            kappa_sv=row.get("kappa_sv"),
            kappa_total=row.get("kappa_total"),
            kappa_con=row.get("kappa_con"),
        )

    def _update_residue(self):
        """Rolling means over the window; residue vs the previous check
        (classes/Population.py:1797-1830)."""
        dom = self.domain
        W = list(self.window)
        T = np.stack([w["T"] for w in W])
        eb = np.stack([w["eb"] for w in W])
        if dom.subvol_type == "slice":
            phi = np.stack([w["phi"][:, dom.slice_axis] for w in W])
            k = np.stack([w["kappa_sv"] for w in W])
        else:
            phi = np.stack([w["phi"].reshape(-1) for w in W])
            k = np.stack([w["kappa_con"] for w in W])
        names = (
            [f"T_{i}" for i in range(T.shape[1])]
            + [f"phi_{i}" for i in range(phi.shape[1])]
            + [f"en_res_{i}" for i in range(eb.shape[1])]
            + [f"k_{i}" for i in range(k.shape[1])]
        )
        mean = np.concatenate([T.mean(0), phi.mean(0), eb.mean(0), np.nanmean(k, axis=0)])
        std = np.concatenate([T.std(0), phi.std(0), eb.std(0), np.nanstd(k, axis=0)])
        if self.old_mean is None:
            self.old_mean = np.ones_like(mean)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            residue = np.abs((mean - self.old_mean) / self.old_mean)
        residue = np.where(std > np.abs(mean), 0.0, residue)
        self.max_residue = float(np.nanmax(residue))
        self.max_residue_qt = names[int(np.nanargmax(np.nan_to_num(residue)))]
        self.old_mean = mean
        if self.writes:
            writers.append_residue(self.folder, residue)

        if self.max_residue < self.conv_crit:
            self.conv_count += 1
        else:
            self.conv_count = 0
        if self.conv_count >= self.conv_count_min:
            self.finish_sim = True
        return mean, std

    def _regrow_if_frozen(self, last_row):
        """Frozen-storm detection: `frozen` counts boundary events postponed
        because the event window overflowed. More than 1% of the pool in the
        last 100 steps doubles the window (at most MAX_REGROWS times, capped
        at n_cap/4) and rebuilds the runners. On a sharded run the frozen
        count is the ranks' sum, so every rank rebuilds together."""
        frozen_now = int(last_row["frozen"]) if last_row else 0
        d_frozen = frozen_now - self._frozen_prev
        self._frozen_prev = frozen_now
        if d_frozen <= 0.01 * self.params.n_cap:
            return
        cur = event_window(self.geo, self.mtab, self.btab, self.params)
        new_cap = min(2 * cur, self.params.n_cap // 4)
        if self.evt_regrows < MAX_REGROWS and new_cap > cur:
            self.evt_regrows += 1
            self._say(f"NOTE: {d_frozen} boundary events frozen in the last 100 steps "
                      f"(event window overflow) — growing evt_cap {cur} -> {new_cap} "
                      f"(regrow {self.evt_regrows}/{MAX_REGROWS})")
            self._rebuild_step(evt_cap=new_cap)
        else:
            self._say(f"WARNING: {d_frozen} boundary events frozen in the last 100 steps "
                      f"(event window overflow at evt_cap {cur}) — rerun with a larger "
                      f"evt_cap")

    def _report_lost(self, last_row):
        """Name the mechanism whenever the population loses lanes."""
        ls_now = last_row["lost_split"]
        d_lost = ls_now - self._lost_prev
        self._lost_prev = ls_now.copy()
        for d, name, hint in zip(
            d_lost,
            ("capacity drops (injection clip / pool full)",
             "k_max-stuck quarantined lanes",
             "defective lanes (ray cast found no boundary)"),
            ("increase --particles margin or pool capacity",
             "increase k_max (deep reflection chains)",
             "check the geometry for open seams"),
        ):
            if d > 0:
                self._say(f"WARNING: lost {int(d)} particles in the last 100 steps to "
                          f"{name} — {hint}")

    def run(self, verbose: bool = True, profile_dir: str | None = None):
        args = self.args
        timer = self.timer
        iterations = int(args.iterations[0])
        max_seconds = parse_max_time(str(args.max_sim_time[0]))
        t_start = time.time()
        last_row = None
        profiled = False
        while (
            self.current_timestep < iterations
            and not self.finish_sim
            and not self._out_of_time(time.time() - t_start, max_seconds)
        ):
            if iterations - self.current_timestep >= N_DT_TO_CONV * CONV_BATCH:
                runner, nb = self.run_steps, CONV_BATCH
            else:
                # iteration counts that do not divide by the batch finish on
                # a 1-datapoint runner (built on first need)
                if self._run_tail is None:
                    self._run_tail = self._runner(1)
                runner, nb = self._run_tail, 1
            prof = (
                profile_dir
                if (profile_dir and self.writes and not profiled and self.current_timestep > 0)
                else None
            )
            with trace(prof):
                with timer.phase("device_step"):
                    self.state, outs = runner(self.state)
                    self._sync()
            profiled = profiled or prof is not None
            with timer.phase("host_observe"):
                outs_host = host_outputs(outs)  # one device-to-host copy
                for i in range(nb):
                    out = outs_host if nb == 1 else StepOutputs(
                        **{f.name: getattr(outs_host, f.name)[i] for f in fields(StepOutputs)}
                    )
                    self.current_timestep += N_DT_TO_CONV
                    row = self._observe(out)
                    self.window.append(row)
                    self._write_convergence(row)
                    last_row = row
            if self.current_timestep % 100 == 0:
                self._regrow_if_frozen(last_row)
                self._report_lost(last_row)
                with timer.phase("repair"):
                    # each rank repairs its own lanes; the count is summed
                    self.state, n_esc = self.contains_check(self.state, self._repair_gen)
                    if self.comm is not None:
                        (n_esc,) = self.comm.reduce_sums(n_esc)
                    self.n_escaped_total += int(n_esc)
                self._update_residue()
                # periodic checkpoint + figures (reference run_timestep,
                # classes/Population.py:1729-1735)
                self.write_final_state()
                if len(args.fig_plot) and self.writes:
                    try:
                        from nanokappa_torch.visual import runtime_figures

                        runtime_figures(self)
                    except Exception:
                        pass
                if verbose and self.writes:
                    info = "Timestep {:>5d} - max residue: {:>9.3e} ({:<9s}) [".format(
                        self.current_timestep, self.max_residue, self.max_residue_qt
                    )
                    for t in row["T"]:
                        info += " {:>7.3f}".format(t)
                    info += " ]"
                    print(info, flush=True)
        self.write_final_state()
        if verbose and self.writes:
            print(timer.report(checkpoint_threads=self.checkpoint_threads), flush=True)
        return last_row

    def _out_of_time(self, elapsed: float, max_seconds: float) -> bool:
        """--max_sim_time reached? On a sharded run rank 0's clock decides
        for every rank (one all-reduce a batch, only under a time limit)."""
        if max_seconds == float("inf"):
            return False
        if self.comm is None:
            return elapsed >= max_seconds
        over = torch.tensor([float(elapsed >= max_seconds and self.comm.rank == 0)],
                            dtype=torch.float64, device=self.device)
        return bool(self.comm.reduce_sums(over)[0].item())

    # -------------------------------------------------------------- outputs

    def host_state(self) -> SimpleNamespace | None:
        """The finalised particles on the host (the pending deferred RTA
        applied on a copy, as particle_data.txt is written): `alive` (N,)
        bool, `mode`, `dev`, `sv_col` (N,) and `pos` (N, 3) of every pool
        lane, and `T_sv`. Only the pool rows these read are copied, into
        one host buffer (pinned for a card's pool) that the next call
        overwrites. On a sharded run every rank must call it (a gather):
        rank 0 gets the alive particles of every rank, in rank order, and
        the other ranks None; a second call within one step (the figures
        after a checkpoint) returns the first one's without a collective."""
        if self.comm is not None:
            if self._host_cache is None or self._host_cache[0] != self.current_timestep:
                self._host_cache = (self.current_timestep, self._gather_host_state())
            return self._host_cache[1]
        s = self._finalize(self.state)
        rows = self._copy_host_rows(s.pool)
        return SimpleNamespace(
            alive=rows[6] > 0.5,
            mode=rows[3].view(np.int32),
            dev=rows[5],
            sv_col=rows[4].view(np.int32),
            pos=rows[0:3].T,
            T_sv=s.T_sv.cpu().numpy(),
        )

    def _copy_host_rows(self, pool: torch.Tensor) -> np.ndarray:
        """The pool's HOST_ROWS as a (7, N) float32 host array: five copies
        (rows 0-2 in one) into a buffer allocated at the first call."""
        n = pool.shape[1]
        buf = self._host_rows
        if buf is None or buf.shape[1] != n:
            buf = self._host_rows = torch.empty(
                (len(HOST_ROWS), n), dtype=pool.dtype, pin_memory=pool.is_cuda
            )
        buf[0:3].copy_(pool[0:3], non_blocking=True)
        for i, r in enumerate(HOST_ROWS[3:], start=3):
            buf[i].copy_(pool[r], non_blocking=True)
        self._sync()
        return buf.numpy()

    def _gather_host_state(self) -> SimpleNamespace | None:
        """host_state of a sharded run: each rank's alive rows [mode, sv,
        x, y, z, dev] (float32 bits) through host memory to rank 0 (gloo
        takes no gather of CUDA tensors; this is the checkpoint path)."""
        s = self._finalize(self.state)
        pool = s.pool
        rows = pool[[C_MODE, C_SV, 0, 1, 2, C_DEV]][:, pool[C_ALIVE] > 0.5]
        got = self.comm.gather_host(rows.T.contiguous().cpu())
        if got is None:
            return None
        a = got.numpy()
        return SimpleNamespace(
            alive=np.ones(len(a), bool),
            mode=np.ascontiguousarray(a[:, 0]).view(np.int32),
            dev=a[:, 5],
            sv_col=np.ascontiguousarray(a[:, 1]).view(np.int32),
            pos=a[:, 2:5],
            T_sv=s.T_sv.cpu().numpy(),
        )

    def occupation_of(self, state) -> np.ndarray:
        """Occupations of a host_state()'s lanes: the deviation plus the
        Bose-Einstein occupation at the reference temperature. Dead lanes
        carry arbitrary mode bits: clipped before the table lookup (callers
        mask by `alive`)."""
        mode = np.clip(np.asarray(state.mode), 0, self.material.n_modes - 1)
        return np.asarray(state.dev, dtype=float) + self._checkpoint.be_table[mode]

    def write_final_state(self):
        """particle_data.txt of the finalised state (the pending deferred RTA
        applied on a copy, so the occupations are the reference's end-of-step
        ones) and the window's subvolume files. Every byte is written before
        it returns; its phases: the host copy (`write_state.copy`), the
        rows' formatting (`write_state.format`) and the file's write
        (`write_state.write`)."""
        with self.timer.phase("write_state"):
            self._write_final_state()

    def _write_final_state(self):
        timer = self.timer
        with timer.phase("write_state.copy"):
            s = self.host_state()
        if not self.writes:
            return
        with timer.phase("write_state.format"):
            if self._cores is None:
                self._cores = usable_cores()
            self.checkpoint_threads = checkpoint_threads(len(s.alive), self._cores)
            body = self._checkpoint(s.mode, s.pos, s.dev, s.alive, self.checkpoint_threads)
        with timer.phase("write_state.write"):
            writers.write_particle_data(
                self.folder, body, self.args.hdf_file, self.args.poscar_file
            )
            self._write_window_files()

    def _write_window_files(self):
        """subvolumes.txt (and the connections' and the kappa path's files
        off slices) over the convergence window."""
        if len(self.window) == 0:
            return
        W = list(self.window)
        T = np.stack([w["T"] for w in W])
        phi = np.stack([w["phi"] for w in W])
        dom = self.domain
        if dom.subvol_type == "slice":
            k = np.stack([w["kappa_sv"] for w in W])
            writers.write_subvolumes(
                self.folder, dom.subvol_center, dom.subvol_volume,
                T.mean(0), T.std(0), phi.mean(0), phi.std(0),
                np.nanmean(k, 0), np.nanstd(k, 0),
                self.args.hdf_file, self.args.poscar_file,
            )
        else:
            writers.write_subvolumes(
                self.folder, dom.subvol_center, dom.subvol_volume,
                T.mean(0), T.std(0), phi.mean(0), phi.std(0),
                None, None, self.args.hdf_file, self.args.poscar_file,
            )
            k = np.stack([w["kappa_con"] for w in W])
            con = dom.subvol_connections
            vec = dom.subvol_center[con[:, 1]] - dom.subvol_center[con[:, 0]]
            dT = T[:, con[:, 1]] - T[:, con[:, 0]]
            n = vec / np.linalg.norm(vec, axis=1, keepdims=True)
            phi_con = np.einsum(
                "wcj,cj->wc", (phi[:, con[:, 0]] + phi[:, con[:, 1]]) / 2, n
            )
            writers.write_subvol_connections(
                self.folder, con, vec, dT.mean(0), dT.std(0),
                phi_con.mean(0), phi_con.std(0), np.nanmean(k, 0), np.nanstd(k, 0),
                self.args.hdf_file, self.args.poscar_file,
            )
        if self.kappa_path is not None and dom.subvol_type != "slice":
            k = np.nanmean(np.stack([w["kappa_con"] for w in W]), axis=0)
            cons = self.path_cons
            centers = dom.subvol_center
            seg_L = np.array([
                np.linalg.norm(centers[self.kappa_path[i + 1]] - centers[self.kappa_path[i]])
                for i in range(len(self.kappa_path) - 1)
            ])
            with np.errstate(divide="ignore", invalid="ignore"):
                # series thermal resistance along the snapped path
                k_path = seg_L.sum() / np.nansum(seg_L / np.abs(k[cons]))
            with open(os.path.join(self.folder, "kappa_path.txt"), "w") as f:
                f.write("# subvolume path: " + " ".join(map(str, self.kappa_path)) + "\n")
                f.write("# connection id, kappa [W/m K]\n")
                for ci in cons:
                    f.write(f"{ci}, {k[ci]:.6e}\n")
                f.write(f"# path kappa (series) = {k_path:.6e} W/m K\n")
