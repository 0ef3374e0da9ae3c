"""The benchmark of nanokappa_torch: one cell, one run.

A cell is an entry of BENCHMARK.json's `workloads`: a configuration
(configs/<config>.json: the deployment's CLI words and material), a
traffic mix (traffic/<traffic>.json: the particles and the pool margin the
general generator below turns into the run's arguments) and the cell's
correctness limits (workloads/<cell>.json). A
per-layer metric is a reader of its own (metrics/<name>.py, `read(ctx)`).
Everything is found by the name BENCHMARK.json gives it.

The system under test is the entry users run:
`nanokappa_torch.driver.Simulation(read_args(argv), material=...).run()`.
Set-up is everything from the process's start through one whole warm-up
batch of 100 steps with its observe, repair and particle_data.txt
checkpoint. The window then runs whole 100-step batches until `seconds`
have passed at the end of a batch's checkpoint; the rate is every alive
particle of every step in the window over the window's whole time. The
harness reads the driver's own PhaseTimer phases (replacing its timer by a
recording one that also ends the loop: the driver's convergence stop never
fires under --conv_crit 0 1), the kernels' launch counters, and with
`trace` a torch.profiler session over the first whole batch of the window.

During the window it captures one whole step of every batch (StepCapture);
after the window it frees the program, then the configuration's check
module (reference/<check>.py) judges the last batch's capture and the
window's datapoints against the plain reference.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import random
import shutil
import sys
import tempfile
import time
from collections import defaultdict
from types import SimpleNamespace

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "nanokappa_tpu")
BATCH = 100  # steps between the driver's checkpoints (driver.py run)
BIG = 10**9  # --iterations: the harness's clock ends the loop
NARROW_LANES = 64  # the narrow rounds' lanes kept a step (the film exports 0-2)


class NoCard(RuntimeError):
    """The cell's cards are not there."""


# ---------------------------------------------------------------------------
# the cell, by name
# ---------------------------------------------------------------------------


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> SimpleNamespace:
    """The cell `name` of root/BENCHMARK.json with its configuration,
    traffic, limits and metrics."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = configs[cell["config"]]
    here = os.path.join(root, os.path.relpath(BENCH, ROOT))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved else [])]
    return SimpleNamespace(
        name=name, cell=cell, chips=int(cell["chips"]),
        config=load_json(os.path.join(root, config["file"])),
        traffic=load_json(os.path.join(here, "traffic", cell["traffic"] + ".json")),
        limits=load_json(os.path.join(here, "workloads", name + ".json"))["limits"],
        end_to_end=e2e, per_layer=per_layer,
        readers={m["name"]: load_reader(os.path.join(here, "metrics", m["name"] + ".py"))
                 for m in per_layer},
    )


def load_reader(path: str):
    """metrics/<name>.py's read(ctx) -> float | None."""
    spec = importlib.util.spec_from_file_location("nkbench_metric_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def config_args(config: dict) -> dict:
    """The configuration's CLI words (what the run and the reference build
    their tables from)."""
    return {k: list(v) for k, v in config["args"].items()}


def cell_argv(config: dict, traffic: dict, seed: int, folder: str, device: str) -> list[str]:
    """The run's CLI words: the configuration's, the traffic's particles
    and pool margin, and the harness's own: no iteration or wall-clock
    limit, no convergence stop, the seed, the results folder, the device."""
    words = []
    for k, v in config_args(config).items():
        words += ["--" + k, *[str(x) for x in v]]
    return words + [
        "--mat_folder", ".", "--hdf_file", "synthetic", "--poscar_file", "synthetic",
        "--particles", "total", str(int(traffic["particles"])),
        "--pool_margin", str(float(traffic["pool_margin"])),
        "--iterations", str(BIG), "--max_sim_time", "0-00:00:00", "--conv_crit", "0", "1",
        "--seed", str(int(seed)), "--results_folder", folder, "--output", "screen",
        "--device", device,
    ]


def raw_material(config: dict, mesh=None):
    """The benchmark's own material input: the synthetic Si-like table at
    the configuration's mesh (reference/material.py), handed to both
    sides."""
    from reference.material import synthetic_material

    m = config["material"]
    n = int(mesh or m["mesh"])
    return synthetic_material(mesh=(n, n, n), preset=m.get("preset", "Si"))


def program_material(raw):
    """The same raw arrays handed to the program's Material."""
    from nanokappa_torch.material.tables import Material

    return Material(
        name=raw.name, qpoints=raw.qpoints.copy(), omega=raw.omega.copy(),
        group_vel=raw.group_vel.copy(), wavevectors=raw.wavevectors.copy(), tau=raw.tau.copy(),
        tau_T=raw.tau_T.copy(), reciprocal_lattice=raw.reciprocal_lattice.copy(),
        volume_unitcell=float(raw.volume_unitcell), data_mesh=raw.data_mesh.copy(),
    )


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


def process_age() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class StepCapture:
    """Captures one whole step of every batch on the timed path, and the
    first pool compaction after it. It stands in for the program's step
    (sim/step.py make_step), its injection (sim/fused.py
    sample_injections), kernel A (ops/megastep.py drift_megastep, looked up
    when the step is built) and kernel B (sim/step.py compact_pool), and
    passes every call on. At step `at` of every 100 it keeps copies of the
    pool at the step's start and end, the step's T_sv, accumulators and
    ledger, the injected rows as kernel A gets them, kernel A's exported
    lanes and the step's outputs: the last copy is one step of the
    window's last batch. With it go the first NARROW_LANES lanes in and out
    of the narrow rounds (sim/fused.py run_event_buffer) at every step of
    that batch."""

    def __init__(self, at: int):
        from nanokappa_torch.ops import megastep
        from nanokappa_torch.sim import fused, step

        self.at = at
        self.calls = 0
        self.cur = None
        self.snap = None
        self.compact = None
        self.compact_armed = False
        self.batch_narrow: list = []
        self.saved = [(step, "make_step", step.make_step), (fused, "sample_injections", fused.sample_injections),
                      (megastep, "drift_megastep", megastep.drift_megastep),
                      (step, "compact_pool", step.compact_pool),
                      (fused, "run_event_buffer", fused.run_event_buffer)]
        self._make, self._inj_f, self._mega_f, self._compact_f, self._evt_f = (x[2] for x in self.saved)
        step.make_step = self._make_step
        fused.sample_injections = self._inj
        megastep.drift_megastep = self._mega
        step.compact_pool = self._compact
        fused.run_event_buffer = self._evt

    def _make_step(self, *a, **k):
        inner = self._make(*a, **k)

        def step(state):
            return self._step(inner, state)

        return step

    def _step(self, inner, state):
        if self.calls % BATCH == 0:
            self.batch_narrow = []  # the narrow rounds of this batch's steps
        take = self.calls % BATCH == self.at
        batch = self.calls // BATCH + 1
        self.calls += 1
        if not take:
            return inner(state)
        import numpy as np

        self.cur = cur = dict(
            batch=batch, pool0=state.pool[:, : state.tail].clone(), tail0=int(state.tail),
            T_sv=state.T_sv.clone(), counter=np.array(state.res_counter, copy=True),
            eb0=state.res_energy_balance.clone(), n_valid=0, dropped=0, narrow=self.batch_narrow,
        )
        try:
            state, out = inner(state)
        finally:
            self.cur = None
        cur.update(pool1=state.pool[:, : state.tail].clone(), tail1=int(state.tail),
                   eb1=state.res_energy_balance.clone(), n_leaving=out.n_leaving.clone())
        self.snap = cur
        self.compact_armed = True
        return state, out

    def _inj(self, *a, **k):
        out = self._inj_f(*a, **k)
        if self.cur is not None:
            self.cur["n_valid"], self.cur["dropped"] = int(out[1]), int(out[3])
        return out

    def _evt(self, rows, vbuf, *a, **k):
        out = self._evt_f(rows, vbuf, *a, **k)
        n = NARROW_LANES
        self.batch_narrow.append((rows[:, :n].clone(), vbuf[:n].clone(), out[0][:, :n].clone()))
        return out

    def _mega(self, pool, T_sv, rta_on, cfg, seed=0):
        cur = self.cur
        if cur is not None:
            t0, nv = cur["tail0"], cur["n_valid"]
            cur["pool_inj"] = pool[:, t0 : t0 + nv].clone()
            cur["tail_inj"] = t0 + nv
        out = self._mega_f(pool, T_sv, rta_on, cfg, seed=seed)
        if cur is not None:
            cur["idx"], cur["counts"], cur["ecap"] = out[1].clone(), out[2].clone(), int(out[0].shape[1])
        return out

    def _compact(self, pool, spare=None):
        if not self.compact_armed:
            return self._compact_f(pool, spare)
        pin = pool.clone()
        out, tail = self._compact_f(pool, spare)
        self.compact = dict(pool_in=pin, pool_out=out.clone(), tail=int(tail))
        self.compact_armed = False
        return out, tail

    def host(self) -> dict | None:
        """The last captured step with its device counts read."""
        if self.snap is None:
            return None
        s = dict(self.snap)
        s["kept"] = int(s.pop("counts")[2])
        s["eb0"], s["eb1"] = s["eb0"].cpu().numpy(), s["eb1"].cpu().numpy()
        s["out"] = dict(n_leaving=s.pop("n_leaving").cpu().numpy())
        return s

    def restore(self):
        for mod, name, f in self.saved:
            setattr(mod, name, f)


class Window:
    """The driver's timer, replaced: it times the window's phases as the
    driver's PhaseTimer does, marks each with a profiler span, and at the
    phases' edges runs the harness (set-up ends with the warm-up batch's
    checkpoint; the window ends with the first checkpoint at or past
    `seconds`; the last batch's pool is kept at its device_step's end)."""

    def __init__(self, sim, seconds: float, trace: bool, t0_wall: float, sync):
        self.sim, self.seconds = sim, seconds
        self.trace_on, self.t0_wall, self.sync = trace, t0_wall, sync
        self.batch = 0  # batches whose device_step ended
        self.setup_s = None
        self.t_open = None  # the window's start (perf_counter)
        self.t_close = None
        self.updates = 0.0  # particle-timesteps in the window
        self.steps = 0
        self.rows: list = []  # every datapoint of the window
        self.win_phases = defaultdict(list)  # phases of the window's batches
        self.batch_rows = {}  # the datapoints of each batch, by its number
        self.prof = None
        self.prof_batch = None  # the profiled batch's number
        self.trace = None
        self.prof_counters = None
        self.current = 0  # the batch that runs
        self.batch_walls: list = []  # each window batch's wall, checkpoint included
        self.batch_walls_t = None

    @contextlib.contextmanager
    def phase(self, name: str):
        self._enter(name)
        span = None
        if self.prof is not None:
            from torch.profiler import record_function

            span = record_function("nkbench." + name)
            span.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if span is not None:
                span.__exit__(None, None, None)
            if self.t_open is not None and self.t_close is None and self.current > self._first:
                self.win_phases[name].append(dt)
            self._exit(name)

    @property
    def _first(self) -> int:
        """The last batch before the measured window (the warm-up; with
        the trace, the profiled batch too)."""
        return 2 if self.trace_on else 1

    def _enter(self, name):
        if name != "device_step":
            return
        self.current = self.batch + 1
        if self.trace_on and self.current == 2 and self.prof is None:
            self._start_profiler()

    def _exit(self, name):
        sim = self.sim
        if name == "device_step":
            self.batch += 1
            return
        if name != "write_state" or self.t_close is not None or self.batch == 0:
            return
        rows = list(sim.window)[-(BATCH // 10):]
        self.batch_rows[self.batch] = rows
        now = time.perf_counter()
        if self.batch == 1:
            self.setup_s = time.time() - self.t0_wall
            self.t_open = now
            return
        if self.prof is not None and self.batch == self.prof_batch:
            self._stop_profiler(rows)
            # the measured window of a traced run starts after the
            # profiled batch (its profiler hooks slow the host)
            self.t_open = time.perf_counter()
            self.batch_walls_t = None
            return
        self.rows.extend(rows)
        self.updates += 10.0 * sum(float(r["N_p"]) for r in rows)
        self.steps += BATCH
        self.batch_walls.append(now - (self.batch_walls_t or self.t_open))
        self.batch_walls_t = now
        if now - self.t_open >= self.seconds:
            self.t_close = now
            sim.finish_sim = True

    def _start_profiler(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof_batch = self.batch + 1
        self.prof_counters = (launch_counts(), self._events())
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def _stop_profiler(self, rows):
        from trace_reader import reduce_session

        self.sync()
        self.prof.__exit__(None, None, None)
        c0, ev0 = self.prof_counters
        c1, ev1 = launch_counts(), self._events()
        self.prof_counters = dict(
            launches={k: c1[k] - c0[k] for k in c1},
            events=[b - a for a, b in zip(ev0, ev1)],
            n_alive=sum(float(r["N_p"]) for r in rows) / max(len(rows), 1),
        )
        self.trace = reduce_session(self.prof, BATCH)
        self.prof = None

    def _events(self):
        """kernel A's cumulative counts [diffused, flagged, swaps, exported]."""
        return [float(x) for x in self.sim.state.kernel_events.tolist()]


def launch_counts() -> dict:
    """The port's kernel launch counters (the CUDA path only)."""
    from nanokappa_torch.ops import compact, compact_pool, megastep

    return {"megastep": megastep.launches, "compact_pool": compact_pool.launches,
            "compact": compact.launches}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def check_module(config: dict):
    """The module under reference/ that judges the configuration (its
    `check` key, reference/check.py by default)."""
    return importlib.import_module("reference." + config.get("check", "check"))


def forbidden_modules() -> list[str]:
    """The JAX packages this process has loaded, by top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             mesh=None, particles=None, control: bool = False, raw=None, log=print) -> dict:
    """One run of cell `name`; returns the result line's dict (with its
    checks under "checks"). `device="cpu"` (tests only) runs the kernels'
    plain paths and reports no measured metric; `mesh` and `particles`
    shrink it there. `control` adds the control's numbers (the reference in
    bfloat16 in the program's place) under "control"; `raw` is a raw
    material already made (several runs in one process)."""
    t0_wall = time.time() - process_age()
    spec = load_cell(name)
    import torch

    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise NoCard(f"cell {name} needs {spec.chips} card(s); this machine has {n}")
        torch.cuda.reset_peak_memory_stats()
    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.io.config import read_args

    traffic = dict(spec.traffic)
    if particles is not None:
        traffic["particles"] = particles
    tmp_root = os.environ.get("TMPDIR") or tempfile.gettempdir()
    folder = tempfile.mkdtemp(prefix=f"nkbench-{name}-", dir=tmp_root)
    rng = random.Random(seed)
    capture = StepCapture(at=10 * rng.randrange(BATCH // 10) + 9)
    sim = None
    try:
        raw = raw if raw is not None else raw_material(spec.config, mesh)
        mat = program_material(raw)
        sim = Simulation(read_args(cell_argv(spec.config, traffic, seed, folder, device)), material=mat)

        def sync():
            if on_card:
                torch.cuda.synchronize()

        win = Window(sim, seconds, trace, t0_wall, sync)
        sim.timer = win
        sim.run(verbose=False)
        sync()
        wall = (win.t_close or time.perf_counter()) - win.t_open
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"modules {found} were loaded by the run: the benchmark imports no JAX")
        layout = sim.state.layout
        ctx_static = dict(layout_rows=int(sim.state.pool.shape[0]), n_subvols=int(sim.geo.n_subvols),
                          n_triangles=0 if sim.geo.is_box else int(sim.geo.tri_origin.shape[0]))
        step = capture.host()
        row = None
        if step is not None and step["batch"] in win.batch_rows:
            row = win.batch_rows[step["batch"]][capture.at // 10]
        snaps = dict(step=step, row=row, rows=win.rows, compact=capture.compact)
    finally:
        capture.restore()
        shutil.rmtree(folder, ignore_errors=True)
    updates_per_s = win.updates / wall if wall > 0 else None
    log(f"window: {win.steps} steps in {wall:.3f} s, {win.updates:.6g} particle-steps, "
        f"set-up {win.setup_s:.3f} s, step captured: {capture.at} of batch "
        f"{None if step is None else step['batch']}; "
        f"batch walls {[round(w, 4) for w in win.batch_walls]}; phases "
        f"{ {k: round(sum(v), 4) for k, v in win.win_phases.items()} }", file=sys.stderr)

    ctx = SimpleNamespace(phases=dict(win.win_phases), steps=win.steps, trace=win.trace,
                          counters=win.prof_counters, **ctx_static)
    metrics = {}
    if trace:
        for m in spec.per_layer:
            v = spec.readers[m["name"]](ctx) if on_card else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        log(f"traced run: updates/s {updates_per_s} over the window after the profiled batch",
            file=sys.stderr)
    else:
        values = {"updates_per_s": updates_per_s, "setup_s": win.setup_s}
        for m in spec.end_to_end:
            v = values.get(m["name"]) if on_card else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": spec.chips if on_card else 0, "memory_peak_bytes": int(peak)}
    if trace and on_card and win.trace is not None:
        dev_info["busy_s"] = win.trace.busy_s
        dev_info["window_s"] = win.trace.window_s

    # the program is freed before the reference runs (the peak is read)
    win.sim = None
    del sim
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    chk = check_module(spec.config)
    t_ref = time.perf_counter()
    ref = chk.Reference(config_args(spec.config), raw, int(traffic["particles"]), device)
    nums = chk.judge(ref, snaps, log=lambda m: log(m, file=sys.stderr))
    ok = chk.verdict(nums, spec.limits)
    out = {"correct": bool(ok), "attempted": win.steps, "failed": 0 if ok else win.steps,
           "metrics": metrics, "device": dev_info}
    if trace and win.trace is not None and on_card:
        out["breakdown"] = {"device_ops": win.trace.top_device_ops(),
                            "idle_gaps": win.trace.idle_gaps()}
    if control:
        out["control"] = chk.judge(ref, snaps, control=True)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s; layout {layout}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules {found} were loaded by the check: the benchmark imports no JAX")
    out["checks"] = {k: {"value": nums[k], "limit": spec.limits[k]} for k in spec.limits}
    return out
