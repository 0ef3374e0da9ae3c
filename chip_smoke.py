#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`nanokappa_torch`).

    python3 chip_smoke.py     # film, nanowire, k films, plate, large mesh, star, reservoir
                              # schemes, corrugated wire, the 12-sided wire's eta sweep,
                              # membranes: 1e6 particles, 31^3 table;
                              # the sharded film: 1e7 particles in two ranks

Needs one CUDA card. In order it:
  1. prints the card's name and power limit (nvidia-smi),
  2. builds the hand-written kernels from `nanokappa_torch/csrc` (one nvcc
     call per source, all started together) and the 31^3 material once,
     shared by both paths,
  3. holds each kernel against its plain torch twin ON THE CARD at the
     main paths' shapes — kernel A's film branch (the 18-row slim pool) and
     wire branch (the 16-row plain pool, triangle cast, in-kernel diffuse
     reflection), kernel B on both pools, kernel C at the 'constant'
     lattice's width and at the survivor widths — and times each beside
     its twin, one PyTorch call computing the same function where there is
     one, and its bound (the larger of its bytes over 3.35 TB/s and its
     operations over 67 TFLOP/s of float32); every kernel by its device
     time (device_timed: the calls enqueued behind a spin kernel, so the
     CUDA events time their kernels back to back) and, printed beside it,
     by calls back to back (which include the wrapper's host work where
     that is the longer); every kernel A check also runs two launches on
     one pool (bit for bit alike) and prints its pool's divergence shares
     (lanes whose flight ends at a wall this step, and the 32-lane warps
     holding one),
  4. checks a small film and a small closed wire on the card against the
     plain path on the CPU,
  5. drives the film (pooled reservoirs) and the nanowire ('constant'
     reservoirs) through the library entry (init_state -> build_step ->
     run), each exactly as bench.py:run_config sizes it — 10^6 particles,
     pool = round_pool_cap(1.25 N), n_inner = n_outer = 10, 2 warm-up and
     3 timed runs — with every kernel's launch counter zeroed just before
     and read just after, and checks the physics of each; between the
     two, the same film on the v1 step (step_impl="v1": the plain pool,
     the same seed's particles) for 100 steps, its T_sv held within 0.5 K
     of the v2 film's after its first 100,
  6. drives the film with linear temperatures and the film re-binned by a
     `grid 16 4 4` domain (256 centres) for 100 steps each, kernel A's
     slice/linear and centre/nearest instantiations on the slim pool, both
     held against their twins on the film's pool first,
  7. drives the bench film under the k model (eta = 0 walls, pooled
     reservoirs: mirror-eligible with degenerate partner branches, so on
     kernel A's full 24-row mirror, the split drawn at cache fill) through
     the driver entry, `Simulation(read_args(argv), material=mat).run()`,
     for 500 steps at 10^6 particles, counting the split at initialisation,
     with its physics gates; holds the full branch's box instantiations
     (slice/nearest, slice/linear, centre/nearest) against their twins on
     its pool and kernel B on that 24-row pool; then the k-model,
     linear-temperature film with eta = 2 A walls (off the mirror path)
     like step 5, counting the narrow machinery's degenerate-branch swaps,
     with kernel A's linear in-kernel-diffuse instantiation held against
     its twin on its pool (the full branch's triangle instantiations are
     held on the wire's and the plate's pools with a crafted mirror cache),
  8. drives the perforated plate (BASELINE config 4: a 32-triangle STL
     written into the run's folder, Voronoi 8 subvolumes, 'constant'
     reservoirs) through the driver entry, `Simulation(read_args(argv),
     material=mat).run()`, for 300 steps at 10^6 particles, with its
     physics and result-file gates, and holds kernel A's nearest-centre
     instantiation against its twin on its pool,
  9. drives the large mesh (bench.py:build_bigmesh_ctx: a 96-sided
     cylinder, 384 triangles, 'constant' reservoirs; kernel A with
     kernel_cast off and kernel E) through the driver entry a user runs,
     `Simulation(read_args(argv), material=mat).run()`, for 500 steps at
     10^6 particles into a temporary results folder, the counters zeroed
     just before the Simulation is built and read after its run; checks its
     physics and its result files, then holds kernel E (on the run's
     1,277,952-lane pool, at the injection width and at the event width)
     and the cast-off branch of kernel A against their twins on that
     context (kernel E also at the narrow rounds' width, each width at
     its launch shape, G threads a ray),
 10. drives the star (examples/voronoi_star.txt as written: a 6-point
     star, 12 Voronoi cells, radial temperatures, so the v1 step) through
     the driver entry for 500 steps at 10^6 particles, with the counters
     zeroed just before the Simulation is built, and checks its physics,
     that kernel D ran once a step, and its result files; then holds
     kernel D (on the star's own event buffer: kernel C's compaction of
     the lanes the next drift stops at a facet, rows perturbed; and on a
     sentinel-only buffer) and kernel C at the v1 width (1,277,952 ->
     79,872) against their twins, timed beside `index_copy_` and
     `torch.nonzero` + fill; D also with a cold L2, beside the floor of
     the 32-byte sectors it touches,
 11. drives three configurations through the driver entry for 300 steps
     each at 10^6 particles, each with its physics gates, its ms/step,
     updates/s, set-up time and driver phases: the Ge film (BASELINE config
     2, the synthetic 31^3 Ge table) under 'fixed_rate' (its mean
     injections a step within 5 sigma of sum(enter_prob)), then kernel C on
     a 'fixed_rate' lattice of its tables; the bench film under
     'one_to_one' (one sub-block of single steps on a copy of its state:
     every step injects the previous step's n_leaving, clipped at
     inj_cap // R, the clip counted), then kernel C on its (R, inj_cap // R)
     blocks; each film's ms/step under its scheme and under 'constant' /
     'pooled' on copies of its state; and the corrugated wire of
     examples/corrugated_wire.txt (40 wall-table rows, kernel A's partner
     mask in two words), then kernel A on its pool against its twin and the
     rough hits on rows >= 32 split into specular and diffuse,
 12. (m) BASELINE config 3, the specularity sweep of tests/test_nanowire.py:
     the 12-sided wire (48 triangles; under the velocity model its 45 and
     135 degree walls, 4 of 12 table rows, have specular partners, the
     rest none; the coverage of every row printed first) at eta = 0, 2
     and 10 A through the driver entry, 300 steps each, kappa the mean of
     the last 10 10-step blocks with its standard error: kappa(0) >
     kappa(2) > kappa(10) > 0, neighbours 3 standard errors apart or more,
     kappa(10) / kappa(0) printed beside the JAX test's 0.8, the wire's
     gates at every eta; at eta = 0 the specular and diffuse hits per row
     over three kernel A launches on its pool (specular on every covered
     row and on no other), then kernel A on that pool against its twin
     (the partial mask); (n) the membrane box of tests/test_interfaces.py
     (doubled sheets through an STL): (n1) every facet at eta = 10 A, no
     reservoirs, 300 single v2 steps through the library entry with every
     lane followed from step to step: each side's lanes the initial
     state's once the removed lanes and those that changed side are
     counted, every side change within a step's reach of the membrane's
     rim (the reference cast's backward slack and edge ties) and under
     1e-7 per particle-step, frozen 0; (n3) kernel A's
     two-sided branch on its pool against its twin, the membrane's diffuse
     hits of a launch split by side, none re-emitted through the wall;
     (n2) reservoirs at 305 / 295 K and the eta = 2 A membrane through the
     CLI's entry, nanokappa_torch.cli.main, 300 steps: population within
     5%, lost <= 2% of N, the 4 slices' T_sv falling,
 13. the sharded film (nanokappa_torch/parallel): (a) an NCCL world of
     one rank on the card, 10 v2 steps of the bench film through
     build_sharded_step bit for bit against build_step from one state and
     seed; (b) two gloo ranks on cuda:0 (NCCL refuses two ranks on one
     GPU), the film at 10^7 particles through the driver entry,
     `Simulation(read_args(argv), material=mat, comm=comm).run()`, for 300
     steps, with each rank's launch counters zeroed just before its
     Simulation is built: nothing lost, the population within 5%, T_sv in
     (298, 302) falling hot to cold and within 0.5 K of the 10^6 film of
     step 5 at step 300, T_sv bit-identical on both ranks, A, B and C
     launched on each, the ranks' first in-kernel seeds different; per rank
     its set-up time, ms/step and the host time of its all-reduce; (c) with
     two cards or more, (b) over NCCL with one rank a card (else one line
     says it was not run),
 14. splits each kernel A, C and D check's call by kernel name
     (torch.profiler) and counts its kernel launches a call (kernel C's
     must be 1 at every width), last: a profiler session can leave hooks
     that add host time to every later launch, and the main paths are
     host-bound.
Any failed check raises (non-zero exit). The last lines are the card line,
one JSON line with the kernels' numbers, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

# the configurations exactly as bench.py:run_config sizes them: synthetic
# 31^3 table, 10^6 particles, seeded weights and initial state
MESH = 31
PARTICLES = 1e6
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

FILM = dict(
    geometry="box",
    dimensions=(5e3, 1e3, 1e3),
    subvolumes=("slice", 10, 0),
    bound_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5, 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
    bound_cond=("T", "T", "R", "R", "P"),
    bound_values=(302.0, 298.0, 0.0, 0.0),
    connect_pos=("relative", 0.5, -0.1, 0.5, 0.5, 1.1, 0.5),
)
# bench.py:build_wire_ctx: 8-sided cylinder (32 triangles, 10 facets),
# rough eta = 2 A side walls, T caps at 305 / 295 K
WIRE = dict(
    geometry="cylinder",
    dimensions=(4e3, 500.0, 8),
    subvolumes=("slice", 5, 2),
    bound_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1, 1.1, 0.5, 0.5),
    bound_cond=("T", "T", "R", "R"),
    bound_values=(305.0, 295.0, 2.0, 2.0),
    connect_pos=("relative",),
)
# bench.py:build_bigmesh_ctx: the wire's ends and walls on a 96-sided
# cylinder (384 triangles, 98 facets), beyond kernel A's in-kernel cast
BIGMESH = dict(WIRE, dimensions=(4e3, 500.0, 96))
BIG_STEPS = 500
# the bench film with eta = 2 A walls under the k model and linear
# temperatures: off the mirror path (specularity < 1), kernel A's plain
# in-kernel-diffuse pool on the box cast
KFILM = dict(FILM, bound_values=(302.0, 298.0, 2.0, 2.0))
# the perforated plate of tests/test_porous.py (BASELINE config 4):
# 3000 x 3000 x 1000 A with a 1200 A square hole through z, 32 triangles,
# Voronoi 8, T reservoirs on the two x faces, every other facet rough at
# eta = 5 A (the hole's walls too)
PLATE = dict(
    subvolumes=("voronoi", 8),
    bound_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5),
    bound_cond=("T", "T", "R"),
    bound_values=(304.0, 296.0, 5.0),
    connect_pos=("relative",),
)
PLATE_STEPS = 300
K0_STEPS = 500  # the eta = 0 k film through the driver (full 24-row mirror)
GATE_RTOL = 1e-6  # combined_mirror_rows' involution gate on partner frequencies
GRID = (16, 4, 4)  # the film re-binned: 256 centres, the nearest-centre loop's cap
# examples/voronoi_star.txt as written (6-point star, Voronoi 12, radial T,
# rough eta = 2 A walls, T caps at 305 / 295 K), with 10^6 particles and
# STAR_STEPS steps: it runs the v1 step (kernels C, D and B)
STAR_FILE = "examples/voronoi_star.txt"
STAR_STEPS = 500
STAR_REASON = "temp_interp='radial' on voronoi subvolumes needs the XLA path"
V1_FILM_STEPS = 100  # the bench film on the v1 step, against the v2 film
# the reservoir schemes and the partner mask in words (300 steps each,
# through the driver entry): the Ge film (examples/film_ge.txt's box,
# slices and walls: BASELINE config 2) under 'fixed_rate', the bench film
# under 'one_to_one', and the corrugated wire of
# examples/corrugated_wire.txt (40 wall-table rows, the k model)
NEW_STEPS = 300
CORR_FILE = "examples/corrugated_wire.txt"
# BASELINE config 3, the specularity sweep (tests/test_nanowire.py:22): the
# wire's length, width, slices and caps on a 12-sided cylinder (48
# triangles; its 45 and 135 degree walls, 4 of its 12 table rows, have
# specular partners under the velocity model, the other 8 none), rough
# side walls at each eta of SWEEP_ETAS, 'constant' reservoirs, NEW_STEPS
# steps each through the driver; kappa from the last SWEEP_BLOCKS 10-step
# blocks (the driver's convergence window, --n_mean)
WIRE12 = dict(WIRE, dimensions=(4e3, 500.0, 12))
SWEEP_ETAS = (0.0, 2.0, 10.0)
SWEEP_BLOCKS = 10
JAX_SWEEP_RATIO = 0.8  # tests/test_nanowire.py:68: kappa(10) < 0.8 kappa(0)
# the membrane box of tests/test_interfaces.py:22 (2000 x 1000 x 1000 A, the
# internal wall at x = 1000 A as two coincident sheets, through an STL):
# (n1) every facet rough at eta = 10 A, no reservoirs, two slices (one a
# side), the v2 step; (n2) T reservoirs at 305 / 295 K on the x faces, the
# membrane at eta = 2 A (picked by its interior probe point), the other
# walls eta = 0, four slices, through the CLI
MEMBRANE_TIGHT = dict(subvolumes=("slice", 2, 0), bound_pos=("relative",), bound_cond=("R",),
                      bound_values=(10.0,), connect_pos=("relative",))
MEMBRANE_TRANSPORT = dict(
    subvolumes=("slice", 4, 0),
    bound_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5, 0.5, 0.5, 0.5),
    bound_cond=("T", "T", "R", "R"), bound_values=(305.0, 295.0, 2.0, 0.0), connect_pos=("relative",),
)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def build_ctx(mat, domain_kw: dict, device, scat_model: str = "velocity"):
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables

    dom = build_domain(**domain_kw)
    return (dom, build_device_geometry(dom, device),
            build_boundary_tables(mat, dom, scat_model, device=device))


def run_params(mat, dom, n_particles: float, res_gen: str, device):
    """bench.py:run_config's sizing."""
    from nanokappa_torch.sim.reservoir import (
        autosize_c_max, autosize_inj_cap, build_reservoir_tables,
    )
    from nanokappa_torch.sim.state import SimParams, particle_count, round_pool_cap

    n_p, rho = particle_count(("total", n_particles), mat, dom)
    rtab = build_reservoir_tables(mat, dom, 1.0, rho, device=device)
    params = SimParams(
        dt=1.0,
        n_cap=round_pool_cap(int(n_p * 1.25)),
        inj_cap=autosize_inj_cap(rtab),
        c_max=autosize_c_max(rtab),
        temp_interp="nearest",
        res_gen=res_gen,
        particle_density=rho,
        n_active_modes=mat.n_active_modes,
        t_reference=300.0,
    )
    return n_p, rtab, params


def timed(fn, x, n: int) -> float:
    """Mean milliseconds per call of fn(x) over n calls issued back to back
    between one pair of CUDA events, after one warm-up call: the card's
    queue stays full, so a kernel longer than its host-side enqueue is timed
    without the host's gaps (a shorter one is timed at its call rate)."""
    import torch

    fn(x)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn(x)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_timed(fn, n: int = 20) -> float:
    """Mean milliseconds of device time per call of fn(), over n calls
    between one pair of CUDA events: a spin kernel (torch.cuda._sleep,
    ~2 ms a call) holds the card while the calls are enqueued, so the
    events time their kernels back to back, without the host's gaps."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000 * n)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_timed_cold(fn, n: int = 20) -> float:
    """Mean milliseconds of device time per call of fn() with a cold L2
    (50 MB on the H100): before each call, outside its timed span, a 64 MB
    buffer is read and written; each call has its own pair of CUDA events,
    all enqueued behind a spin kernel."""
    import torch

    flush = torch.zeros(16 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(4_000_000 * n)
    for a, b in ev:
        flush.add_(1.0)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / n


def sector_floor(idx, n_valid: int, C: int, N: int) -> tuple[float, int]:
    """(ms, sectors): kernel D's 32-byte sectors over 3.35 TB/s — the
    sectors its stores touch (each row's distinct sectors among the valid
    lanes), the valid prefix of the rows read and the indices read. The
    byte bound counts 4 B a stored value; a store alone in its sector costs
    the memory a whole sector."""
    import torch

    word = torch.arange(C, device=idx.device)[:, None] * N + idx[:n_valid].long()[None]
    stores = int(torch.unique(word // 8).numel())
    sectors = stores + C * -(-n_valid * 4 // 32) + -(-idx.shape[0] * 4 // 32)
    return sectors * 32 / HBM_BYTES_PER_S * 1e3, sectors


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def float_err(a, b, int_rows) -> tuple[float, str]:
    """Max |a - b| over the float rows (inf and NaN must sit at the same
    places) and whether they are bit-exact; the int rows must be
    bit-equal."""
    import torch

    for r in int_rows:
        if not torch.equal(a[r].view(torch.int32), b[r].view(torch.int32)):
            n = int((a[r].view(torch.int32) != b[r].view(torch.int32)).sum())
            raise AssertionError(f"int row {r} differs in {n} lanes")
    fr = [r for r in range(a.shape[0]) if r not in int_rows]
    if torch.equal(a[fr].view(torch.int32), b[fr].view(torch.int32)):
        return 0.0, "bit-exact"
    x, y = a[fr].double(), b[fr].double()
    same = (x == y) | (torch.isnan(x) & torch.isnan(y))
    if not bool((same | (torch.isfinite(x) & torch.isfinite(y))).all()):
        raise AssertionError("non-finite values at different places")
    d = torch.where(same, 0.0, (x - y).abs())
    # rtol 2e-5 (the expf/expm1f ulps of the occupation math) of each value
    # plus 2e-5 of its row's largest finite magnitude (values near zero)
    fin = torch.where(torch.isfinite(y), y.abs(), 0.0)
    lim = 2e-5 * fin + 2e-5 * fin.max(dim=1, keepdim=True).values
    if not bool((d <= lim).all()):
        raise AssertionError(f"float rows differ by up to {float(d.max())}")
    return float(d.max()), "within rtol 2e-5"


def check_close(name, a, b, rtol, scale):
    """|a - b| <= rtol * |b| + rtol * scale, elementwise."""
    import torch

    d = (a.double() - b.double()).abs()
    lim = rtol * b.double().abs() + rtol * scale
    if not bool((d <= lim).all()):
        raise AssertionError(f"{name}: max |diff| {float(d.max())} over the limit")
    return float(d.max())


def abs_bins(pool, T_sv, cfg):
    """Per-subvolume sums of |e|, |e vx|, |e vy|, |e vz|, 1 over the lanes
    that stay in a drifted pool: the scale of the kernel's bins."""
    import torch

    from nanokappa_torch.constants import HBAR
    from nanokappa_torch.ops.kmath import occupation_delta_T_k
    from nanokappa_torch.sim.state import C_ALIVE, C_DEV, C_OMEGA, C_SV

    alive = pool[C_ALIVE] > 0.5
    sv = pool[C_SV].view(torch.int32).long()
    om = pool[C_OMEGA]
    e = HBAR * om * (pool[C_DEV] - occupation_delta_T_k(T_sv[sv], cfg.t_ref, om))
    e = torch.where(alive, e, 0.0).double()
    vals = torch.stack([e, e * pool[3], e * pool[4], e * pool[5], alive.double()], 1)
    out = torch.zeros((cfg.sv8 + 1, 5), dtype=torch.float64, device=pool.device)
    out.index_add_(0, torch.where(alive, sv, cfg.sv8), vals.abs())
    return out[: cfg.sv8]


def with_fresh(pool, device, frac=0.01, seed=7):
    """A compacted copy of the pool with `frac` of its alive lanes made
    fresh (STALE: the kernel casts them)."""
    import torch

    from nanokappa_torch.ops import compact_pool
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, STALE

    pool_c, _ = compact_pool.compact_pool_plain(pool)
    g = torch.Generator(device=device).manual_seed(seed)
    fresh = (torch.rand(pool_c.shape[1], generator=g, device=device) < frac) & (pool_c[C_ALIVE] > 0.5)
    pool_c[C_CF] = torch.where(
        fresh, torch.tensor(STALE, dtype=torch.int32, device=device).view(torch.float32), pool_c[C_CF],
    )
    return pool_c


def divergence(pool, cfg) -> tuple[float, float]:
    """(lane share, warp share) of a pool before kernel A's launch: the
    alive lanes whose flight ends at a wall in this step (C_TCOLL <= the
    remaining fraction, or fresh: the kernel casts them), and the 32-lane
    warps that hold at least one (each such warp runs the cast and the
    event rounds)."""
    import torch

    from nanokappa_torch.sim.state import C_ALIVE, C_CF, C_REM, C_TCOLL, STALE

    alive = pool[C_ALIVE] > 0.5
    rem = torch.where(pool[C_REM] > 1e-5, pool[C_REM], 1.0)
    t = pool[C_TCOLL]
    if cfg.kernel_cast:
        fresh = pool[C_CF].contiguous().view(torch.int32) == STALE
    else:
        fresh = t < -0.5
        t = torch.where(fresh, -t - 1.0, t)
    ends = alive & (fresh | (t <= rem))
    n = ends.shape[0] // 32 * 32
    return float(ends.float().mean()), float(ends[:n].reshape(-1, 32).any(dim=1).float().mean())


def launch_split(fn, calls: int = 10, counts: dict | None = None) -> dict[str, float]:
    """Mean device microseconds per call of fn, by kernel name
    (torch.profiler); PyTorch's own kernels (the wrapper's output fills)
    under "torch"; `counts`, when given, receives the kernel launches per
    call by the same names. The profiler on the card at times records no
    kernel (an empty split): the times come from device_timed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = getattr(e, "cuda_time_total", 0.0) if t is None else t
        name = "torch" if "at::" in e.key else kernel_name(e.key)
        if t > 0 and name and not name.startswith(("Memcpy", "Memset")):
            out[name] = round(out.get(name, 0.0) + t / calls, 2)
            if counts is not None:
                counts[name] = counts.get(name, 0.0) + e.count / calls
    return out


def kernel_name(key: str) -> str:
    """A profiler kernel key without its return type, namespaces, template
    arguments and parameters: 'void (anonymous namespace)::mega_lanes<...>(...)'
    -> 'mega_lanes'."""
    k = key.replace("(anonymous namespace)::", "")
    k = k[5:] if k.startswith("void ") else k
    k = k.split("<")[0].split("(")[0]
    return k.rsplit("::", 1)[-1].strip()


def same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def check_megastep(name, pool_c, T_sv, cfg, seed, source_ops):
    """Kernel A against its twin on one pool (both RTA flags), two launches
    on copies of the pool bit for bit alike, timed, and its pool's
    divergence shares; the record for the JSON line (launches filled in
    later), with `split`, the call to split by kernel name once every main
    path has run (split_launches)."""
    import torch

    from nanokappa_torch.ops import megastep
    from nanokappa_torch.ops.megastep import R8, SV_CENTER
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, C_MODE, C_ONF, C_SV, R_MMODE

    int_rows = [C_MODE, C_CF, C_ONF, C_SV, C_ALIVE] + ([R_MMODE] if cfg.layout != "plain" else [])
    err, how = 0.0, "bit-exact"
    for rta_on in (False, True):
        pk, pp = pool_c.clone(), pool_c.clone()
        ok_ = megastep.drift_megastep(pk, T_sv, rta_on, cfg, seed=seed)
        op_ = megastep.drift_megastep_plain(pp, T_sv, rta_on, cfg, seed=seed)
        torch.cuda.synchronize()
        if not torch.equal(ok_[2], op_[2]):
            raise AssertionError(f"{name} counts {ok_[2].tolist()} != {op_[2].tolist()}")
        if not torch.equal(ok_[1], op_[1]):
            raise AssertionError(f"{name}: exported indices differ")
        kept = int(op_[2][2])
        for a, b in ((pk, pp), (ok_[0][:, :kept], op_[0][:, :kept])):
            e, h = float_err(a, b, int_rows)
            err, how = max(err, e), (how if h == "bit-exact" else h)
        # sums: float32 sums in another order (the plain twin adds with
        # atomics) differ by up to ~sqrt(n) * eps * sum|x|; the energy
        # column is a signed sum with cancellation, so the bound is on sum|x|
        check_close(f"{name} ledger", ok_[3], op_[3], 1e-5, op_[3].abs().sum(0, keepdim=True))
        check_close(f"{name} bins", ok_[4], op_[4], 1e-5, 2.0 * abs_bins(pp, T_sv, cfg))
        print(f"  {name} rta={rta_on}: counts {op_[2].tolist()} "
              f"(pending, alive, kept, diffused, flagged)", flush=True)
    # the sums' order is fixed: two launches give the same bits everywhere
    a, b = pool_c.clone(), pool_c.clone()
    ra = megastep.drift_megastep(a, T_sv, True, cfg, seed=seed)
    rb = megastep.drift_megastep(b, T_sv, True, cfg, seed=seed)
    if not (same_bits(a, b) and all(same_bits(x, y) for x, y in zip(ra, rb))):
        raise AssertionError(f"{name}: two launches on one pool differ")
    del a, b, ra, rb
    lane, warp = divergence(pool_c, cfg)
    # timed as the main path calls it, successive drift steps on one pool:
    # the device time, and the calls' rate between CUDA events (the
    # wrapper's host work included where it is the longer)
    p_time = pool_c.clone()
    ms = device_timed(lambda: megastep.drift_megastep(p_time, T_sv, True, cfg, seed=seed))
    del p_time
    event_ms = timed(lambda p: megastep.drift_megastep(p, T_sv, True, cfg, seed=seed), pool_c.clone(), 20)
    plain_ms = timed(lambda p: megastep.drift_megastep_plain(p, T_sv, True, cfg, seed=seed), pool_c.clone(), 3)
    C, N = pool_c.shape
    n_alive = int((pool_c[C_ALIVE] > 0.5).sum())
    n_bytes = 2 * C * N * 4 + C * cfg.ecap * 4 + cfg.ecap * 4
    n_ops = n_alive * 150 + source_ops
    if cfg.sv_mode == SV_CENTER:
        # the nearest-centre loop, before and after the drift: 7 operations
        # a centre
        n_ops += n_alive * cfg.sv * 2 * 7
    b_ms, b_by = bound(n_bytes, n_ops)
    # the design's own scratch (not in the bound): per-block partial sums,
    # written by the lanes launch and read by the reductions
    nb = -(-N // 256)
    print(f"  {name}: {cfg.sv} subvolumes (mode {cfg.sv_mode}), pool {C} x {N}, bytes "
          f"{n_bytes / 1e6:.1f} MB, operations {n_ops / 1e9:.3f} G, partial sums "
          f"{nb * (2 * cfg.sv8 + R8) * 5 * 4 / 1e6:.1f} MB each way; two launches bit-equal; "
          f"lanes ending at a wall {lane:.4f}, warps holding one {warp:.4f}", flush=True)
    return dict(
        name=name, route="cuda", source="nanokappa_torch/csrc/megastep.cu",
        replaces="nanokappa_tpu/ops/megastep.py:1358", max_abs_err=err, match=how,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        lane_share=lane, warp_share=warp, event_ms=event_ms,
        split=lambda: megastep.drift_megastep(pool_c.clone(), T_sv, True, cfg, seed=seed),
    )


def split_launches(recs) -> None:
    """Each record's call split by kernel name (launch_split), with its
    kernel launches a call (`per_call`), printed; run after every main path
    and every timing, since a profiler session may leave hooks that add host
    time to later launches."""
    for r in recs:
        if "split" in r:
            counts: dict[str, float] = {}
            r["split_us"] = launch_split(r.pop("split"), counts=counts)
            r["per_call"] = sum(counts.values())
            print(f"  {r['name']}: launch split (us) {r['split_us']}, kernel launches a call "
                  f"{r['per_call']:g}", flush=True)


def check_compact_pool(pools, name="compact_pool"):
    """Kernel B against its twin on each pool; timed, with its library call
    (boolean-mask column selection into a zeroed buffer), on the last."""
    import torch

    from nanokappa_torch.ops import compact_pool
    from nanokappa_torch.sim.state import C_ALIVE

    for pool in pools:
        ok_b, tk = compact_pool.compact_pool(pool)
        op_b, tp = compact_pool.compact_pool_plain(pool)
        torch.cuda.synchronize()
        if int(tk) != int(tp) or not torch.equal(ok_b.view(torch.int32), op_b.view(torch.int32)):
            raise AssertionError(f"compact_pool differs from its plain twin on a {tuple(pool.shape)} pool")
    out = torch.empty_like(pool)

    def library(p):
        sel = p[:, p[C_ALIVE] > 0.5]
        out.zero_()
        out[:, : sel.shape[1]] = sel

    C, N = pool.shape
    b_ms, b_by = bound(2 * C * N * 4, 0)
    return dict(
        name=name, route="cuda", source="nanokappa_torch/csrc/compact_pool.cu",
        replaces="nanokappa_tpu/ops/compact_pool.py:186", max_abs_err=0.0, match="bit-exact",
        ms=device_timed(lambda: compact_pool.compact_pool(pool, out)),
        event_ms=timed(lambda p: compact_pool.compact_pool(p, out), pool, 20),
        plain_ms=timed(lambda p: compact_pool.compact_pool_plain(p, out), pool, 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=timed(library, pool, 5),
    )


def check_compact(name, masks, cap):
    """Kernel C against its twin on each mask; timed on the first, with its
    library call (torch.nonzero plus the sentinel fill); `split`, its call
    to count kernel launches by (split_launches, after every main path:
    one a call, gated)."""
    import torch

    from nanokappa_torch.ops import compact

    for m in masks:
        ik, nk = compact.compact_indices(m, cap)
        ip, npl = compact.compact_indices_plain(m, cap)
        torch.cuda.synchronize()
        if not (torch.equal(ik, ip) and int(nk) == int(npl)):
            raise AssertionError(f"compact_indices differs from its plain twin ({name})")
    out = torch.empty(cap, dtype=torch.int32, device=masks[0].device)

    def library(m):
        idx = torch.nonzero(m).flatten()[:cap]
        out.fill_(m.shape[0])
        out[: idx.shape[0]] = idx

    n = masks[0].shape[0]
    b_ms, b_by = bound(n + 4 * cap + 4, 0)
    return dict(
        name=name, route="cuda", source="nanokappa_torch/csrc/compact.cu",
        replaces="nanokappa_tpu/ops/compact.py:77", max_abs_err=0.0, match="bit-exact",
        ms=device_timed(lambda: compact.compact_indices(masks[0], cap)),
        event_ms=timed(lambda m: compact.compact_indices(m, cap), masks[0], 50),
        plain_ms=timed(lambda m: compact.compact_indices_plain(m, cap), masks[0], 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=timed(library, masks[0], 50),
        split=lambda: compact.compact_indices(masks[0], cap),
    )


def small_check(device, domain_kw, subvol_temp, tol):
    """The whole step on the card vs the plain path on the CPU on a small
    closed configuration (no reservoirs), from one initial state, 4 steps.
    Kernel A draws the same numbers on both; the narrow machinery's rare
    per-lane draws differ, so T_sv agrees to rtol `tol` and Np_sv to 3
    particles."""
    import numpy as np
    import torch

    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.reservoir import build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count
    from nanokappa_torch.sim.step import build_step

    mat = synthetic_material(mesh=(4, 4, 4))
    dom = build_domain(**domain_kw)
    n_p, rho = particle_count(("total", 3000), mat, dom)
    params = SimParams(
        dt=1.0, n_cap=4096, inj_cap=128, temp_interp="nearest", res_gen="pooled",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
    )
    outs = []
    for d in (torch.device("cpu"), device):
        geo = build_device_geometry(dom, d)
        btab = build_boundary_tables(mat, dom, device=d)
        rtab = build_reservoir_tables(mat, dom, 1.0, rho, device=d)
        state = init_state(
            mat, dom, geo, params, n_p, btab, temp_dist="custom", subvol_temp=subvol_temp, seed=3,
        )
        run = build_step(geo, mat.device_tables(d), btab, rtab, params, n_inner=1, n_outer=4)
        _, out = run(state)
        outs.append((out.T_sv.cpu().numpy(), out.Np_sv.cpu().numpy(), int(out.lost[-1])))
    (T0, N0, l0), (T1, N1, l1) = outs
    np.testing.assert_allclose(T1, T0, rtol=tol)
    np.testing.assert_allclose(N1, N0, atol=3)
    if l0 or l1:
        raise AssertionError("the small check lost particles")
    return float(np.abs(T1 - T0).max())


def main_path(name, mat, dom, geo, btab, rtab, params, n_p, tabs, card):
    """Drive one configuration through init_state -> build_step -> run with
    the launch counters zeroed just before and read just after: 2 warm-up
    and 3 timed runs of 10 x 10 steps. Returns (out, n0, launches, events,
    state, T_at) with events = [kernel A's in-kernel diffuse re-emissions, its
    flagged specular exports, the narrow machinery's k-model swaps] over
    the 500 steps, and T_at the T_sv after the first 100 and 300 steps."""
    import torch

    from nanokappa_torch.ops import compact, compact_pool, megastep
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=SEED)
    n0 = int(state.alive.sum())
    run = build_step(geo, tabs, btab, rtab, params, n_inner=10, n_outer=10)
    mods = (megastep, compact_pool, compact)
    for m in mods:
        m.launches = 0
    T_at = {}
    for k in range(2):  # warm up: reach the steady boundary-event mix
        state, out = run(state)
        torch.cuda.synchronize()
        if k == 0:
            T_at[100] = out.T_sv[-1].cpu().numpy()
    n_runs = 3  # 300 timesteps
    t0 = time.perf_counter()
    for k in range(n_runs):
        state, out = run(state)
        torch.cuda.synchronize()
        if k == 0:
            T_at[300] = out.T_sv[-1].cpu().numpy()
    elapsed = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}
    events = state.kernel_events.tolist()
    n_alive = int(out.N_p[-1])
    ups = n_runs * 100 * n_alive / elapsed
    print(f"{name}: T_sv {[round(float(t), 3) for t in out.T_sv[-1].cpu()]}", flush=True)
    print(f"{name}: N_p {n_alive} (start {n0}), lost {out.lost_split[-1].tolist()}, "
          f"frozen {int(out.frozen[-1])}, launches {launches}, "
          f"in-kernel diffuse {events[0]}, flagged specular exports {events[1]}, "
          f"k-model swaps {events[2]}", flush=True)
    print(f"{name}: {ups:.4g} updates/s ({elapsed / (n_runs * 100) * 1e3:.3f} ms/step) on {card}",
          flush=True)
    return out, n0, launches, events, state, T_at


def perforated_plate(L=3e3, W=3e3, H=1e3, a=600.0):
    """The plate of tests/test_porous.py: an L x W x H box with a square
    hole of side 2a through z at its centre (32 triangles)."""
    import numpy as np

    from nanokappa_torch.geometry.mesh import TriMesh

    cx, cy = L / 2, W / 2
    O = [(0, 0), (L, 0), (L, W), (0, W)]
    I = [(cx - a, cy - a), (cx + a, cy - a), (cx + a, cy + a), (cx - a, cy + a)]
    v = []
    for z in (0.0, H):
        v += [(x, y, z) for x, y in O]
    for z in (0.0, H):
        v += [(x, y, z) for x, y in I]
    v = np.array(v, dtype=float)
    OB, OT, IB, IT = 0, 4, 8, 12
    faces = []
    for k in range(4):
        k2 = (k + 1) % 4
        faces += [[OB + k, IB + k, OB + k2], [OB + k2, IB + k, IB + k2]]
        faces += [[OT + k, OT + k2, IT + k], [OT + k2, IT + k2, IT + k]]
        faces += [[OB + k, OB + k2, OT + k], [OB + k2, OT + k2, OT + k]]
        faces += [[IB + k, IT + k, IB + k2], [IB + k2, IT + k, IT + k2]]
    return TriMesh(v, np.array(faces))


def cli_argv(b: dict, folder: str, device, steps: int, res_gen: str, extra=()) -> list[str]:
    """A configuration as CLI arguments, sized as bench.py:run_config sizes
    a cell (10^6 particles, pool margin 1.25, nearest temperatures, linear
    initial profile)."""
    def words(v):
        return [str(x) for x in v]

    dims = ["--dimensions", *words(b["dimensions"])] if "dimensions" in b else []
    return [
        "--mat_folder", ".", "--hdf_file", "synthetic", "--poscar_file", "synthetic",
        "--geometry", b["geometry"], *dims, "--subvolumes", *words(b["subvolumes"]),
        "--bound_pos", *words(b["bound_pos"]), "--bound_cond", *b["bound_cond"],
        "--bound_values", *words(b["bound_values"]), "--connect_pos", *words(b["connect_pos"]),
        "--temp_dist", "linear", "--temp_interp", "nearest",
        "--particles", "total", f"{PARTICLES:.0f}", "--pool_margin", "1.25",
        "--timestep", "1", "--iterations", str(steps), "--reservoir_gen", res_gen, *extra,
        "--seed", str(SEED), "--results_folder", folder, "--output", "screen",
        "--device", str(device),
    ]


def plate_main(mat, card, device):
    """The plate through the driver: its STL written into the run's folder,
    the launch counters zeroed just before the Simulation is built and read
    after its run. Returns (sim, its folder, launches, checks)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.geometry import stl
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.ops import compact, compact_pool, megastep
    from nanokappa_torch.sim.fused import event_window
    from nanokappa_torch.sim.state import C_ALIVE

    td = tempfile.mkdtemp(prefix="chip_smoke_plate_")
    stl_path = os.path.join(td, "plate.stl")
    stl.save_stl(perforated_plate(), stl_path)
    mods = (megastep, compact_pool, compact)
    for m in mods:
        m.launches = 0
    t0 = time.perf_counter()
    argv = cli_argv(dict(PLATE, geometry=stl_path), os.path.join(td, "res"), device, PLATE_STEPS, "constant")
    sim = Simulation(read_args(argv), material=mat)
    t_setup = time.perf_counter() - t0
    sim.run(verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}

    tm = sim.timer
    row = sim.window[-1]
    n0, n_alive = sim.n_p_target, int(row["N_p"])
    lost, T = row["lost_split"], row["T"]
    steps_t = tm.calls["device_step"][-2:]
    ups = n_alive * 200 / sum(steps_t)
    evt = event_window(sim.geo, sim.mtab, sim.btab, sim.params)
    pool = sim.state.pool
    alive = pool[C_ALIVE] > 0.5
    x, y = pool[0][alive], pool[1][alive]
    hole = ((x - 1500.0).abs() < 590.0) & ((y - 1500.0).abs() < 590.0)
    in_hole = float(hole.sum()) / max(1, int(alive.sum()))
    cx = sim.domain.subvol_center[:, 0]
    events = sim.state.kernel_events.tolist()
    print(f"plate: {sim.geo.tri_origin.shape[0]} triangles, {sim.geo.n_facets} facets, "
          f"{sim.geo.n_subvols} {sim.geo.subvol_type} subvolumes, layout {sim.state.layout}, "
          f"{sim.btab.n_rows} boundary-table rows, {n0} particles, pool {sim.params.n_cap}, "
          f"inj_cap {sim.params.inj_cap}, evt_cap {evt} (regrows {sim.evt_regrows})", flush=True)
    print(f"plate: centres x {[round(float(c), 1) for c in cx]}", flush=True)
    print(f"plate: T_sv {[round(float(t), 3) for t in T]}", flush=True)
    print(f"plate: N_p {n_alive} (start {n0}), lost {lost.tolist()}, frozen {row['frozen']}, "
          f"escaped {sim.n_escaped_total}, in the hole {in_hole:.3g} of the alive lanes, "
          f"launches {launches}, in-kernel diffuse {events[0]}, flagged specular exports "
          f"{events[1]}", flush=True)
    print(f"plate: {ups:.4g} updates/s ({sum(steps_t) / 200 * 1e3:.3f} ms/step, device_step "
          f"of the last 2 blocks) on {card}; driver wall {wall:.1f} s (setup {t_setup:.1f} s)",
          flush=True)
    print("plate: " + tm.report().replace("\n", "\nplate: "), flush=True)

    def rows_of(name):
        with open(os.path.join(sim.folder, name)) as f:
            return [line for line in f.read().splitlines() if not line.startswith("#")]

    sv_rows, con_rows = rows_of("subvolumes.txt"), rows_of("subvol_connections.txt")
    checks = {
        "plate: nothing dropped or defective": lost[0] == 0 and lost[2] == 0,
        "plate: k_max-stuck <= 1e-6 per particle-step": lost[1] <= 1e-6 * n0 * PLATE_STEPS,
        "plate: frozen under 1% of N": int(row["frozen"]) < 0.01 * n0,
        "plate: population within 5%": abs(n_alive - n0) <= 0.05 * n0,
        "plate: T_sv in (295.9, 304.1)": bool(((T > 295.9) & (T < 304.1)).all()),
        "plate: smallest-x cell hotter than largest-x cell": bool(T[np.argmin(cx)] > T[np.argmax(cx)]),
        "plate: under 1% of the alive lanes in the hole": in_hole < 0.01,
        "plate: A, B, C launched": all(v > 0 for v in launches.values()),
        f"plate: {PLATE_STEPS} steps run": sim.current_timestep == PLATE_STEPS,
        "plate: subvolumes.txt in the JAX driver's columns": len(sv_rows) == sim.geo.n_subvols
        and all(len(r.split(",")) == 13 for r in sv_rows),
        "plate: subvol_connections.txt in the JAX driver's columns":
        len(con_rows) == len(sim.domain.subvol_connections) > 0
        and all(len(r.split(",")) == 12 for r in con_rows),
    }
    return sim, td, launches, checks


def mirror_cache_stats(pool, btab, tabs):
    """(partnered, took, worst): over the alive lanes of a full-layout
    pool, those whose mirror partner has a degenerate branch, those whose
    cache holds the branch (the split took it), and the largest relative
    frequency gap between a lane's mode and its cached partner's."""
    import torch

    from nanokappa_torch.sim.boundary_tables import combined_mirror_rows
    from nanokappa_torch.sim.state import C_ALIVE, C_MODE, C_OMEGA, R_MMODE

    alive = pool[C_ALIVE] > 0.5
    mode = pool[C_MODE].view(torch.int32)[alive].long()
    xm = pool[R_MMODE].view(torch.int32)[alive].long()
    cmr = torch.as_tensor(combined_mirror_rows(btab, tabs)[:, 1].view("int32"), device=pool.device)
    corr = cmr[mode].long()
    dp = btab.degen_partner.long()
    part = dp[corr.clamp(min=0)]
    partnered = (corr >= 0) & (part >= 0)
    took = partnered & (xm == part)
    has = xm >= 0
    om = tabs.omega_vel[:, 0].double()
    own = pool[C_OMEGA][alive].double()
    gap = torch.where(has, (om[xm.clamp(min=0)] - own).abs() / own.abs().clamp(min=1e-30), 0.0)
    return int(partnered.sum()), int(took.sum()), float(gap.max())


def kfilm0_main(mat, card, device):
    """The bench film (eta = 0 walls) under the k model through the driver:
    mirror-eligible with degenerate partners, so it runs kernel A's full
    24-row mirror. The launch counters are zeroed just before the
    Simulation is built and read after its run; the split drawn at cache
    fill is counted between the two. Returns (sim, its folder, launches,
    checks)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.ops import compact, compact_pool, megastep
    from nanokappa_torch.sim.fused import event_window

    mods = (megastep, compact_pool, compact)
    for m in mods:
        m.launches = 0
    t0 = time.perf_counter()
    td = tempfile.mkdtemp(prefix="chip_smoke_kfilm0_")
    sim = Simulation(read_args(cli_argv(FILM, td, device, K0_STEPS, "pooled", ("--bound_scat", "k"))),
                     material=mat)
    t_setup = time.perf_counter() - t0
    part0, took0, gap0 = mirror_cache_stats(sim.state.pool, sim.btab, sim.mtab)
    sim.run(verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}
    _, _, gap1 = mirror_cache_stats(sim.state.pool, sim.btab, sim.mtab)

    tm = sim.timer
    row = sim.window[-1]
    n0, n_alive = sim.n_p_target, int(row["N_p"])
    lost, T = row["lost_split"], row["T"]
    steps_t = tm.calls["device_step"][-3:]
    ups = n_alive * 300 / sum(steps_t)
    evt = event_window(sim.geo, sim.mtab, sim.btab, sim.params)
    events = sim.state.kernel_events.tolist()
    share = took0 / max(1, part0)
    print(f"k film eta = 0: layout {sim.state.layout}, {n0} particles, pool {sim.params.n_cap}, "
          f"inj_cap {sim.params.inj_cap}, evt_cap {evt} (regrows {sim.evt_regrows}); split at "
          f"init {took0} of {part0} partnered caches took the branch ({share:.5f}); largest "
          f"partner frequency gap {gap0:.3g} at init, {gap1:.3g} after the run", flush=True)
    print(f"k film eta = 0: T_sv {[round(float(t), 3) for t in T]}", flush=True)
    print(f"k film eta = 0: N_p {n_alive} (start {n0}), lost {lost.tolist()}, frozen "
          f"{row['frozen']}, escaped {sim.n_escaped_total}, launches {launches}, kernel A exports "
          f"{events[3]} ({events[3] / K0_STEPS:.1f} a step), narrow-machinery swaps {events[2]}",
          flush=True)
    print(f"k film eta = 0: {ups:.4g} updates/s ({sum(steps_t) / 300 * 1e3:.3f} ms/step, "
          f"device_step of the last 3 blocks) on {card}; driver wall {wall:.1f} s (setup "
          f"{t_setup:.1f} s)", flush=True)
    print("k film eta = 0: " + tm.report().replace("\n", "\nk film eta = 0: "), flush=True)
    checks = {
        "k film eta = 0: full 24-row mirror layout": sim.state.layout == "full"
        and sim.state.pool.shape[0] == 24,
        "k film eta = 0: lost == 0": sum(lost) == 0,
        "k film eta = 0: population within 5%": abs(n_alive - n0) <= 0.05 * n0,
        "k film eta = 0: T_sv in (298, 302)": bool(((T > 298.0) & (T < 302.0)).all()),
        "k film eta = 0: T_sv falling hot to cold": bool((np.diff(T) < 0).all()),
        "k film eta = 0: frozen == 0": int(row["frozen"]) == 0,
        "k film eta = 0: exports per step under the event window": events[3] / K0_STEPS < evt,
        "k film eta = 0: split share at init within 0.5 +- 0.005": abs(share - 0.5) <= 0.005,
        f"k film eta = 0: partner frequencies within rtol {GATE_RTOL}": max(gap0, gap1) <= GATE_RTOL,
        "k film eta = 0: A, B, C launched": all(v > 0 for v in launches.values()),
        f"k film eta = 0: {K0_STEPS} steps run": sim.current_timestep == K0_STEPS,
    }
    return sim, td, launches, checks


def crafted_full_pool(pool16, T_sv, tabs, seed):
    """A 24-row full-mirror pool from a 16-row one: two thirds of the alive
    lanes cache a random partner mode (its omega and velocity, both slope
    pairs on the lane's T-grid bin, C_TAU turned into the intercept), the
    rest none. Kernel A's full branch on a geometry whose walls have no
    full mirror of their own."""
    import torch

    from nanokappa_torch.sim.scatter import slope_pair
    from nanokappa_torch.sim.state import C_ALIVE, C_MODE, C_SV, C_TAU

    d = pool16.device
    N = pool16.shape[1]
    M = tabs.omega_vel.shape[0]
    g = torch.Generator(device=d).manual_seed(seed)
    xm = torch.randint(0, M, (N,), generator=g, device=d, dtype=torch.int32)
    xm = torch.where((torch.rand(N, generator=g, device=d) < 2 / 3) & (pool16[C_ALIVE] > 0.5), xm, -1)
    has = xm >= 0
    sv = pool16[C_SV].view(torch.int32).clamp(0, T_sv.shape[0] - 1)
    mode = pool16[C_MODE].view(torch.int32).clamp(0, M - 1)
    a, b = slope_pair(tabs, T_sv, sv, mode)
    a_m, b_m = slope_pair(tabs, T_sv, sv, xm.clamp(min=0))
    ov = tabs.omega_vel[xm.clamp(min=0).long()]
    pool = torch.cat([pool16, torch.stack([
        xm.view(torch.float32), torch.where(has, ov[:, 0], 0.0),
        *[torch.where(has, ov[:, 1 + k], 0.0) for k in range(3)],
        torch.where(has, a_m, 0.0), b, torch.where(has, b_m, 0.0),
    ])]).contiguous()
    pool[C_TAU] = torch.where(pool16[C_ALIVE] > 0.5, a, pool16[C_TAU])
    return pool


def grid_film(f_dom, device):
    """The film's domain and geometry re-binned by a GRID of centres (the
    `grid_centers` in build_domain's order; a box's cells have equal volumes)."""
    import dataclasses

    import numpy as np

    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.subvolumes import grid_centers

    mesh = f_dom.mesh
    c = grid_centers(mesh, np.asarray(GRID))
    c = c[np.lexsort((c[:, 2], c[:, 1], c[:, 0]))]
    dom = dataclasses.replace(
        f_dom, subvol_type="grid", slice_axis=0, subvol_center=c,
        subvol_volume=np.full(len(c), mesh.volume / len(c)),
        subvol_connections=np.zeros((0, 2), np.int64), grid=np.asarray(GRID),
    )
    return dom, build_device_geometry(dom, device)


def short_path(name, mat, dom, geo, btab, rtab, params, n_p, tabs, card):
    """100 steps of one configuration through init_state -> build_step ->
    run (10 x 10, after no warm-up) with kernel A's counter zeroed just
    before and read just after. Returns (out, n0, kernel A launches)."""
    import torch

    from nanokappa_torch.ops import megastep
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=SEED)
    n0 = int(state.alive.sum())
    run = build_step(geo, tabs, btab, rtab, params, n_inner=10, n_outer=10)
    megastep.launches = 0
    t0 = time.perf_counter()
    state, out = run(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n = megastep.launches
    print(f"{name}: T_sv {[round(float(t), 3) for t in out.T_sv[-1][:10].cpu()]}"
          f"{' ...' if geo.n_subvols > 10 else ''}", flush=True)
    print(f"{name}: N_p {int(out.N_p[-1])} (start {n0}), lost {out.lost_split[-1].tolist()}, "
          f"frozen {int(out.frozen[-1])}, kernel A launches {n}, "
          f"{100 * int(out.N_p[-1]) / elapsed:.4g} updates/s on {card}", flush=True)
    return out, n0, n


def conv_columns(n_res: int, n_sv: int) -> int:
    """Columns of a convergence.txt row of slice subvolumes, as the JAX
    driver's writer lays them out (nanokappa_tpu/io/writers.py
    ConvergenceWriter.write_row): time stamp, step, time, total energy,
    per reservoir the energy balance and 3 flux components, N_p, per slice
    T, E, 3 flux components, N_p and kappa, and the total kappa."""
    return 4 + 4 * n_res + 1 + 7 * n_sv + 1


def bigmesh_main(mat, card, device):
    """The large mesh through the driver: the launch counters zeroed just
    before the Simulation is built (its first cast is kernel E's) and read
    after its run. Returns (sim, its results folder, launches, checks)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.ops import compact, compact_pool, megastep, raycast_large
    from nanokappa_torch.sim.fused import event_window

    mods = (megastep, compact_pool, compact, raycast_large)
    for m in mods:
        m.launches = 0
    raycast_large.launch_widths.clear()
    t0 = time.perf_counter()
    td = tempfile.mkdtemp(prefix="chip_smoke_bigmesh_")
    sim = Simulation(read_args(cli_argv(BIGMESH, td, device, BIG_STEPS, "constant")), material=mat)
    t_setup = time.perf_counter() - t0
    sim.run(verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}
    launches["raycast_large by rays"] = dict(sorted(raycast_large.launch_widths.items()))

    tm = sim.timer
    row = sim.window[-1]
    n0, n_alive = sim.n_p_target, int(row["N_p"])
    lost, T = row["lost_split"], row["T"]
    steps_t = tm.calls["device_step"][-3:]
    ups = n_alive * 300 / sum(steps_t)
    evt = event_window(sim.geo, sim.mtab, sim.btab, sim.params)
    cov = float((sim.btab._host["corr"] >= 0).mean())
    print(f"bigmesh: {sim.geo.tri_origin.shape[0]} triangles, {sim.geo.n_facets} facets, "
          f"{sim.btab.n_rows} boundary-table rows (built in "
          f"{tm.total('setup_boundary_tables'):.1f} s), specular-partner coverage {cov:.3g}, "
          f"{n0} particles, pool {sim.params.n_cap}, inj_cap {sim.params.inj_cap}, "
          f"c_max {sim.params.c_max}, evt_cap {evt} (regrows {sim.evt_regrows})", flush=True)
    print(f"bigmesh: T_sv {[round(float(t), 3) for t in T]}", flush=True)
    print(f"bigmesh: N_p {n_alive} (start {n0}), lost {lost.tolist()}, frozen {row['frozen']}, "
          f"escaped {sim.n_escaped_total}, launches {launches}", flush=True)
    print(f"bigmesh: {ups:.4g} updates/s ({sum(steps_t) / 300 * 1e3:.3f} ms/step, device_step "
          f"of the last 3 blocks) on {card}; driver wall {wall:.1f} s (setup {t_setup:.1f} s)",
          flush=True)
    print("bigmesh: " + tm.report().replace("\n", "\nbigmesh: "), flush=True)

    files = ("convergence.txt", "residue.txt", "subvolumes.txt", "particle_data.txt",
             "arguments.txt")
    with open(os.path.join(sim.folder, "convergence.txt")) as f:
        lines = f.read().splitlines()
    n_cols = {len(line.split()) for line in lines[1:]}
    checks = {
        # capacity drops and defective lanes: none; lanes still bouncing
        # after k_max narrow rounds are quarantined, as in the JAX package.
        # On this mesh they are lanes reflected on an edge between two side
        # facets, re-hitting the neighbour at t = 0 through the large-mesh
        # cast's backward slack (t > -1e-4 ps, no facing test) and its 1e-4
        # barycentric tolerance, both the reference's: the JAX v2 step on
        # its Pallas cast quarantines them at the port's rate
        # (tests/torch_stuck_lanes.py), ~3-5e-6 per particle-step, so the
        # gate is 1e-5 (the wire's is 1e-6)
        "bigmesh: nothing dropped or defective": lost[0] == 0 and lost[2] == 0,
        "bigmesh: k_max-stuck below 1e-5 per particle-step": lost[1] <= 1e-5 * n0 * BIG_STEPS,
        "bigmesh: frozen under 1% of N": int(row["frozen"]) < 0.01 * n0,
        "bigmesh: population within 5%": abs(n_alive - n0) <= 0.05 * n0,
        "bigmesh: T_sv in (295, 305)": bool(((T > 295.0) & (T < 305.0)).all()),
        "bigmesh: T_sv falling hot to cold": bool((np.diff(T) < 0).all()),
        "bigmesh: E, A, B, C launched": all(launches[m.__name__.rsplit(".", 1)[1]] > 0 for m in mods),
        f"bigmesh: {BIG_STEPS} steps run": sim.current_timestep == BIG_STEPS,
        "bigmesh: result files written": all(
            os.path.getsize(os.path.join(sim.folder, f)) > 0 for f in files
        ),
        "bigmesh: convergence.txt has the JAX driver's columns": n_cols == {
            conv_columns(sim.geo.n_reservoirs, sim.geo.n_subvols)
        } and len(lines) == 1 + BIG_STEPS // 10,
    }
    return sim, td, launches, checks


def star_argv(folder: str, device) -> list[str]:
    """examples/voronoi_star.txt as written (example_argv), STAR_STEPS steps."""
    return example_argv(STAR_FILE, folder, device, STAR_STEPS)


def example_argv(name: str, folder: str, device, steps: int) -> list[str]:
    """A parameter file of examples/ as written, with the synthetic material
    (the card's machine has no h5py to read a written one: Simulation takes
    the 31^3 Material instead), 10^6 particles, `steps` steps, the bench's
    1.25 pool margin and seed, the results under `folder`."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, name)) as f:
        words = f.read().split()
    swap = {"--mat_folder": ["."], "--hdf_file": ["synthetic"], "--poscar_file": ["synthetic"],
            "--particles": ["total", f"{PARTICLES:.0f}"], "--iterations": [str(steps)],
            "--results_folder": [folder], "--output": ["screen"]}
    out, i = [], 0
    while i < len(words):
        j = i + 1
        while j < len(words) and not words[j].startswith("--"):
            j += 1
        out += [words[i], *swap.get(words[i], words[i + 1 : j])]
        i = j
    return out + ["--pool_margin", "1.25", "--seed", str(SEED), "--device", str(device)]


def star_main(mat, card, device):
    """The star through the driver on the v1 step: the launch counters
    zeroed just before the Simulation is built and read after its run.
    Returns (sim, its folder, launches, checks)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.ops import compact, compact_pool, megastep, scatter_rows
    from nanokappa_torch.sim.fused import event_window

    mods = (megastep, compact_pool, compact, scatter_rows)
    for m in mods:
        m.launches = 0
    t0 = time.perf_counter()
    td = tempfile.mkdtemp(prefix="chip_smoke_star_")
    sim = Simulation(read_args(star_argv(td, device)), material=mat)
    t_setup = time.perf_counter() - t0
    sim.run(verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}

    tm = sim.timer
    row = sim.window[-1]
    n0, n_alive = sim.n_p_target, int(row["N_p"])
    lost, T = row["lost_split"], row["T"]
    steps_t = tm.calls["device_step"][-3:]
    ups = n_alive * 300 / sum(steps_t)
    evt = event_window(sim.geo, sim.mtab, sim.btab, sim.params)
    dom = sim.domain
    res_c = dom.mesh.facet_centroids[dom.res_facets]
    hot, cold = res_c[np.argmax(dom.res_values)], res_c[np.argmin(dom.res_values)]
    c = dom.subvol_center
    i_hot = int(np.argmin(np.linalg.norm(c - hot, axis=1)))
    i_cold = int(np.argmin(np.linalg.norm(c - cold, axis=1)))
    stuck_rate = lost[1] / (n0 * STAR_STEPS)
    print(f"star: {sim.geo.tri_origin.shape[0]} triangles, {sim.geo.n_facets} facets, "
          f"{sim.geo.n_subvols} {sim.geo.subvol_type} cells, temp_interp {sim.params.temp_interp}, "
          f"step v1 ({sim.v1_reason}), layout {sim.state.layout}, {n0} particles, pool "
          f"{sim.params.n_cap}, inj_cap {sim.params.inj_cap}, c_max {sim.params.c_max}, evt_cap {evt} "
          f"(regrows {sim.evt_regrows})", flush=True)
    print(f"star: centres {[[round(float(x), 1) for x in ci] for ci in c]}", flush=True)
    print(f"star: T_sv {[round(float(t), 3) for t in T]} (nearest the hot cap: cell {i_hot}, "
          f"the cold: cell {i_cold})", flush=True)
    print(f"star: N_p {n_alive} (start {n0}), lost {lost.tolist()} (k_max-stuck {stuck_rate:.3g} per "
          f"particle-step), frozen {row['frozen']}, escaped {sim.n_escaped_total}, launches {launches}",
          flush=True)
    print(f"star: {ups:.4g} updates/s ({sum(steps_t) / 300 * 1e3:.3f} ms/step, device_step of the last 3 "
          f"blocks) on {card}; driver wall {wall:.1f} s (setup {t_setup:.1f} s)", flush=True)
    print("star: " + tm.report().replace("\n", "\nstar: "), flush=True)

    def rows_of(name):
        with open(os.path.join(sim.folder, name)) as f:
            return [line for line in f.read().splitlines() if not line.startswith("#")]

    sv_rows, con_rows = rows_of("subvolumes.txt"), rows_of("subvol_connections.txt")
    with open(os.path.join(sim.folder, "convergence.txt")) as f:
        lines = f.read().splitlines()
    n_cols = {len(line.split()) for line in lines[1:]}
    R, SV = sim.geo.n_reservoirs, sim.geo.n_subvols
    checks = {
        "star: the v1 step, for radial temperatures": sim.v1_reason == STAR_REASON
        and sim.state.layout == "plain",
        "star: nothing dropped or defective": lost[0] == 0 and lost[2] == 0,
        "star: k_max-stuck <= 1e-5 per particle-step": stuck_rate <= 1e-5,
        "star: frozen under 1% of N": int(row["frozen"]) < 0.01 * n0,
        "star: population within 5%": abs(n_alive - n0) <= 0.05 * n0,
        "star: T_sv in (295, 305)": bool(((T > 295.0) & (T < 305.0)).all()),
        "star: the cell nearest the hot cap hotter than the one nearest the cold": bool(T[i_hot] > T[i_cold]),
        "star: D, C, B launched": all(launches[k] > 0 for k in ("scatter_rows", "compact", "compact_pool")),
        "star: kernel A not launched (v1)": launches["megastep"] == 0,
        "star: D launched once per step": launches["scatter_rows"] == STAR_STEPS,
        f"star: {STAR_STEPS} steps run": sim.current_timestep == STAR_STEPS,
        "star: subvolumes.txt in the JAX driver's columns": len(sv_rows) == SV
        and all(len(r.split(",")) == 13 for r in sv_rows),
        "star: subvol_connections.txt in the JAX driver's columns":
        len(con_rows) == len(dom.subvol_connections) > 0 and all(len(r.split(",")) == 12 for r in con_rows),
        "star: convergence.txt in the JAX driver's columns":
        n_cols == {4 + 4 * R + 1 + 6 * SV + len(dom.subvol_connections)}
        and len(lines) == 1 + STAR_STEPS // 10,
        "star: particle_data.txt written": os.path.getsize(os.path.join(sim.folder, "particle_data.txt")) > 0,
    }
    return sim, td, launches, checks


def check_scatter_rows(sim, device):
    """Kernel D against its twin on the star's own event buffer, bit for
    bit: the lanes the next step's drift stops at a facet (alive, t_coll
    short of the step, a facet ahead), compacted by kernel C at the v1
    width, their rows gathered and perturbed (float rows shifted, int rows
    given other ids). Also a sentinel-only buffer (the pool must not move).
    Timed beside its twin and `index_copy_` on the valid prefix, L2-warm
    (device_timed: one target, its sectors stay in L2) and L2-cold
    (device_timed_cold), with its sector floor beside its byte bound.
    Returns the records of D and of C at the v1 width."""
    import torch

    from nanokappa_torch.ops import compact, scatter_rows as sr
    from nanokappa_torch.sim.cascade import v1_event_cap
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, C_MODE, C_ONF, C_SV, C_TCOLL, as_f32, as_i32

    pool = sim.state.pool
    C, N = pool.shape
    E = v1_event_cap(sim.params)
    mask = (pool[C_ALIVE] > 0.5) & (pool[C_TCOLL] < 1.0 - 1e-5) & (as_i32(pool[C_CF]) >= 0)
    rec_c = check_compact("compact_indices[v1 events]", [mask], E)
    pidx, n_valid = compact.compact_indices(mask, E)
    n = int(n_valid)
    rows = pool[:, torch.clamp(pidx, max=N - 1).long()].clone()
    fl = [r for r in range(C) if r not in (C_MODE, C_CF, C_ONF, C_ALIVE, C_SV)]
    rows[fl] = rows[fl] * 1.5 + 0.25
    for r in (C_MODE, C_CF, C_ONF, C_SV):
        rows[r] = as_f32(as_i32(rows[r]) ^ 1)
    rows = rows.contiguous()
    err = 0.0
    for idx, tag in ((pidx, "events"), (torch.full((E,), N, dtype=torch.int32, device=device), "sentinels")):
        pk, pp = pool.clone(), pool.clone()
        sr.scatter_rows(pk, rows, idx)
        sr.scatter_rows_plain(pp, rows, idx)
        torch.cuda.synchronize()
        if not torch.equal(pk.view(torch.int32), pp.view(torch.int32)):
            raise AssertionError(f"scatter_rows differs from its twin ({tag})")
        if tag == "sentinels" and not torch.equal(pk.view(torch.int32), pool.view(torch.int32)):
            raise AssertionError("scatter_rows moved the pool on a sentinel-only buffer")
    moved = int((pk.view(torch.int32) != pool.view(torch.int32)).any(0).sum())
    print(f"  scatter_rows[star events]: {n} valid of {E} lanes ({mask.sum().item()} in the mask), "
          f"bit-exact; the sentinel-only buffer moved {moved} lanes", flush=True)
    target = pool.clone()
    pv, rv = pidx[:n].long(), rows[:, :n].contiguous()
    b_ms, b_by = bound(4 * E + 2 * n * C * 4, 0)
    floor_ms, sectors = sector_floor(pidx, n, C, N)
    rec_d = dict(
        name="scatter_rows[star events]", route="cuda", source="nanokappa_torch/csrc/scatter_rows.cu",
        replaces="nanokappa_tpu/ops/scatter_rows.py:123", max_abs_err=err, match="bit-exact",
        ms=device_timed(lambda: sr.scatter_rows(target, rows, pidx)),
        cold_ms=device_timed_cold(lambda: sr.scatter_rows(target, rows, pidx)),
        sector_floor_ms=floor_ms,
        event_ms=timed(lambda p: sr.scatter_rows(p, rows, pidx), target, 50),
        plain_ms=timed(lambda p: sr.scatter_rows_plain(p, rows, pidx), target, 20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed(lambda p: p.index_copy_(1, pv, rv), target, 50),
        split=lambda: sr.scatter_rows(target, rows, pidx),
    )
    print(f"  scatter_rows[star events]: L2-warm {rec_d['ms']:.4f} ms, L2-cold {rec_d['cold_ms']:.4f} ms; "
          f"sector floor {floor_ms:.4f} ms ({sectors} sectors of 32 B), byte bound {b_ms:.4f} ms", flush=True)
    return rec_d, rec_c


def v1_film(mat, f_dom, f_geo, f_btab, f_rtab, f_params, f_np, tabs, T_v2):
    """The bench film on the v1 step (step_impl="v1": the plain pool, the
    same seed's initial particles as the v2 film) for V1_FILM_STEPS steps;
    returns (out, n0, kernel D launches, max |T_sv - T_v2|)."""
    import dataclasses

    import numpy as np
    import torch

    from nanokappa_torch.ops import scatter_rows
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    params = dataclasses.replace(f_params, step_impl="v1")
    state = init_state(mat, f_dom, f_geo, params, f_np, f_btab, temp_dist="linear", seed=SEED)
    n0 = int(state.alive.sum())
    run = build_step(f_geo, tabs, f_btab, f_rtab, params, n_inner=10, n_outer=V1_FILM_STEPS // 10)
    scatter_rows.launches = 0
    t0 = time.perf_counter()
    state, out = run(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    T = out.T_sv[-1].cpu().numpy()
    dT = float(np.abs(T - T_v2).max())
    print(f"film v1: layout {state.layout}, T_sv {[round(float(t), 3) for t in T]}, max |T_sv - T_sv(v2)| "
          f"{dT:.4f} K after {V1_FILM_STEPS} steps; N_p {int(out.N_p[-1])} (start {n0}), lost "
          f"{out.lost_split[-1].tolist()}, frozen {int(out.frozen[-1])}, kernel D launches "
          f"{scatter_rows.launches}, {elapsed / V1_FILM_STEPS * 1e3:.3f} ms/step", flush=True)
    return out, n0, scatter_rows.launches, dT, state.layout


def check_raycast_large(name, geo, pos, vel, ex):
    """Kernel E against its twin on one set of rays: t and facet bit for
    bit (0 mismatched lanes) at its launch shape (G threads per ray, one ray
    per thread); timed, with its bound from the chunks reached per group of
    256 rays (the twin's reach test: the same work whatever G is)."""
    import torch

    from nanokappa_torch.ops import raycast_large as rl

    tabs = rl.prep(geo)
    n = pos.shape[0]
    tp, fp, reach = rl.raycast_large_plain(tabs, pos, vel, ex, reach=True)
    g0 = rl.launch_shape(n)
    tk, fk = rl.raycast_large(geo, pos, vel, ex)
    torch.cuda.synchronize()
    bad = int(((tk.view(torch.int32) != tp.view(torch.int32)) | (fk != fp)).sum())
    if bad:
        raise AssertionError(f"{name} at G = {g0}: {bad} of {n} lanes differ from the twin")
    ms = device_timed(lambda: rl.raycast_large(geo, pos, vel, ex))
    reached = rl.chunks_reached(reach)
    pairs = reached * rl.BOUND_GROUP * rl.BF
    n_bytes = n * (3 + 3 + 1) * 4 + n * 8 + reached * rl.TAB_ROWS * rl.BF * 4
    b_ms, b_by = bound(n_bytes, pairs * rl.OPS_PER_PAIR)
    hits = int((fp >= 0).sum())
    groups = -(-n // rl.BOUND_GROUP)
    event_ms = timed(lambda r: rl.raycast_large(geo, *r), (pos, vel, ex), 20)
    print(f"  {name}: {n} rays, {hits} hits, chunks reached per 256 rays {reached / groups:.3f} of "
          f"{tabs.nc}, 0 mismatched lanes; (G, R) = ({g0}, 1)", flush=True)
    return dict(
        name=name, route="cuda", source="nanokappa_torch/csrc/raycast_large.cu",
        replaces="nanokappa_tpu/ops/raycast_pallas.py:292", max_abs_err=0.0, match="bit-exact",
        ms=ms, shape=(g0, 1), event_ms=event_ms,
        plain_ms=timed(lambda r: rl.raycast_large_plain(tabs, *r), (pos, vel, ex), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def bigmesh_kernel_checks(sim, device):
    """Kernel E and kernel A's cast-off branch against their twins at the
    large mesh's shapes, on the pool the main path left."""
    import torch

    from nanokappa_torch.ops import compact_pool
    from nanokappa_torch.ops.megastep import drift_megastep, mega_config
    from nanokappa_torch.ops.raycast import raycast
    from nanokappa_torch.sim.cascade import pad8
    from nanokappa_torch.sim.fused import event_window
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, C_DEV, C_ONF, C_TCOLL, as_f32

    geo, pool = sim.geo, sim.state.pool
    N = pool.shape[1]
    # rays from the pool's lanes (dead ones too: the first cast covers the
    # whole pool), their own exclusions, some velocity components zeroed,
    # and every 97th lane aimed at a triangle vertex across the wire
    pos = pool[0:3].T.contiguous()
    vel = pool[3:6].T.contiguous()
    ex = pool[C_ONF].contiguous().view(torch.int32).clone()
    vel[1::11, 2] = 0.0
    vel[2::11, :2] = 0.0
    aim = torch.arange(0, N, 97, device=device)
    verts = geo.tri_origin[aim % geo.tri_origin.shape[0]]
    pos[aim, 2] = verts[:, 2]
    vel[aim] = (verts - pos[aim]) / 5.0
    ex[aim] = -1
    evt = event_window(geo, sim.mtab, sim.btab, sim.params)
    recs = {
        "E_pool": check_raycast_large("raycast_large[pool]", geo, pos, vel, ex),
        "E_inj": check_raycast_large("raycast_large[injections]", geo, pos[: sim.params.inj_cap],
                                     vel[: sim.params.inj_cap], ex[: sim.params.inj_cap]),
        "E_evt": check_raycast_large("raycast_large[events]", geo, pos[:evt], vel[:evt], ex[:evt]),
        # the narrow rounds 2+ (sim/fused.py evt2_cap: EVT_CAP // 16 here)
        "E_narrow": check_raycast_large("raycast_large[narrow rounds]", geo, pos[:pad8(max(evt // 16, 512))],
                                        vel[:pad8(max(evt // 16, 512))], ex[:pad8(max(evt // 16, 512))]),
    }
    # kernel A, cast-off: the compacted pool with 1% of its lanes pre-cast
    pool_c, _ = compact_pool.compact_pool_plain(pool)
    g = torch.Generator(device=device).manual_seed(11)
    pre = torch.nonzero((torch.rand(N, generator=g, device=device) < 0.01)
                        & (pool_c[C_ALIVE] > 0.5)).flatten()
    t, f = raycast(geo, pool_c[0:3, pre].T, pool_c[3:6, pre].T,
                   pool_c[C_ONF, pre].contiguous().view(torch.int32))
    pool_c[C_TCOLL, pre] = -(t / sim.params.dt) - 1.0
    pool_c[C_CF, pre] = as_f32(f)
    cfg = mega_config(geo, sim.mtab, sim.btab, sim.params, evt)
    assert not cfg.kernel_cast
    recs["castoff"] = check_megastep("drift_megastep[cast-off]", pool_c, sim.state.T_sv, cfg, 3, 0)
    # the pre-cast lanes skip the deferred RTA they predate; the others take it
    pk = pool_c.clone()
    drift_megastep(pk, sim.state.T_sv, True, cfg)
    same = pk[C_DEV].view(torch.int32) == pool_c[C_DEV].view(torch.int32)
    alive = pool_c[C_ALIVE] > 0.5
    if not bool(same[pre].all()) or float(same[alive].float().mean()) > 0.5:
        raise AssertionError("cast-off: the pre-cast lanes must skip the deferred RTA, the rest take it")
    print(f"  cast-off: {pre.numel()} pre-cast lanes kept their occupation under RTA", flush=True)
    return recs


def driver_path(tag, make_argv, mat, card, steps):
    """One configuration through the driver entry a user runs,
    `Simulation(read_args(argv), material=mat).run()`, with kernel A's, B's
    and C's launch counters zeroed just before the Simulation is built and
    read after its run, and every sample_injections call of the step logged
    (n_valid, dropped: host ints, no device read). Prints the configuration,
    T_sv, the population and losses, ms/step and updates/s over the
    device_step time of the last 2 of its 100-step blocks beside the card,
    the set-up time and the driver's phases. Returns (sim, its folder,
    launches, stats)."""
    import tempfile

    import torch

    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.ops import compact, compact_pool, megastep
    from nanokappa_torch.sim import fused
    from nanokappa_torch.sim.fused import event_window

    log = []
    sample = fused.sample_injections

    def logged(*a, **k):
        out = sample(*a, **k)
        log.append((out[1], out[3]))
        return out

    mods = (megastep, compact_pool, compact)
    for m in mods:
        m.launches = 0
    t0 = time.perf_counter()
    td = tempfile.mkdtemp(prefix=f"chip_smoke_{tag.replace(' ', '_')}_")
    fused.sample_injections = logged
    try:
        sim = Simulation(read_args(make_argv(td)), material=mat)
        t_setup = time.perf_counter() - t0
        sim.run(verbose=False)
        torch.cuda.synchronize()
    finally:
        fused.sample_injections = sample
    wall = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}

    tm = sim.timer
    row = sim.window[-1]
    n0, n_alive = sim.n_p_target, int(row["N_p"])
    steps_t = tm.calls["device_step"][-2:]
    ms = sum(steps_t) / 200 * 1e3
    evt = event_window(sim.geo, sim.mtab, sim.btab, sim.params)
    events = sim.state.kernel_events.tolist()
    print(f"{tag}: {sim.geo.n_facets} facets, {sim.geo.n_subvols} {sim.geo.subvol_type} subvolumes, "
          f"layout {sim.state.layout}, reservoir_gen {sim.params.res_gen}, scattering "
          f"{sim.params.scat_model}, {sim.btab.n_rows} boundary-table rows, {n0} particles, pool "
          f"{sim.params.n_cap}, inj_cap {sim.params.inj_cap}, c_max {sim.params.c_max}, evt_cap {evt} "
          f"(regrows {sim.evt_regrows})", flush=True)
    print(f"{tag}: T_sv {[round(float(t), 3) for t in row['T']]}", flush=True)
    print(f"{tag}: N_p {n_alive} (start {n0}), lost {row['lost_split'].tolist()}, frozen "
          f"{row['frozen']}, escaped {sim.n_escaped_total}, launches {launches}, in-kernel diffuse "
          f"{events[0]}, flagged specular exports {events[1]}", flush=True)
    print(f"{tag}: {n_alive * 200 / sum(steps_t):.4g} updates/s ({ms:.3f} ms/step, device_step of the "
          f"last 2 blocks) on {card}; driver wall {wall:.1f} s (setup {t_setup:.1f} s)", flush=True)
    print(f"{tag}: " + tm.report().replace("\n", f"\n{tag}: "), flush=True)
    stats = dict(n0=n0, n_alive=n_alive, lost=row["lost_split"], T=row["T"], frozen=int(row["frozen"]),
                 events=events, ms=ms, injections=log, steps=sim.current_timestep == steps)
    return sim, td, launches, stats


def common_gates(tag, st, launches, T_lo, T_hi, stuck_gate=None):
    """The gates every new path shares: nothing dropped or defective (or
    nothing lost at all where `stuck_gate` is None), the population within
    5%, T_sv inside (T_lo, T_hi) and falling hot to cold, kernels A and C
    launched, every step run."""
    import numpy as np

    lost, T, n0 = st["lost"], st["T"], st["n0"]
    checks = {
        f"{tag}: population within 5%": abs(st["n_alive"] - n0) <= 0.05 * n0,
        f"{tag}: T_sv in ({T_lo:g}, {T_hi:g})": bool(((T > T_lo) & (T < T_hi)).all()),
        f"{tag}: T_sv falling hot to cold": bool((np.diff(T) < 0).all()),
        f"{tag}: A, C launched": launches["megastep"] > 0 and launches["compact"] > 0,
        f"{tag}: {NEW_STEPS} steps run": st["steps"],
    }
    if stuck_gate is None:
        checks[f"{tag}: lost == 0"] = sum(lost) == 0
    else:
        checks[f"{tag}: nothing dropped or defective"] = lost[0] == 0 and lost[2] == 0
        checks[f"{tag}: k_max-stuck <= {stuck_gate:g} per particle-step"] = (
            lost[1] <= stuck_gate * n0 * NEW_STEPS
        )
        checks[f"{tag}: frozen under 1% of N"] = st["frozen"] < 0.01 * n0
    return checks


def fork(state):
    """A copy of a state that a runner may advance without touching the
    original (the pool is the only tensor a step writes in place)."""
    import dataclasses

    return dataclasses.replace(state, pool=state.pool.clone())


def scheme_ms(sim, schemes, card):
    """ms/step of each reservoir scheme on copies of the run's final state,
    one warm-up and two timed 100-step blocks each, in turns (a, b, a, b).
    Returns {scheme: ms/step}."""
    import dataclasses

    import torch

    from nanokappa_torch.sim.reservoir import autosize_c_max
    from nanokappa_torch.sim.step import build_step

    runs = {}
    for g in schemes:
        prm = dataclasses.replace(sim.params, res_gen=g, c_max=autosize_c_max(sim.rtab))
        runs[g] = [build_step(sim.geo, sim.mtab, sim.btab, sim.rtab, prm, n_inner=10, n_outer=10),
                   fork(sim.state)]
        runs[g][0](runs[g][1])
    torch.cuda.synchronize()
    ms = {g: [] for g in schemes}
    for _ in range(2):
        for g in schemes:
            t0 = time.perf_counter()
            runs[g][0](runs[g][1])
            torch.cuda.synchronize()
            ms[g].append((time.perf_counter() - t0) * 10.0)
    out = {g: sum(v) / len(v) for g, v in ms.items()}
    print("reservoir schemes on one state: " + ", ".join(
        f"{g} {out[g]:.3f} ms/step ({', '.join(f'{x:.3f}' for x in ms[g])})" for g in schemes
    ) + f" on {card}", flush=True)
    return out


def ge_fixed_rate_main(card, device):
    """The Ge film (BASELINE config 2: examples/film_ge.txt's box, slices
    and walls, the synthetic 31^3 Ge table) under 'fixed_rate' through the
    driver; then kernel C on a 'fixed_rate' lattice of its tables, and the
    step's ms under 'fixed_rate' and 'constant' on its state. Returns
    (launches, checks, C's record)."""
    import numpy as np
    import torch

    from nanokappa_torch.material import synthetic_material

    t0 = time.perf_counter()
    mat = synthetic_material(mesh=(MESH, MESH, MESH), preset="Ge")
    print(f"Ge film: the 31^3 Ge table built in {time.perf_counter() - t0:.1f} s", flush=True)
    sim, td, launches, st = driver_path(
        "Ge film fixed_rate", lambda d: cli_argv(FILM, d, device, NEW_STEPS, "fixed_rate"), mat, card,
        NEW_STEPS,
    )
    ep = sim.rtab.enter_prob_host.astype(np.float64)
    frac = ep - np.floor(ep)
    inj = np.array([n + d for n, d in st["injections"]], dtype=np.float64)
    sigma = np.sqrt((frac * (1.0 - frac)).sum() / len(inj))
    print(f"Ge film fixed_rate: injections a step {inj.mean():.3f} over {len(inj)} steps against "
          f"sum(enter_prob) {ep.sum():.3f} (sigma of the mean {sigma:.4f}: "
          f"{(inj.mean() - ep.sum()) / sigma:+.2f} sigma), dropped {sum(d for _, d in st['injections'])}",
          flush=True)
    checks = common_gates("Ge film fixed_rate", st, launches, 298.0, 302.0)
    checks["Ge film fixed_rate: mean injections a step within 5 sigma of sum(enter_prob)"] = (
        abs(inj.mean() - ep.sum()) <= 5.0 * sigma and len(inj) == NEW_STEPS
    )
    # kernel C at the lattice: one 'fixed_rate' draw of this run's tables
    R, M = sim.rtab.enter_prob.shape
    c_max, cap = sim.params.c_max, sim.params.inj_cap
    g = torch.Generator(device=device).manual_seed(11)
    epd = sim.rtab.enter_prob.reshape(-1)
    fixed = torch.floor(epd)
    counts = (fixed + (torch.rand(R * M, generator=g, device=device) <= epd - fixed).float()).int()
    lattice = (counts[None, :] > torch.arange(c_max, device=device)[:, None]).reshape(-1)
    rec = check_compact("compact_indices[fixed_rate lattice]", [lattice], cap)
    print(f"  {rec['name']}: {c_max} x {R} x {M} = {lattice.numel()} lanes -> {cap}", flush=True)
    scheme_ms(sim, ("fixed_rate", "constant"), card)
    shutil.rmtree(td, ignore_errors=True)
    return launches, checks, rec


def si_one_to_one_main(mat, card, device):
    """The bench film under 'one_to_one' through the driver; then one
    sub-block of 10 single steps on a copy of its state, whose outputs must
    show every step injecting the previous step's n_leaving, clipped at
    inj_cap // R a reservoir, the clip counted as dropped; kernel C on the
    (R, inj_cap // R) blocks of its n_leaving; and the step's ms under
    'one_to_one' and 'pooled' on its state. Returns (launches, checks, C's
    record)."""
    import numpy as np
    import torch

    from nanokappa_torch.sim.step import build_step

    tag = "film one_to_one"
    sim, td, launches, st = driver_path(
        tag, lambda d: cli_argv(FILM, d, device, NEW_STEPS, "one_to_one"), mat, card, NEW_STEPS,
    )
    checks = common_gates(tag, st, launches, 298.0, 302.0)
    R, cap = sim.geo.n_reservoirs, sim.params.inj_cap
    per = cap // R
    state = fork(sim.state)
    n_prev = state.n_leaving.cpu().numpy().astype(np.int64)
    N_prev = int(state.alive.sum())
    lost_prev = state.lost.cpu().numpy().astype(np.int64)
    run1 = build_step(sim.geo, sim.mtab, sim.btab, sim.rtab, sim.params, n_inner=1, n_outer=10)
    _, out = run1(state)
    N_p = np.concatenate([[N_prev], out.N_p.cpu().numpy()])
    leave = np.concatenate([n_prev[None], out.n_leaving.cpu().numpy()]).astype(np.int64)
    lost = np.concatenate([lost_prev[None], out.lost_split.cpu().numpy()]).astype(np.int64)
    injected = np.diff(N_p) + leave[1:].sum(1) + np.diff(lost[:, 1] + lost[:, 2])
    expect = np.minimum(leave[:-1], per).sum(1)
    dropped = np.diff(lost[:, 0])
    print(f"{tag}: one sub-block of single steps: injected {injected.tolist()}, the previous "
          f"n_leaving clipped at {per} {expect.tolist()}, dropped {dropped.tolist()} (n_leaving "
          f"{leave[:-1].sum(1).tolist()})", flush=True)
    checks[f"{tag}: every step injects the previous n_leaving, clipped at inj_cap // R"] = bool(
        (injected == expect).all() and expect.sum() > 0
    )
    checks[f"{tag}: the clip counted as dropped"] = bool((dropped == leave[:-1].sum(1) - expect).all())
    # kernel C at the (R, per) blocks of the run's last n_leaving
    lane = torch.arange(R * per, device=device)
    blocks = (lane % per) < sim.state.n_leaving.to(device)[lane // per]
    rec = check_compact("compact_indices[one_to_one blocks]", [blocks], cap)
    print(f"  {rec['name']}: {R} x {per} = {blocks.numel()} lanes -> {cap}", flush=True)
    scheme_ms(sim, ("one_to_one", "pooled"), card)
    shutil.rmtree(td, ignore_errors=True)
    return launches, checks, rec


def row_hits(pool, T_sv, cfg, geo, btab, seeds=(1, 2, 3)):
    """(specular, diffuse) rough-wall hits per wall-table row, (NU,) int64
    each, over one kernel A launch per seed on copies of `pool`: a flagged
    lane exports with C_TCOLL = -2 and its facet in C_CF; a diffused lane
    stays with a new mode and its facet in C_ONF (the row: its front row;
    a membrane's back-side hits count on the front row too)."""
    import torch

    from nanokappa_torch.ops import megastep
    from nanokappa_torch.sim.fused import dkern_facet_tables
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, C_MODE, C_ONF, C_TCOLL

    row_of = torch.as_tensor(dkern_facet_tables(geo, btab)["facet_row"], device=pool.device)
    F, NU = row_of.shape[0], btab.n_rows

    def rows(facets):
        f = facets.long()
        return torch.where((f >= 0) & (f < F), row_of[f.clamp(0, F - 1)], NU)

    spec = torch.zeros(NU + 1, dtype=torch.int64, device=pool.device)
    diff = torch.zeros_like(spec)
    for seed in seeds:
        p = pool.clone()
        rx, _, counts, _, _ = megastep.drift_megastep(p, T_sv, True, cfg, seed=seed)
        k = int(counts[2])
        flagged = rx[C_TCOLL, :k] < -1.5
        spec += torch.bincount(rows(rx[C_CF, :k].view(torch.int32))[flagged], minlength=NU + 1)
        changed = (p[C_ALIVE] > 0.5) & (p[C_MODE].view(torch.int32) != pool[C_MODE].view(torch.int32))
        diff += torch.bincount(rows(p[C_ONF].view(torch.int32))[changed], minlength=NU + 1)
    return spec[:NU].cpu().numpy(), diff[:NU].cpu().numpy()


def rough_row_share(pool, T_sv, cfg, geo, btab, seeds=(1, 2, 3)):
    """(specular, diffuse) hits on wall-table rows >= 32 over one kernel A
    launch per seed on copies of `pool` (row_hits)."""
    spec, diff = row_hits(pool, T_sv, cfg, geo, btab, seeds)
    return int(spec[32:].sum()), int(diff[32:].sum())


def corrugated_main(mat, card, device):
    """The corrugated wire of examples/corrugated_wire.txt as written
    through the driver: 120 triangles (kernel A's cast), 40 wall-table rows
    (the partner mask in two words), the k model and 'constant' reservoirs;
    then kernel A on its pool against its twin, and the rough hits on rows
    >= 32 split into specular and diffuse over three launches. Returns
    (launches, checks, A's record)."""
    import torch

    from nanokappa_torch.ops.megastep import mega_config
    from nanokappa_torch.sim.fused import event_window
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, STALE

    tag = "corrugated wire"
    sim, td, launches, st = driver_path(
        tag, lambda d: example_argv(CORR_FILE, d, device, NEW_STEPS), mat, card, NEW_STEPS,
    )
    cfg = mega_config(sim.geo, sim.mtab, sim.btab, sim.params,
                      event_window(sim.geo, sim.mtab, sim.btab, sim.params))
    corr = sim.btab._host["corr"]
    cov = [round(float((corr[r] >= 0).mean()), 3) for r in range(corr.shape[0])]
    print(f"{tag}: {sim.geo.tri_origin.shape[0]} triangles, btab.n_rows {sim.btab.n_rows}, partner "
          f"mask words W = {cfg.cmask_w}, specular-partner coverage per row {cov}", flush=True)
    checks = common_gates(tag, st, launches, 295.0, 305.0, stuck_gate=1e-6)
    checks.update({
        f"{tag}: more than 32 wall-table rows": sim.btab.n_rows > 32,
        f"{tag}: the partner mask in 2 words": cfg.cmask_w == 2 and cfg.dkern,
        f"{tag}: in-kernel diffuse re-emissions > 0": st["events"][0] > 0,
    })
    pool = with_fresh(sim.state.pool, device)
    n_fresh = int(((pool[C_CF].view(torch.int32) == STALE) & (pool[C_ALIVE] > 0.5)).sum())
    spec, diff = rough_row_share(pool, sim.state.T_sv, cfg, sim.geo, sim.btab)
    share = spec / max(1, spec + diff)
    print(f"{tag}: rough hits on rows >= 32 over 3 launches on its pool: {spec} specular, {diff} "
          f"diffuse (specular share {share:.4g})", flush=True)
    checks[f"{tag}: specular share of the hits on rows >= 32 in (0, 1)"] = 0.0 < share < 1.0
    rec = check_megastep("drift_megastep[corrugated wire, 2 mask words]", pool, sim.state.T_sv, cfg, 3,
                         n_fresh * 45 * cfg.tris.shape[0])
    del pool
    shutil.rmtree(td, ignore_errors=True)
    return launches, checks, rec


def sweep_main(mat, card, device):
    """BASELINE config 3: the 12-sided wire at each eta of SWEEP_ETAS through
    the driver (every facet table and the partner mask printed first, at
    this grid), each run's kappa the mean of its last SWEEP_BLOCKS 10-step
    blocks with its standard error; at eta = 0, the specular and diffuse
    hits per wall-table row over three kernel A launches on its pool, and
    kernel A on that pool against its twin (the partial mask: 4 of 12 rows
    with partners). Returns ({eta: launches}, checks, A's record)."""
    import numpy as np
    import torch

    from nanokappa_torch.ops.megastep import mega_config
    from nanokappa_torch.sim.fused import dkern_facet_tables, event_window, mirror_eligible
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, STALE

    t0 = time.perf_counter()
    dom, geo, btab = build_ctx(mat, dict(WIRE12, bound_values=(305.0, 295.0, 0.0, 0.0)), device)
    corr = btab._host["corr"]
    cov = (corr >= 0).mean(axis=1)
    nrm = btab._host["u_normals"]
    ang = np.degrees(np.arctan2(nrm[:, 1], nrm[:, 0])) % 360.0
    print(f"sweep: the 12-sided wire at {MESH}^3: {geo.tri_origin.shape[0]} triangles, {btab.n_rows} "
          f"wall-table rows; specular-partner coverage per row (normal angle: coverage) "
          f"{[(round(float(a), 1), round(float(c), 4)) for a, c in zip(ang, cov)]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    covered = cov > 0
    checks = {"sweep: some rows covered, some not (a partial partner mask)": bool(covered.any() and (~covered).any())}
    del dom, geo, btab
    kappa, launches, rec = {}, {}, None
    for eta in SWEEP_ETAS:
        tag = f"wire12 eta={eta:g}"
        b = dict(WIRE12, bound_values=(305.0, 295.0, eta, eta))
        sim, td, launch, st = driver_path(
            tag, lambda d: cli_argv(b, d, device, NEW_STEPS, "constant", ("--n_mean", str(SWEEP_BLOCKS))),
            mat, card, NEW_STEPS,
        )
        ks = np.array([w["kappa_total"] for w in sim.window], dtype=np.float64)
        kappa[eta] = (float(ks.mean()), float(ks.std(ddof=1) / np.sqrt(len(ks))))
        launches[eta] = launch
        print(f"{tag}: kappa {kappa[eta][0]:.4f} +- {kappa[eta][1]:.4f} W/m/K (the last {len(ks)} "
              f"10-step blocks: {[round(float(k), 3) for k in ks]})", flush=True)
        checks.update(common_gates(tag, st, launch, 295.0, 305.0, stuck_gate=1e-6))
        checks[f"{tag}: off the mirror path, in-kernel diffuse on"] = (
            sim.state.layout == "plain"
            and not mirror_eligible(sim.geo, sim.btab, sim.params, sim.mtab)
        )
        checks[f"{tag}: in-kernel diffuse re-emissions > 0"] = st["events"][0] > 0
        if eta == 0.0:
            cfg = mega_config(sim.geo, sim.mtab, sim.btab, sim.params,
                              event_window(sim.geo, sim.mtab, sim.btab, sim.params))
            ft = dkern_facet_tables(sim.geo, sim.btab)
            pool = with_fresh(sim.state.pool, device)
            n_fresh = int(((pool[C_CF].view(torch.int32) == STALE) & (pool[C_ALIVE] > 0.5)).sum())
            spec, diff = row_hits(pool, sim.state.T_sv, cfg, sim.geo, sim.btab)
            print(f"{tag}: rough hits per wall-table row over 3 launches on its pool: specular "
                  f"{spec.tolist()}, diffuse {diff.tolist()}; flagged specular exports of the run "
                  f"{st['events'][1]}", flush=True)
            checks.update({
                f"{tag}: one-sided rows (no membrane), the mask in 1 word": (
                    not ft["two_sided"] and cfg.cmask_w == 1 and cfg.dkern
                ),
                f"{tag}: specular hits > 0 on every covered row": bool((spec[covered] > 0).all()),
                f"{tag}: no specular hit on an uncovered row": bool((spec[~covered] == 0).all()),
                # a covered row's wall lies on a mirror plane of the cubic
                # grid: every mode that reaches it has its partner
                f"{tag}: diffuse hits > 0 on every uncovered row": bool((diff[~covered] > 0).all()),
                f"{tag}: flagged specular exports > 0": st["events"][1] > 0,
            })
            rec = check_megastep("drift_megastep[wire12 eta=0, partial mask]", pool, sim.state.T_sv, cfg, 3,
                                 n_fresh * 45 * cfg.tris.shape[0])
            del pool
        shutil.rmtree(td, ignore_errors=True)
        del sim
        torch.cuda.empty_cache()
    (k0, s0), (k2, s2), (k10, s10) = (kappa[e] for e in SWEEP_ETAS)
    print(f"sweep: kappa(eta) {k0:.4f} +- {s0:.4f}, {k2:.4f} +- {s2:.4f}, {k10:.4f} +- {s10:.4f} W/m/K; "
          f"kappa(10) / kappa(0) = {k10 / k0:.4f} (the JAX test asks < {JAX_SWEEP_RATIO}) on {card}",
          flush=True)
    checks.update({
        "sweep: kappa(0) > kappa(2) > kappa(10) > 0": k0 > k2 > k10 > 0,
        "sweep: kappa(0) - kappa(2) >= 3 standard errors": k0 - k2 >= 3.0 * np.hypot(s0, s2),
        "sweep: kappa(2) - kappa(10) >= 3 standard errors": k2 - k10 >= 3.0 * np.hypot(s2, s10),
    })
    return launches, checks, rec


def membrane_box(L=2e3, W=1e3, H=1e3):
    """The box of tests/test_interfaces.py:22 with doubled membrane sheets
    (what a two-solid STL export gives): L x W x H, the internal wall at
    x = L/2 as two coincident sheets of opposite winding, 24 triangles."""
    import numpy as np

    from nanokappa_torch.geometry.mesh import TriMesh

    xs = (0.0, L / 2, L)
    v = np.array([(x, y, z) for x in xs for y in (0.0, W) for z in (0.0, H)], dtype=float)

    def vid(i, j, k):
        return i * 4 + j * 2 + k

    faces = []

    def quad(a, b, c, d):
        faces.extend([[a, b, c], [a, c, d]])

    quad(vid(0, 0, 0), vid(0, 0, 1), vid(0, 1, 1), vid(0, 1, 0))
    quad(vid(2, 0, 0), vid(2, 1, 0), vid(2, 1, 1), vid(2, 0, 1))
    for i in range(2):
        quad(vid(i, 0, 0), vid(i + 1, 0, 0), vid(i + 1, 0, 1), vid(i, 0, 1))
        quad(vid(i, 1, 0), vid(i, 1, 1), vid(i + 1, 1, 1), vid(i + 1, 1, 0))
        quad(vid(i, 0, 0), vid(i, 1, 0), vid(i + 1, 1, 0), vid(i + 1, 0, 0))
        quad(vid(i, 0, 1), vid(i + 1, 0, 1), vid(i + 1, 1, 1), vid(i, 1, 1))
    quad(vid(1, 0, 0), vid(1, 0, 1), vid(1, 1, 1), vid(1, 1, 0))
    quad(vid(1, 0, 0), vid(1, 1, 0), vid(1, 1, 1), vid(1, 0, 1))
    return TriMesh(v, np.array(faces))


def membrane_hits(pool, T_sv, cfg, dom, mem, seed=3):
    """(front, back, crossed) over one kernel A launch on a copy of `pool`:
    the lanes that diffused at the membrane facet, by the side they started
    the step on (front: behind the facet's normal), and those of them whose
    new mode points through the wall (a front hit must leave with v.n < 0,
    a back hit with v.n > 0)."""
    import torch

    from nanokappa_torch.ops import megastep
    from nanokappa_torch.sim.state import C_ALIVE, C_MODE, C_ONF

    p = pool.clone()
    megastep.drift_megastep(p, T_sv, True, cfg, seed=seed)
    on = (p[C_ALIVE] > 0.5) & (p[C_ONF].view(torch.int32) == mem)
    on &= p[C_MODE].view(torch.int32) != pool[C_MODE].view(torch.int32)
    n = torch.as_tensor(dom.mesh.facet_normals[mem], dtype=torch.float32, device=pool.device)
    side = (pool[0:3] - torch.as_tensor(dom.mesh.facet_centroids[mem], dtype=torch.float32,
                                        device=pool.device)[:, None] * 1.0)
    side = (side * n[:, None]).sum(0)  # < 0: behind the normal (the front region)
    vdn = (p[3:6] * n[:, None]).sum(0)
    front, back = on & (side < 0), on & (side > 0)
    crossed = (front | back) & (vdn * side <= 0)
    return int(front.sum()), int(back.sum()), int(crossed.sum())


def membrane_sides(rows, mem_x, mem):
    """(C, n) rows -> (n,) int8: -1 where the lane is on the x < mem_x side
    of the membrane, +1 on the other, 0 for a dead lane. A lane within
    0.1 A of the plane may sit a rounding past it (a flight cast once and
    drifted step by step in float32 ends up to ~1e-2 A off the wall), and
    Np_sv bins it by its x: such a lane is on the side it moves away from
    while the membrane is its next hit, on the side it moves into when the
    membrane is the facet it left, and elsewhere on the side of its x."""
    import torch

    from nanokappa_torch.sim.state import C_ALIVE, C_CF, C_ONF

    d = rows[0] - mem_x
    direction = torch.sign(rows[3])
    toward = rows[C_CF].view(torch.int32) == mem
    leaving = rows[C_ONF].view(torch.int32) == mem
    near = (d.abs() < 0.1) & (direction != 0)
    d = torch.where(near & toward, -direction, torch.where(near & leaving, direction, d))
    return torch.where(rows[C_ALIVE] > 0.5, torch.sign(d), 0.0).to(torch.int8)


def rim_distance(p, dom, mem):
    """Distance (A) of (3, n) points to the rim of the membrane facet (the
    edges where it meets the outer walls): the membrane spans the box's
    whole y-z cross section at x = its centroid's x."""
    import torch

    lo = torch.as_tensor(dom.mesh.bounds[0], dtype=p.dtype, device=p.device)
    hi = torch.as_tensor(dom.mesh.bounds[1], dtype=p.dtype, device=p.device)
    dx = p[0] - float(dom.mesh.facet_centroids[mem][0])
    dp = torch.stack([p[1] - lo[1], hi[1] - p[1], p[2] - lo[2], hi[2] - p[2]]).amin(0).clamp(min=0.0)
    return torch.sqrt(dx * dx + dp * dp)


def membrane_main(mat, card, device):
    """(n1) the membrane box with every facet at eta = 10 A and no
    reservoirs through the library entry on the v2 step, NEW_STEPS single
    steps (the runner compacts the pool at each call, so every lane is
    followed from step to step: a lane kernel A exports comes back in the
    step's window at the tail, in export order) with the launch counters
    zeroed just before: at every step each side's lanes are the initial
    state's, bit for bit, once the lanes the narrow rounds removed (the
    k_max quarantine) and the lanes that changed side are counted, and
    every lane that changed side was within one step's flight (the
    fastest mode's speed x dt) of the membrane's rim at both ends of its
    step: the reference's cast takes hits up to 1e-4 ps behind a lane (no
    facing test) and gives a tie at an edge to the lower facet id, so at
    the rim a lane can reach the other side (ROADMAP queue 3); away from
    the rim the two-sided rows keep every lane on its side; frozen 0.
    (n3) kernel A's two-sided branch on its pool against its twin, with
    the membrane's diffuse hits of one launch split by side. Returns
    (launches, checks, A's record)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from nanokappa_torch.geometry import stl
    from nanokappa_torch.ops import compact, compact_pool, megastep
    from nanokappa_torch.ops.megastep import mega_config
    from nanokappa_torch.sim.fused import dkern_facet_tables, event_window, v2_eligible
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, STALE, init_state
    from nanokappa_torch.sim.step import build_step

    tag = "membrane (n1)"
    td = tempfile.mkdtemp(prefix="chip_smoke_membrane_")
    path = os.path.join(td, "membrane.stl")
    stl.save_stl(membrane_box(), path)
    t0 = time.perf_counter()
    dom, geo, btab = build_ctx(mat, dict(MEMBRANE_TIGHT, geometry=path), device)
    n_p, rtab, params = run_params(mat, dom, PARTICLES, "constant", device)
    tabs = mat.device_tables(device)
    ft = dkern_facet_tables(geo, btab)
    mem = int(dom.mesh.interfacets[0])
    mem_x = float(dom.mesh.facet_centroids[mem][0])
    reach = float(tabs.omega_vel[:, 1:4].norm(dim=1).max()) * params.dt
    evt = event_window(geo, tabs, btab, params)
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="mean", seed=SEED)
    N = params.n_cap
    side = membrane_sides(state.pool, mem_x, mem)
    side0 = np.array([int((side < 0).sum()), int((side > 0).sum())])
    print(f"{tag}: {geo.tri_origin.shape[0]} triangles, {geo.n_facets} facets (membrane {mem}: rows "
          f"{ft['facet_row'][mem]} front / {ft['facet_row_back'][mem]} back, two-sided "
          f"{ft['two_sided']}), {btab.n_rows} wall-table rows, {n_p} particles, pool {N}, evt_cap "
          f"{evt}, lanes a side at step 0 {side0.tolist()}, a step's reach {reach:.1f} A (set-up "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    exported = {}
    launch = megastep.drift_megastep

    def captured(pool, *a, **k):
        out = launch(pool, *a, **k)
        exported["idx"], exported["k"] = out[1], out[2][2]
        return out

    megastep.drift_megastep = captured  # the step binds it when built
    try:
        run = build_step(geo, tabs, btab, rtab, params, n_inner=1)
    finally:
        megastep.drift_megastep = launch
    mods = (megastep, compact_pool, compact)
    for m in mods:
        m.launches = 0
    lane = torch.arange(N, device=device)
    ids = torch.where(state.pool[C_ALIVE] > 0.5, lane, -1)  # a lane's identity: its initial slot
    removed, crossed = np.zeros(2, np.int64), np.zeros(2, np.int64)
    ok_counts, far, shown = True, 0, []
    np_sv = set()
    t0 = time.perf_counter()
    for _ in range(NEW_STEPS):
        slots = torch.nonzero(state.pool[C_ALIVE] > 0.5).flatten()  # the call's compaction
        n_alive = slots.shape[0]
        ids_c = torch.full((N,), -1, dtype=torch.int64, device=device)
        ids_c[:n_alive] = ids[slots]
        rows_b = state.pool[:, slots].clone()
        side_b = membrane_sides(rows_b, mem_x, mem)
        state, out = run(state)
        idx, k = exported["idx"], int(exported["k"])
        ids = ids_c.clone()
        ids[idx[:k].long()] = -1  # exported lanes leave their slots ...
        ids[n_alive:n_alive + k] = ids_c[idx[:k].long()]  # ... and come back in the window
        ids = torch.where(state.pool[C_ALIVE] > 0.5, ids, -1)
        side_a = membrane_sides(state.pool, mem_x, mem)
        # each lane's side before and after, by its identity
        by_id = torch.zeros(N, dtype=torch.int8, device=device)
        by_id[ids_c[:n_alive]] = side_b
        pos_b = torch.zeros((6, N), device=device)
        pos_b[:, ids_c[:n_alive]] = rows_b[0:6]
        alive_a = ids >= 0
        after = torch.zeros(N, dtype=torch.int8, device=device)
        after[ids[alive_a]] = side_a[alive_a]
        gone = (by_id != 0) & (after == 0)
        moved = (by_id != 0) & (after != 0) & (by_id != after)
        for s, j in ((-1, 0), (1, 1)):
            removed[j] += int((gone & (by_id == s)).sum())
            crossed[j] += int((moved & (by_id == s)).sum())
        if bool(moved.any()):
            m_ids = torch.nonzero(moved).flatten()
            slot_a = torch.full((N,), -1, dtype=torch.int64, device=device)
            slot_a[ids[alive_a]] = lane[alive_a]
            p_b = pos_b[0:3, m_ids]
            p_a = state.pool[0:3, slot_a[m_ids]]
            d_b, d_a = rim_distance(p_b, dom, mem), rim_distance(p_a, dom, mem)
            far += int(((d_b > reach) | (d_a > reach)).sum())
            for q in range(min(len(m_ids), 4 - len(shown))):
                shown.append((p_b[:, q].tolist(), pos_b[3:6, m_ids[q]].tolist(), p_a[:, q].tolist(),
                              float(d_b[q]), float(d_a[q])))
        now = np.array([int((side_a < 0).sum()), int((side_a > 0).sum())])
        # each side's lanes + its removed + those that left it - those that came
        ok_counts &= bool((now + removed + crossed - crossed[::-1] == side0).all())
        np_sv.add(tuple(out.Np_sv.tolist()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}
    lost = out.lost_split.tolist()
    events = state.kernel_events.tolist()
    rate = crossed.sum() / (n_p * NEW_STEPS)
    print(f"{tag}: removed lanes {lost} (drops, k_max-stuck, defective; {removed.tolist()} from the "
          f"x < {mem_x:g} side and the other), lanes that changed side {crossed.tolist()} (from each "
          f"side; {rate:.3g} per particle-step), {far} of them farther than a step's reach from the rim, "
          f"frozen {int(out.frozen)}, Np_sv over the run {len(np_sv)} distinct values (min "
          f"{min(np_sv)}, max {max(np_sv)}), launches {launches}, in-kernel diffuse {events[0]}, "
          f"flagged specular exports {events[1]}; {wall / NEW_STEPS * 1e3:.3f} ms/step (single steps, "
          f"each lane followed) on {card}", flush=True)
    for p_b, v_b, p_a, d_b, d_a in shown:
        print(f"{tag}: a lane that changed side: from {[round(x, 4) for x in p_b]} (v "
              f"{[round(x, 3) for x in v_b]}) to {[round(x, 4) for x in p_a]}, {d_b:.3f} and {d_a:.3f} A "
              f"from the rim", flush=True)
    checks = {
        f"{tag}: the v2 step": v2_eligible(geo, params),
        f"{tag}: the membrane's rows two-sided": bool(ft["two_sided"]),
        f"{tag}: frozen == 0": int(out.frozen) == 0,
        f"{tag}: each side's lanes the initial state's once removed and side-changing lanes are counted":
        ok_counts,
        f"{tag}: the lanes followed and removed are the step's removed lanes": int(removed.sum()) == sum(lost),
        f"{tag}: every side change within a step's reach of the membrane's rim": far == 0,
        f"{tag}: side changes (the rim) under 1e-7 per particle-step": rate <= 1e-7,
        f"{tag}: in-kernel diffuse re-emissions > 0": events[0] > 0,
        f"{tag}: A, B, C launched": all(v > 0 for v in launches.values()),
    }
    # (n3) kernel A's two-sided branch on this pool
    cfg = mega_config(geo, tabs, btab, params, evt)
    pool = with_fresh(state.pool, device)
    n_fresh = int(((pool[C_CF].view(torch.int32) == STALE) & (pool[C_ALIVE] > 0.5)).sum())
    front, back, through = membrane_hits(pool, state.T_sv, cfg, dom, mem)
    print(f"membrane (n3): diffuse hits on the membrane in one launch: front {front}, back {back}, "
          f"re-emitted through the wall {through}", flush=True)
    checks.update({
        "membrane (n3): hits on both sides": front > 0 and back > 0,
        "membrane (n3): no re-emission through the wall": through == 0,
    })
    rec = check_megastep("drift_megastep[membrane, two-sided]", pool, state.T_sv, cfg, 4,
                         n_fresh * 45 * cfg.tris.shape[0])
    del pool, state, run
    shutil.rmtree(td, ignore_errors=True)
    return launches, checks, rec


def membrane_cli_main(mat, card, device):
    """(n2) the membrane box with reservoirs at 305 / 295 K and the eta = 2 A
    membrane through the CLI's entry, `nanokappa_torch.cli.main(argv)`,
    for NEW_STEPS steps (the card's machine has no h5py to read a material
    folder, so the driver's loader hands the CLI the 31^3 table; the run is
    the CLI's own otherwise: results folder, arguments, Simulation, result
    files), with the launch counters zeroed just before. Returns
    (launches, checks)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from nanokappa_torch import cli, driver
    from nanokappa_torch.geometry import stl
    from nanokappa_torch.ops import compact, compact_pool, megastep

    tag = "membrane (n2)"
    td = tempfile.mkdtemp(prefix="chip_smoke_membrane_cli_")
    path = os.path.join(td, "membrane.stl")
    stl.save_stl(membrane_box(), path)
    made = []
    base = driver.Simulation

    class Captured(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    loader = driver.material_from_args
    driver.material_from_args, driver.Simulation = (lambda args: mat), Captured
    mods = (megastep, compact_pool, compact)
    for m in mods:
        m.launches = 0
    t0 = time.perf_counter()
    try:
        cli.main(cli_argv(dict(MEMBRANE_TRANSPORT, geometry=path), os.path.join(td, "res"), device,
                          NEW_STEPS, "constant"))
        torch.cuda.synchronize()
    finally:
        driver.material_from_args, driver.Simulation = loader, base
    wall = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}
    sim = made[0]
    row = sim.window[-1]
    n0, n_alive = sim.n_p_target, int(row["N_p"])
    lost, T = row["lost_split"], row["T"]
    steps_t = sim.timer.calls["device_step"][-2:]
    files = set(os.listdir(sim.folder))
    print(f"{tag}: the CLI in {wall:.1f} s: {sim.geo.n_facets} facets, {sim.btab.n_rows} wall-table rows, "
          f"{n0} particles, pool {sim.params.n_cap}; T_sv {[round(float(t), 3) for t in T]}, N_p {n_alive} "
          f"(start {n0}), lost {lost.tolist()}, frozen {row['frozen']}, escaped {sim.n_escaped_total}, "
          f"launches {launches}; {sum(steps_t) / 200 * 1e3:.3f} ms/step (device_step of the last 2 "
          f"blocks) on {card}", flush=True)
    checks = {
        f"{tag}: population within 5%": abs(n_alive - n0) <= 0.05 * n0,
        f"{tag}: lost <= 2% of N": int(sum(lost)) <= 0.02 * n0,
        f"{tag}: T_sv in (295, 305)": bool(((T > 295.0) & (T < 305.0)).all()),
        f"{tag}: the 4 slices' T_sv falling hot to cold": len(T) == 4 and bool((np.diff(T) < 0).all()),
        f"{tag}: {NEW_STEPS} steps run": sim.current_timestep == NEW_STEPS,
        f"{tag}: result files written": {"convergence.txt", "arguments.txt", "particle_data.txt"} <= files,
        f"{tag}: A, C launched": launches["megastep"] > 0 and launches["compact"] > 0,
    }
    del sim, made
    shutil.rmtree(td, ignore_errors=True)
    return launches, checks


# the sharded film (ROADMAP 1.1): the bench film at 10^7 particles in two
# ranks; on one card both ranks share cuda:0 over gloo (NCCL refuses two
# ranks on one GPU), so its ms/step is a record of time-slicing, not a speed
SHARD_PARTICLES = 1e7
SHARD_STEPS = 300
S1_STEPS = 10  # the NCCL world of one against the unsharded step


def bits_equal(a, b) -> bool:
    """Bit-equal tensors of one dtype and shape."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def sharded_film_rank(comm, out_dir, mat, argv):
    """One rank of the sharded film through the driver entry,
    `Simulation(read_args(argv), material=mat, comm=comm).run()`, with
    kernel A's, B's and C's launch counters zeroed just before the
    Simulation is built and read after its run. Writes its numbers to
    `<out_dir>/rank<r>.json`: set-up time, ms/step over the device_step time
    of the last 2 blocks, the host time of its all-reduces, the last T_sv,
    whether rank 0's T_sv (broadcast) equals its own bit for bit, its first
    in-kernel step seed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.ops import compact, compact_pool, megastep
    from nanokappa_torch.sim.fused import step_seed

    mods = (megastep, compact_pool, compact)
    for m in mods:
        m.launches = 0
    t0 = time.perf_counter()
    sim = Simulation(read_args(argv), material=mat, comm=comm)
    t_setup = time.perf_counter() - t0
    seed0 = step_seed(sim.state)
    dist.barrier()  # the ranks start the run together: the all-reduce times exclude set-up skew
    calls0, secs0 = comm.calls, comm.seconds
    sim.run(verbose=False)
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}
    T = sim.state.T_sv.clone()
    T0 = T.clone()
    dist.broadcast(T0, src=0)
    row = sim.window[-1]
    steps_t = sim.timer.calls["device_step"][-2:]
    rec = dict(
        rank=comm.rank, setup_s=t_setup, ms=sum(steps_t) / 200 * 1e3,
        allreduce_ms=(comm.seconds - secs0) / max(comm.calls - calls0, 1) * 1e3,
        allreduce_calls=comm.calls - calls0, T=np.asarray(row["T"]).tolist(),
        same_T=bits_equal(T, T0), N_p=int(row["N_p"]), n0=sim.n_p_target,
        lost=np.asarray(row["lost_split"]).tolist(), frozen=int(row["frozen"]),
        launches=launches, seed0=int(seed0), steps=sim.current_timestep,
        pool=int(sim.state.pool.shape[1]), n_cap=sim.params.n_cap,
        pool_gb=sim.state.pool.numel() * 4 / 1e9,
    )
    with open(os.path.join(out_dir, f"rank{comm.rank}.json"), "w") as f:
        json.dump(rec, f)


def sharded_ranks(tag, backend, devices, mat, card, T_ref, n_ref):
    """The film at SHARD_PARTICLES in len(devices) ranks through the
    driver (sharded_film_rank), with its gates."""
    import tempfile

    import numpy as np

    from nanokappa_torch.parallel.launch import launch

    td = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    argv = cli_argv(FILM, td, "cuda", SHARD_STEPS, "pooled",
                    ("--particles", "total", f"{SHARD_PARTICLES:.0f}", "--n_shards", str(len(devices))))
    t0 = time.perf_counter()
    launch(sharded_film_rank, len(devices), td, backend, devices, td, mat, argv)
    wall = time.perf_counter() - t0
    recs = []
    for r in range(len(devices)):
        with open(os.path.join(td, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    for r in recs:
        print(f"{tag}: rank {r['rank']} on {devices[r['rank']]}: set-up {r['setup_s']:.1f} s, "
              f"{r['ms']:.3f} ms/step (device_step of the last 2 blocks), all-reduce "
              f"{r['allreduce_ms']:.4f} ms of host time a call x {r['allreduce_calls']}, pool "
              f"{r['pool']} lanes ({r['pool_gb']:.3f} GB), launches {r['launches']}, first step "
              f"seed {r['seed0']} on {card}", flush=True)
    r0 = recs[0]
    T = np.asarray(r0["T"])
    dT = float(np.abs(T - T_ref).max())
    print(f"{tag}: {r0['n0']} particles ({n_ref:.0f} in the one-shard film), pool {r0['n_cap']}, "
          f"T_sv {[round(t, 3) for t in r0['T']]}, N_p {r0['N_p']}, lost {r0['lost']}, frozen "
          f"{r0['frozen']}, max |dT_sv| {dT:.4f} K against the one-shard film at step "
          f"{SHARD_STEPS}; launch wall {wall:.1f} s on {card}", flush=True)
    checks = {
        f"{tag}: {SHARD_STEPS} steps on every rank": all(r["steps"] == SHARD_STEPS for r in recs),
        f"{tag}: lost == 0": sum(r0["lost"]) == 0,
        f"{tag}: population within 5%": abs(r0["N_p"] - r0["n0"]) <= 0.05 * r0["n0"],
        f"{tag}: T_sv in (298, 302)": bool(((T > 298.0) & (T < 302.0)).all()),
        f"{tag}: T_sv falling hot to cold": bool((np.diff(T) < 0).all()),
        f"{tag}: within 0.5 K of the one-shard film": dT <= 0.5,
        f"{tag}: T_sv bit-identical on every rank": all(r["same_T"] for r in recs),
        f"{tag}: A, B, C launched on every rank": all(
            all(v > 0 for v in r["launches"].values()) for r in recs),
        f"{tag}: the ranks' first step seeds differ": len({r["seed0"] for r in recs}) == len(recs),
    }
    shutil.rmtree(td, ignore_errors=True)
    return checks


def sharded_main(mat, card, device, f_ctx, T_ref):
    """The sharded film: (a) an NCCL world of one rank on the card, S1_STEPS
    v2 steps of the bench film through build_sharded_step bit for bit
    against build_step from one state and seed; (b) two gloo ranks on
    cuda:0, the film at SHARD_PARTICLES through the driver; (c) with two
    cards or more, the same with NCCL and one rank a card."""
    import tempfile

    import torch
    import torch.distributed as dist

    from nanokappa_torch.parallel import build_sharded_step, make_particle_group, shard_state
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import StepOutputs, build_step

    f_dom, f_geo, f_btab, f_rtab, f_params, f_np, tabs = f_ctx
    td = tempfile.mkdtemp(prefix="chip_smoke_nccl1_")
    dist.init_process_group("nccl", init_method=f"file://{td}/rdv", world_size=1, rank=0)
    try:
        comm = make_particle_group(1, device)
        comm.allreduce_sum_(torch.zeros(1, device=device))  # NCCL's first call sets it up
        comm.calls, comm.seconds = 0, 0.0
        kw = dict(temp_dist="linear", seed=SEED)
        ref = init_state(mat, f_dom, f_geo, f_params, f_np, f_btab, **kw)
        host = init_state(mat, f_dom, f_geo, f_params, f_np, f_btab, host_only=True, **kw)
        mine = shard_state(host, comm, f_geo, f_params.dt)
        del host
        ref, o0 = build_step(f_geo, tabs, f_btab, f_rtab, f_params, n_inner=S1_STEPS)(ref)
        mine, o1 = build_sharded_step(f_geo, tabs, f_btab, f_rtab, f_params, comm, n_inner=S1_STEPS)(mine)
        torch.cuda.synchronize()
        same = all(bits_equal(getattr(o0, f), getattr(o1, f)) for f in StepOutputs.__dataclass_fields__)
        same_pool = bits_equal(ref.pool, mine.pool)
        print(f"sharded film (a): an NCCL world of one on {device}, {S1_STEPS} v2 steps of the "
              f"{f_np}-particle film through build_sharded_step: outputs bit-equal {same}, pool "
              f"bit-equal {same_pool}, {comm.calls} all-reduces, {comm.seconds / comm.calls * 1e3:.4f} "
              f"ms of host time a call on {card}", flush=True)
        checks = {
            "sharded film (a): one NCCL rank bit-equal to the unsharded step": same and same_pool,
            "sharded film (a): one all-reduce a step": comm.calls == S1_STEPS,
        }
    finally:
        dist.destroy_process_group()
        shutil.rmtree(td, ignore_errors=True)
    del ref, mine
    torch.cuda.empty_cache()

    checks.update(sharded_ranks("sharded film (b)", "gloo", ["cuda:0", "cuda:0"], mat, card, T_ref, f_np))
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        checks.update(sharded_ranks("sharded film (c)", "nccl", ["cuda:0", "cuda:1"], mat, card,
                                    T_ref, f_np))
    else:
        print(f"sharded film (c): not run: this machine has {n_cards} card (NCCL takes one rank a "
              f"card)", flush=True)
    return checks


def main(device=None) -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card")
    import dataclasses

    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops import _cuda
    from nanokappa_torch.ops.megastep import mega_config
    from nanokappa_torch.sim.boundary_tables import slim_mirror_axis
    from nanokappa_torch.sim.fused import event_window, mirror_eligible
    from nanokappa_torch.sim.reservoir import constant_counts
    from nanokappa_torch.sim.state import C_CF, C_ALIVE, STALE, init_state
    from nanokappa_torch.sim.step import build_step

    card = card_line()
    print(card, flush=True)
    t_start = time.perf_counter()

    device = torch.device(device or "cuda:0")
    t0 = time.perf_counter()
    _cuda.library(verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_cuda.build_seconds and round(_cuda.build_seconds, 1)} s)", flush=True)

    t0 = time.perf_counter()
    mat = synthetic_material(mesh=(MESH, MESH, MESH))
    tabs = mat.device_tables(device)
    f_dom, f_geo, f_btab = build_ctx(mat, FILM, device)
    f_np, f_rtab, f_params = run_params(mat, f_dom, PARTICLES, "pooled", device)
    w_dom, w_geo, w_btab = build_ctx(mat, WIRE, device)
    w_np, w_rtab, w_params = run_params(mat, w_dom, PARTICLES, "constant", device)
    f_evt = event_window(f_geo, tabs, f_btab, f_params)
    w_evt = event_window(w_geo, tabs, w_btab, w_params)
    w_cov = float((w_btab._host["corr"] >= 0).mean())
    print(f"contexts: {mat.n_modes} modes; film {f_np} particles, pool {f_params.n_cap}, "
          f"inj_cap {f_params.inj_cap}, evt_cap {f_evt}; wire {w_np} particles, pool "
          f"{w_params.n_cap}, inj_cap {w_params.inj_cap}, c_max {w_params.c_max}, evt_cap {w_evt}, "
          f"specular-partner coverage {w_cov} ({time.perf_counter() - t0:.1f} s)", flush=True)
    assert mirror_eligible(f_geo, f_btab, f_params, tabs) and not mirror_eligible(w_geo, w_btab, w_params, tabs)

    # ---- each kernel against its plain twin, on realistic pools ------------
    t0 = time.perf_counter()
    f_pre = init_state(mat, f_dom, f_geo, f_params, f_np, f_btab, temp_dist="linear", seed=SEED + 1)
    build_step(f_geo, tabs, f_btab, f_rtab, f_params, n_inner=10)(f_pre)
    w_pre = init_state(mat, w_dom, w_geo, w_params, w_np, w_btab, temp_dist="linear", seed=SEED + 1)
    build_step(w_geo, tabs, w_btab, w_rtab, w_params, n_inner=10)(w_pre)
    f_cfg = mega_config(f_geo, tabs, f_btab, f_params, f_evt, slim_mirror_axis(f_geo, f_btab, tabs))
    w_cfg = mega_config(w_geo, tabs, w_btab, w_params, w_evt)
    f_pool, w_pool = with_fresh(f_pre.pool, device), with_fresh(w_pre.pool, device)
    n_fresh = int(((w_pool[C_CF].view(torch.int32) == STALE) & (w_pool[C_ALIVE] > 0.5)).sum())
    # the film's pool under linear temperatures, and re-binned by the
    # 256-centre grid (slim, the nearest-centre loop at its cap)
    fl_params = dataclasses.replace(f_params, temp_interp="linear")
    fl_cfg = mega_config(f_geo, tabs, f_btab, fl_params, f_evt, slim_mirror_axis(f_geo, f_btab, tabs))
    g_dom, g_geo = grid_film(f_dom, device)
    g_cx = g_geo.subvol_center[:, 0]
    g_T = 302.0 - 4.0 * (g_cx - g_cx.min()) / (g_cx.max() - g_cx.min())
    g_cfg = mega_config(g_geo, tabs, f_btab, f_params, f_evt, slim_mirror_axis(f_geo, f_btab, tabs))
    recs = {
        "film": check_megastep("drift_megastep[film]", f_pool, f_pre.T_sv, f_cfg, 1, 0),
        "film_linear": check_megastep("drift_megastep[film linear]", f_pool, f_pre.T_sv, fl_cfg, 1, 0),
        "film_centre256": check_megastep("drift_megastep[film centre 256]", f_pool, g_T.contiguous(),
                                         g_cfg, 1, 0),
        "wire": check_megastep("drift_megastep[wire]", w_pool, w_pre.T_sv, w_cfg, 2,
                               n_fresh * 45 * w_cfg.tris.shape[0]),
        "pool": check_compact_pool([f_pre.pool, w_pre.pool]),
    }
    # kernel A's full mirror on the triangle cast (slice/nearest and
    # slice/linear): the wire's pool with a crafted 24-row mirror cache (no
    # configuration puts a mesh on the full mirror at this grid)
    wf_pool = crafted_full_pool(w_pool, w_pre.T_sv, tabs, 2)
    wl_params = dataclasses.replace(w_params, temp_interp="linear")
    off_path = [
        check_megastep(f"drift_megastep[wire full{tag}, crafted]", wf_pool, w_pre.T_sv,
                       mega_config(w_geo, tabs, w_btab, prm, w_evt, layout="full"), 2,
                       n_fresh * 45 * w_cfg.tris.shape[0])
        for tag, prm in (("", w_params), (" linear", wl_params))
    ]
    del wf_pool
    # kernel C: the film's survivors (2048 -> 512), the wire's (E -> E/8) and
    # the 'constant' lattice (c_max x R x M -> inj_cap) of this wire
    g = torch.Generator(device=device).manual_seed(7)
    surv = [torch.rand(E, generator=g, device=device) < p for E in (f_evt, w_evt) for p in (0.05, 0.5)]
    recs["survivors"] = check_compact("compact_indices[survivors]", surv[:2], 512)
    check_compact("compact_indices[wire survivors]", surv[2:], max(w_evt // 8, 512))
    counts, _, _ = constant_counts(w_pre.res_counter, w_rtab, 1, w_params.c_max)
    counts = torch.as_tensor(counts, device=device)
    lattice = counts[None, :] > torch.arange(w_params.c_max, device=device)[:, None]
    recs["lattice"] = check_compact("compact_indices[lattice]", [lattice.reshape(-1)], w_params.inj_cap)
    for r in list(recs.values()) + off_path:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms (calls back to back {r['event_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms'] and round(r['library_ms'], 4)} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']:.3g} "
              f"({r['match']})", flush=True)
    # the flagged-specular path: the wire's walls have no specular partner on
    # this grid, so it is held on a small rough box whose walls do
    dT = small_check(device, dict(FILM, dimensions=(2e3, 1e3, 1e3), subvolumes=("slice", 5, 0),
                                  bound_pos=("relative", 0.5, -0.1, 0.5, 0.5, 1.1, 0.5),
                                  bound_cond=("R", "R"), bound_values=(0.0, 0.0),
                                  connect_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5,
                                               0.5, 0.5, -0.1, 0.5, 0.5, 1.1)),
                     [299.0, 299.5, 300.0, 300.5, 301.0], 1e-4)
    dTw = small_check(device, dict(WIRE, bound_pos=("relative", 1.1, 0.5, 0.5), bound_cond=("R", "R"),
                                   bound_values=(2.0, 2.0)),
                      [299.0, 299.5, 300.0, 300.5, 301.0], 1e-4)
    print(f"kernel checks + small film and closed wire vs CPU passed (max |dT_sv| {dT:.3g} K, "
          f"{dTw:.3g} K) in {time.perf_counter() - t0:.1f} s", flush=True)
    del f_pre, w_pre, f_pool, w_pool, surv, lattice
    torch.cuda.empty_cache()

    # ---- the main paths ---------------------------------------------------------
    checks = {}
    out, n0, f_launch, _, _, f_T = main_path("film", mat, f_dom, f_geo, f_btab, f_rtab, f_params, f_np, tabs, card)
    T = out.T_sv[-1].cpu().numpy()
    n_alive, lost = int(out.N_p[-1]), out.lost_split[-1].tolist()
    checks.update({
        "film: lost == 0": sum(lost) == 0,
        "film: population within 5%": abs(n_alive - n0) <= 0.05 * n0,
        "film: T_sv in (298, 302)": bool(((T > 298.0) & (T < 302.0)).all()),
        "film: T_sv hot end > cold end": bool(T[0] > T[-1]),
        "film: A, B, C launched": all(v > 0 for v in f_launch.values()),
    })
    # ---- the same film on the v1 step: the card's cross-check of the steps ---
    out, n0, v1_d, v1_dT, v1_layout = v1_film(mat, f_dom, f_geo, f_btab, f_rtab, f_params, f_np, tabs, f_T[100])
    T = out.T_sv[-1].cpu().numpy()
    checks.update({
        "film v1: the plain pool (the v1 step)": v1_layout == "plain",
        "film v1: lost == 0": int(out.lost[-1]) == 0,
        "film v1: T_sv in (298, 302)": bool(((T > 298.0) & (T < 302.0)).all()),
        "film v1: within 0.5 K of the v2 film": v1_dT <= 0.5,
        "film v1: D launched once per step": v1_d == V1_FILM_STEPS,
    })
    out, n0, w_launch, events, _, _ = main_path("wire", mat, w_dom, w_geo, w_btab, w_rtab, w_params, w_np, tabs, card)
    T = out.T_sv[-1].cpu().numpy()
    n_alive, lost = int(out.N_p[-1]), out.lost_split[-1].tolist()
    checks.update({
        # capacity drops and defective lanes: none; lanes still bouncing
        # after k_max narrow rounds are quarantined, as in the JAX package
        "wire: nothing dropped or defective": lost[0] == 0 and lost[2] == 0,
        "wire: k_max-stuck below 1e-6 per particle-step": lost[1] <= 1e-6 * n0 * 500,
        "wire: frozen under 1% of N": int(out.frozen[-1]) < 0.01 * n0,
        "wire: population within 5%": abs(n_alive - n0) <= 0.05 * n0,
        "wire: T_sv in (295, 305)": bool(((T > 295.0) & (T < 305.0)).all()),
        "wire: T_sv falling hot to cold": bool((np.diff(T) < 0).all()),
        "wire: in-kernel diffuse re-emissions > 0": events[0] > 0,
        # every specular decision is flagged; with no specular partner on
        # these walls there is none to flag
        "wire: flagged specular exports == 0 (coverage 0)": events[1] == 0 if w_cov == 0 else events[1] > 0,
        "wire: A, B, C launched": all(v > 0 for v in w_launch.values()),
    })
    del out
    torch.cuda.empty_cache()

    # ---- the film with linear temperatures, and on 256 grid centres ----------
    out, n0, fl_launch = short_path("film linear", mat, f_dom, f_geo, f_btab, f_rtab, fl_params,
                                    f_np, tabs, card)
    T = out.T_sv[-1].cpu().numpy()
    checks.update({
        "film linear: lost == 0": int(out.lost[-1]) == 0,
        "film linear: population within 5%": abs(int(out.N_p[-1]) - n0) <= 0.05 * n0,
        "film linear: T_sv in (298, 302), hot end > cold end":
        bool(((T > 298.0) & (T < 302.0)).all() and T[0] > T[-1]),
        "film linear: A launched": fl_launch > 0,
    })
    out, n0, g_launch = short_path("film centre 256", mat, g_dom, g_geo, f_btab, f_rtab, f_params,
                                   f_np, tabs, card)
    T = out.T_sv[-1].cpu().numpy()
    checks.update({
        "film centre 256: lost == 0": int(out.lost[-1]) == 0,
        "film centre 256: population within 5%": abs(int(out.N_p[-1]) - n0) <= 0.05 * n0,
        "film centre 256: T_sv in (298, 302)": bool(((T > 298.0) & (T < 302.0)).all()),
        "film centre 256: A launched": g_launch > 0,
    })
    del out
    torch.cuda.empty_cache()

    # ---- the k model on the mirror path: the bench film's eta = 0 map
    # through the driver, on kernel A's full 24-row mirror ---------------------
    sim, sim_dir, k0_launch, k0_checks = kfilm0_main(mat, card, device)
    checks.update(k0_checks)
    k0_evt = event_window(sim.geo, sim.mtab, sim.btab, sim.params)
    k0_pool = with_fresh(sim.state.pool, device)
    recs["kfilm0"] = check_megastep(
        "drift_megastep[k film full]", k0_pool, sim.state.T_sv,
        mega_config(sim.geo, sim.mtab, sim.btab, sim.params, k0_evt, layout="full"), 6, 0,
    )
    recs["pool_full"] = check_compact_pool([sim.state.pool], "compact_pool[24 rows]")
    # the full branch's other instantiations, held on the same pool: the
    # box cast under linear T and on the 256-centre grid
    full_off = [
        check_megastep("drift_megastep[k film full linear]", k0_pool, sim.state.T_sv,
                       mega_config(sim.geo, sim.mtab, sim.btab, fl_params, k0_evt, layout="full"), 6, 0),
        check_megastep("drift_megastep[k film full centre 256]", k0_pool, g_T.contiguous(),
                       mega_config(g_geo, sim.mtab, sim.btab, f_params, k0_evt, layout="full"), 6, 0),
    ]
    del sim, k0_pool
    shutil.rmtree(sim_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- the k model off the mirror path: its eta = 2 A film -------------------
    k_dom, k_geo, k_btab = build_ctx(mat, KFILM, device, "k")
    k_np, k_rtab, k_params = run_params(mat, k_dom, PARTICLES, "pooled", device)
    k_params = dataclasses.replace(k_params, temp_interp="linear", scat_model="k")
    print(f"k film: layout {'slim' if mirror_eligible(k_geo, k_btab, k_params, tabs) else 'plain'}, "
          f"evt_cap {event_window(k_geo, tabs, k_btab, k_params)}", flush=True)
    out, n0, k_launch, events, k_state, _ = main_path(
        "k film", mat, k_dom, k_geo, k_btab, k_rtab, k_params, k_np, tabs, card,
    )
    T = out.T_sv[-1].cpu().numpy()
    n_alive, lost = int(out.N_p[-1]), out.lost_split[-1].tolist()
    checks.update({
        "k film: plain layout (off the mirror path)": k_state.layout == "plain",
        "k film: nothing dropped or defective": lost[0] == 0 and lost[2] == 0,
        "k film: population within 5%": abs(n_alive - n0) <= 0.05 * n0,
        "k film: T_sv in (298, 302)": bool(((T > 298.0) & (T < 302.0)).all()),
        "k film: T_sv falling hot to cold": bool((np.diff(T) < 0).all()),
        "k film: degenerate-branch swaps > 0": events[2] > 0,
        "k film: A, B, C launched": all(v > 0 for v in k_launch.values()),
    })
    k_cfg = mega_config(k_geo, tabs, k_btab, k_params, event_window(k_geo, tabs, k_btab, k_params))
    recs["kfilm_linear"] = check_megastep("drift_megastep[k film linear]", with_fresh(k_state.pool, device),
                                          k_state.T_sv, k_cfg, 4, 0)
    del out, k_state, k_btab
    torch.cuda.empty_cache()

    # ---- the plate through the driver, then its kernel check -----------------
    sim, sim_dir, p_launch, p_checks = plate_main(mat, card, device)
    checks.update(p_checks)
    p_pool = with_fresh(sim.state.pool, device)
    p_fresh = int(((p_pool[C_CF].view(torch.int32) == STALE) & (p_pool[C_ALIVE] > 0.5)).sum())
    p_cfg = mega_config(sim.geo, sim.mtab, sim.btab, sim.params,
                        event_window(sim.geo, sim.mtab, sim.btab, sim.params))
    recs["plate"] = check_megastep("drift_megastep[plate centre 8]", p_pool, sim.state.T_sv, p_cfg, 5,
                                   p_fresh * 45 * p_cfg.tris.shape[0])
    # the full branch's triangle cast in the centre mode, on the plate's
    # pool with a crafted mirror cache
    full_off.append(check_megastep(
        "drift_megastep[plate full centre 8, crafted]", crafted_full_pool(p_pool, sim.state.T_sv, tabs, 8),
        sim.state.T_sv, mega_config(sim.geo, sim.mtab, sim.btab, sim.params, p_cfg.ecap, layout="full"),
        5, p_fresh * 45 * p_cfg.tris.shape[0],
    ))
    del sim, p_pool
    shutil.rmtree(sim_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    for r in [recs[k] for k in ("film_linear", "film_centre256", "kfilm0", "pool_full", "kfilm_linear",
                                "plate")] + full_off:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms (calls back to back {r['event_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']:.3g} "
              f"({r['match']})", flush=True)

    # ---- the large mesh through the driver, then its kernel checks -----------

    sim, sim_dir, b_launch, b_checks = bigmesh_main(mat, card, device)
    checks.update(b_checks)
    t0 = time.perf_counter()
    recs.update(bigmesh_kernel_checks(sim, device))
    for k in ("E_pool", "E_inj", "E_evt", "E_narrow", "castoff"):
        r = recs[k]
        shape = f", (G, R) = {r['shape']}" if "shape" in r else ""
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms{shape} (calls back to back {r['event_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']:.3g} "
              f"({r['match']})", flush=True)
    print(f"large-mesh kernel checks passed in {time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(sim_dir, ignore_errors=True)
    del sim
    torch.cuda.empty_cache()

    # ---- the star through the driver (the v1 step), then kernel D ------------
    sim, sim_dir, s_launch, s_checks = star_main(mat, card, device)
    checks.update(s_checks)
    recs["D"], recs["C_v1"] = check_scatter_rows(sim, device)
    for r in (recs["D"], recs["C_v1"]):
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms (calls back to back {r['event_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
              f"{r['max_abs_err']:.3g} ({r['match']})", flush=True)
    shutil.rmtree(sim_dir, ignore_errors=True)
    del sim
    torch.cuda.empty_cache()

    # ---- the reservoir schemes and the partner mask in words -----------------
    ge_launch, ge_checks, recs["C_fixed_rate"] = ge_fixed_rate_main(card, device)
    checks.update(ge_checks)
    torch.cuda.empty_cache()
    o2o_launch, o2o_checks, recs["C_one_to_one"] = si_one_to_one_main(mat, card, device)
    checks.update(o2o_checks)
    torch.cuda.empty_cache()
    cw_launch, cw_checks, recs["corrugated"] = corrugated_main(mat, card, device)
    checks.update(cw_checks)
    for k in ("C_fixed_rate", "C_one_to_one", "corrugated"):
        r = recs[k]
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms (calls back to back {r['event_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms'] and round(r['library_ms'], 4)} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']:.3g} "
              f"({r['match']})", flush=True)
    torch.cuda.empty_cache()
    # ---- (m) BASELINE config 3, the specularity sweep; (n) membranes -------------
    sw_launch, sw_checks, recs["wire12"] = sweep_main(mat, card, device)
    checks.update(sw_checks)
    mb_launch, mb_checks, recs["membrane"] = membrane_main(mat, card, device)
    checks.update(mb_checks)
    torch.cuda.empty_cache()
    _, mc_checks = membrane_cli_main(mat, card, device)
    checks.update(mc_checks)
    for k in ("wire12", "membrane"):
        r = recs[k]
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms (calls back to back {r['event_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
              f"{r['max_abs_err']:.3g} ({r['match']}) on {card}", flush=True)
    torch.cuda.empty_cache()
    # ---- the sharded film: one NCCL rank, two ranks on one card -------------
    checks.update(sharded_main(mat, card, device, (f_dom, f_geo, f_btab, f_rtab, f_params, f_np, tabs),
                               f_T[300]))
    torch.cuda.empty_cache()
    # ---- the launch splits, after every main path and timing ------------------
    split_launches(list(recs.values()) + off_path + full_off)
    for k in ("survivors", "lattice", "C_v1", "C_fixed_rate", "C_one_to_one"):
        checks[f"{recs[k]['name']}: one kernel launch a call"] = recs[k].get("per_call") == 1
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"chip_smoke: failed checks: {failed}")

    recs["film"]["launches"] = f_launch["megastep"]
    recs["wire"]["launches"] = w_launch["megastep"]
    recs["pool"]["launches"] = w_launch["compact_pool"]
    recs["survivors"]["launches"] = f_launch["compact"]
    recs["lattice"]["launches"] = w_launch["compact"]
    recs["castoff"]["launches"] = b_launch["megastep"]
    recs["film_linear"]["launches"] = fl_launch
    recs["film_centre256"]["launches"] = g_launch
    recs["kfilm_linear"]["launches"] = k_launch["megastep"]
    recs["kfilm0"]["launches"] = k0_launch["megastep"]
    recs["pool_full"]["launches"] = k0_launch["compact_pool"]
    recs["plate"]["launches"] = p_launch["megastep"]
    for k in ("E_pool", "E_inj", "E_evt", "E_narrow"):
        recs[k]["launches"] = b_launch["raycast_large"]
    recs["D"]["launches"] = s_launch["scatter_rows"]
    recs["C_v1"]["launches"] = s_launch["compact"]
    recs["C_fixed_rate"]["launches"] = ge_launch["compact"]
    recs["C_one_to_one"]["launches"] = o2o_launch["compact"]
    recs["corrugated"]["launches"] = cw_launch["megastep"]
    recs["wire12"]["launches"] = sw_launch[0.0]["megastep"]
    recs["membrane"]["launches"] = mb_launch["megastep"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in recs.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
