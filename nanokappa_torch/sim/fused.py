"""The fused (v2) timestep: kernel A's one pass over the pool plus the
narrow event machinery.

Torch twin of nanokappa_tpu/sim/fused.py `make_step_v2` (:576) on slice
subvolumes (nearest or linear temperatures) and grid/voronoi subvolumes of
up to MAX_CENTERS centres (nearest temperatures), every reservoir scheme
(`pooled`, `constant`, `fixed_rate`, `one_to_one`: sim/reservoir.py), the
velocity or the k scattering model, on three paths:
  * the specular-mirror path of eta = 0 (fully specular) rough walls that
    share one correspondence table: on the "slim" 18-row layout where the
    partner is the exact crystal mirror on one axis (the slim gate,
    sim/boundary_tables.py slim_mirror_axis), e.g. the film under the
    velocity model; on the "full" 24-row layout everywhere else on this
    path, e.g. the film under the k model, whose degenerate-branch split
    is drawn whenever a lane's mirror cache is filled (initialisation,
    injection, the narrow machinery's refill),
  * the mirror-off path, e.g. the nanowire: a box or a mesh of at most
    TRI_KERNEL_MAX triangles (kernel A casts against the triangles) with
    rough eta > 0 walls, whose diffuse reflections kernel A draws itself
    and whose specular winners it exports flagged, for any number of wall
    table rows (the per-mode partner mask is ceil(rows / 32) words); the
    pool is the "plain" 16-row layout with full cached lifetimes,
  * the kernel_cast-off path, e.g. an imported STL or a finely tessellated
    primitive: a mesh of TRI_KERNEL_MAX to LARGE_TRI_MAX triangles. Kernel
    A cannot cast there: injections are pre-cast at buffer width through
    kernel E (ops/raycast_large.py), every boundary event exports — absorbing
    and periodic ones too — and the narrow machinery re-casts through
    kernel E; the "plain" pool.
Which path, layout, kernel branches and event window a configuration runs
is its route (`Route`), decided once by `build_route`; kernel_cast_ok,
mirror_eligible, dkern_active, autosize_evt_cap and v2_fallback_reason are
its steps, kept by the JAX package's names.
Reference semantics (classes/Population.py:1724-1769 run_timestep) with the
JAX package's one reordering: the RTA scattering of step k runs at the
START of step k+1's drift kernel ("deferred RTA"; `make_finalize` applies
the pending one).

Pipeline per step:
  1. reservoir injection rows (sim/reservoir.py) append at the pool tail,
  2. kernel A (ops/megastep.py): deferred RTA, stale ray cast, drift,
     in-kernel absorb/periodic/specular (slim) or diffuse (plain) rounds,
     export of the still-pending rows, subvolume sums of the lanes that
     stay,
  3. the narrow event machinery (sim/cascade.py) on the exported rows: on
     a box with slices kernel F (ops/event_round.py), one launch a round,
     elsewhere the torch rounds,
  4. its rows are binned, given the layout's rows (`layout_rows`, as the
     injections are) and appended at the tail WHOLE (the EVT_CAP window
     advances the tail even where lanes are dead — the runner's compaction
     cadence in sim/step.py is sized for that),
  5. the O(SV) postlude both steps share (sim/step.py postlude) inverts
     T(E).

The tail position is a host integer: injection counts come from the host
accumulators of the `pooled` and `constant` schemes, so no step of theirs
reads the device to know where to append; `fixed_rate` reads its lattice's
count back, `one_to_one` the previous step's (R,) n_leaving
(sim/reservoir.py).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from nanokappa_torch.geometry.device import DeviceGeometry, host
from nanokappa_torch.material.tables import MaterialTables
from nanokappa_torch.sim.binning import interp_T_particles, particle_energies, segment_sum, subvol_id
from nanokappa_torch.sim.boundary_tables import (
    K_MODELS, BoundaryTables, combined_mirror_rows, slim_mirror_axis,
)
from nanokappa_torch.ops import event_round
from nanokappa_torch.ops.megastep import MAX_CENTERS, MAX_SLICES
from nanokappa_torch.ops.raycast import raycast
from nanokappa_torch.sim.cascade import run_event_buffer, v1_event_cap
from nanokappa_torch.sim.reservoir import RES_GENS, ReservoirTables, sample_injections
from nanokappa_torch.sim.scatter import (
    lifetime_by_sv, lifetime_lookup, rta_scatter, slope_pair,
)
from nanokappa_torch.sim.state import (
    C_ALIVE, C_CF, C_DEV, C_MODE, C_OMEGA, C_ONF, C_POS, C_SV, C_TAU, C_TCOLL,
    C_VEL, R_MMODE, R_TAUB, R_XMTAUB, R_XTAU, R_XTAUB, STALE, TAUB_ROW,
    SimParams, SimState, as_f32, as_i32,
)


TRI_KERNEL_MAX = 128  # triangles kernel A casts against in-kernel
LARGE_TRI_MAX = 65536  # meshes beyond TRI_KERNEL_MAX up to this run kernel
#   A with kernel_cast off and kernel E (its 512-chunk bound)


def kernel_cast_ok(geo) -> bool:
    """Can kernel A cast rays itself? Box slab math, or a mesh of at most
    TRI_KERNEL_MAX triangles (nanokappa_tpu/sim/fused.py:89)."""
    return geo.is_box or int(geo.tri_origin.shape[0]) <= TRI_KERNEL_MAX


def mirror_eligible(geo: DeviceGeometry, btab, params: SimParams, mat=None) -> bool:
    """In-kernel specular fast path: at least one rough facet, every rough
    row sharing ONE correspondence table, specularity exactly 1 wherever a
    correspondence exists (eta = 0), and >= 95% of the modes that can hit a
    rough wall carrying a partner (nanokappa_tpu/sim/fused.py:380)."""
    from nanokappa_torch.geometry.domain import BC
    from nanokappa_torch.sim.boundary_tables import _host_table

    if btab is None or mat is None or int(btab.n_rough) == 0:
        return False
    if not kernel_cast_ok(geo):
        return False
    spec = _host_table(btab, "specularity")
    corr = _host_table(btab, "corr")
    if not np.all((spec == 1.0) | (corr < 0)):  # eta = 0 everywhere
        return False
    rows = combined_mirror_rows(btab, mat)
    if rows is None:
        return False
    cur = np.asarray(rows)[:, 1].view(np.int32)
    if hasattr(mat, "omega_vel"):  # device MaterialTables
        v = host(mat.omega_vel)[:, 1:4]
    else:  # host Material
        from nanokappa_torch.sim.boundary_tables import _mode_tables

        v, _, _ = _mode_tables(mat)
    bc = host(geo.facet_bc)
    normals = host(geo.facet_normal)[bc == int(BC.ROUGH)]
    need = np.zeros(cur.shape[0], bool)
    for n in normals:
        need |= (v @ n) > 1e-12
    if not need.any() or (cur[need] >= 0).mean() < 0.95:
        return False
    return True


def dkern_active(geo, btab, params: SimParams, mat) -> bool:
    """The in-kernel diffuse gate (nanokappa_tpu/sim/fused.py:96): kernel A
    casts rays itself, the walls are off the mirror path and some are
    rough. Kernel A then draws each rough-wall Bernoulli and diffuse mode
    itself, from the boundary tables; the JAX package's presample pool and
    its limits (<= 8 table rows, <= 2 lifetime bins) are TPU workarounds
    that the port does not carry."""
    return _dkern(geo, btab, mat, mirror_eligible(geo, btab, params, mat))


def _dkern(geo, btab, mat, mirror: bool) -> bool:
    return (
        btab is not None and mat is not None and int(btab.n_rough) > 0
        and kernel_cast_ok(geo) and not mirror
    )


POOL_TILE_BN = 32768  # the JAX kernels' tile width (nanokappa_tpu/ops/megastep.py BN)


def tile_width(n: int) -> int | None:
    """The JAX package's tile width for an n-wide pool, or None where it has
    none (nanokappa_tpu/ops/megastep.py tile_width :113): its v2 gate, kept
    so that both packages route a configuration alike."""
    if n >= POOL_TILE_BN:
        return POOL_TILE_BN if n % POOL_TILE_BN == 0 else None
    if n >= 1024 and (n & (n - 1)) == 0:
        return n
    return None


def v2_fallback_reason(geo, params: SimParams) -> str | None:
    """Why this configuration runs the general v1 step (sim/step.py
    make_step), or None where the fused v2 step takes it: the JAX package's
    conditions and words (nanokappa_tpu/sim/fused.py v2_eligible :266,
    v2_fallback_reason :311), save that "auto" takes v2 on the CPU too."""
    if params.step_impl == "v1":
        return "step_impl='v1' was requested"
    F = int(geo.tri_origin.shape[0])
    if not geo.is_box and F > LARGE_TRI_MAX:
        return (
            f"mesh has {F} triangles > the large-mesh fused-step bound "
            f"LARGE_TRI_MAX={LARGE_TRI_MAX}"
        )
    if geo.subvol_type == "slice":
        if params.temp_interp not in ("nearest", "linear"):
            return f"temp_interp={params.temp_interp!r} needs the XLA path"
        if geo.n_subvols > MAX_SLICES:
            return f"{geo.n_subvols} slice subvolumes > the kernel cap {MAX_SLICES}"
    elif geo.subvol_type in ("grid", "voronoi"):
        if params.temp_interp != "nearest":
            return (
                f"temp_interp={params.temp_interp!r} on "
                f"{geo.subvol_type} subvolumes needs the XLA path"
            )
        if geo.n_subvols > MAX_CENTERS:
            return f"{geo.n_subvols} {geo.subvol_type} centres > the kernel cap {MAX_CENTERS}"
    else:
        return f"subvolume type {geo.subvol_type!r} needs the XLA path"
    if geo.n_reservoirs > 7:
        return f"{geo.n_reservoirs} reservoirs > the kernel cap 7"
    if params.n_cap % params.n_shards != 0 or tile_width(params.n_cap // params.n_shards) is None:
        return (
            f"pool capacity {params.n_cap}/{params.n_shards} shards does "
            f"not align to a kernel tile (ops/megastep.py tile_width)"
        )
    return None


@dataclass(frozen=True)
class Route:
    """What the step runs for one configuration, decided once (build_route)
    and read by every part that builds or feeds it: the step builders
    (sim/step.py make_step, make_step_v2), the block runner's compaction
    cadence, init_state's pool layout, kernel A's configuration and the
    driver. The kernel fields are the v2 step's; the v1 step runs none of
    them, and has them all False."""

    step: str  # "v2", the fused step (make_step_v2), or "v1", the general
    #   one (sim/step.py make_step)
    v1_reason: str | None  # why the v1 step, in the JAX package's words
    #   (v2_fallback_reason); None on v2
    layout: str  # the pool layout (sim/state.py): "slim", "full" or "plain"
    flip_axis: int | None  # the slim gate's wall axis; None off "slim"
    kernel_cast: bool  # kernel A casts rays itself; off, kernel E pre-casts
    #   the injections and re-casts every boundary event
    dkern: bool  # kernel A's in-kernel diffuse branch
    k_split: bool  # the k model's degenerate split, drawn at every fill of
    #   the full mirror cache (injection, the narrow rounds' refill)
    kernel_f: bool  # kernel F runs the narrow rounds (ops/event_round.py),
    #   on a CUDA buffer; else the torch rounds
    evt_cap: int  # the event window's width: on v2 kernel A's export cap
    #   and each step's tail advance, on v1 its event compaction's width
    #   (sim/cascade.py v1_event_cap); at one shard's pool

    @property
    def mirror(self) -> bool:
        """The in-kernel specular-mirror path (the slim and full layouts)."""
        return self.layout != "plain"


def build_route(geo, btab, params: SimParams, mat) -> Route:
    """The route of one configuration (`mat`: the device MaterialTables or
    the host Material). Raises ValueError for a configuration neither step
    runs; every other one runs, on one shard or several
    (parallel/sharding.py): the v2 step where v2_fallback_reason gives no
    reason (the JAX package's conditions, save that "auto" takes v2 on the
    CPU too), the v1 step elsewhere. On v2 the layout is "slim" on the
    specular-mirror path (mirror_eligible) where the partner is the exact
    crystal mirror (slim_mirror_axis), "full" on that path where it is not
    or where the k model's split is drawn, "plain" off it."""
    if params.temp_interp == "linear" and geo.subvol_type == "slice" and geo.n_subvols < 2:
        raise ValueError("temp_interp='linear' needs at least 2 slices")
    if geo.n_reservoirs > 0 and params.res_gen not in RES_GENS:
        raise ValueError(f"unknown reservoir_gen {params.res_gen!r}")
    reason = v2_fallback_reason(geo, params)
    if reason is not None:
        return Route("v1", reason, "plain", None, False, False, False, False, v1_event_cap(params))
    mirror = mirror_eligible(geo, btab, params, mat)
    # the k model with equal-frequency partner branches draws its split at
    # cache fill, so a lane's cached partner is not always the exact
    # crystal mirror (nanokappa_tpu/sim/fused.py:611-620)
    k_split = mirror and params.scat_model in K_MODELS and bool((host(btab.degen_partner) >= 0).any())
    flip = slim_mirror_axis(geo, btab, mat) if mirror and not k_split else None
    layout = "slim" if flip is not None else ("full" if mirror else "plain")
    dkern = _dkern(geo, btab, mat, mirror)
    return Route(
        step="v2",
        v1_reason=None,
        layout=layout,
        flip_axis=flip,
        kernel_cast=kernel_cast_ok(geo),
        dkern=dkern,
        k_split=k_split,
        kernel_f=event_round.covers(geo, params),
        evt_cap=params.evt_cap or autosize_evt_cap(
            geo, mat, params, mirror, params.n_cap // params.n_shards, btab=btab, dkern=dkern,
        ),
    )


def dkern_facet_tables(geo, btab) -> dict:
    """Per-FACET tables of the rough-wall branch (nanokappa_tpu/sim/fused.py
    _dkern_facet_tables :156): eta, front table row, back table row (a
    two-sided membrane hit against its stored normal uses the back row)."""
    from nanokappa_torch.geometry.domain import BC

    bc = host(geo.facet_bc)
    F = len(bc)
    eta = np.nan_to_num(host(geo.facet_value)).astype(np.float64)
    row_f = np.zeros(F, np.int64)
    row_b = np.zeros(F, np.int64)
    fr = host(geo.facet_rough)
    row_of = host(btab.row_of_rough)
    row_back = host(btab.row_back)
    for f in np.nonzero(bc == int(BC.ROUGH))[0]:
        row_f[f] = row_of[fr[f]]
        row_b[f] = row_back[fr[f]]
    return dict(
        facet_eta=eta,
        facet_row=row_f,
        facet_row_back=row_b,
        two_sided=bool(np.any(row_f != row_b)),
    )


def autosize_evt_cap(geo, mat, params: SimParams, use_mirror: bool, N_shard: int, btab=None,
                     dkern: bool | None = None) -> int:
    """Default event-window width (nanokappa_tpu/sim/fused.py:183), without
    the JAX package's 128 round-up.

    Mirror path: exports are 3+-bounce chains and no-partner lanes only —
    N/2048 with a floor. Off it, the width tracks the kinetic rough-wall
    collision rate A_rough * vbar * dt / (4 V) per particle and step; with
    in-kernel diffuse reflection only the Bernoulli's specular winners
    (plus deep chains) export, so the rate is weighted by the largest
    flux-weighted specular share over the wall rows, + 0.15. With
    kernel_cast off every boundary hit exports, so the rate counts the
    TOTAL boundary area, and the width is 1.25x the estimate: a buffer
    margin (the JAX package takes 1.0x, unmeasured), not physics. `dkern`
    is the in-kernel diffuse gate where the caller has it (None:
    dkern_active); `mat` the device tables or the host Material."""
    from nanokappa_torch.geometry.domain import BC

    if use_mirror:
        return max(2048, N_shard // 2048)
    floor = max(params.inj_cap, N_shard // 64)
    if geo.n_facets == 0 or float(geo.volume) <= 0:
        return floor
    tri_f = host(geo.tri_facet)
    bc = host(geo.facet_bc)
    areas = 0.5 * np.linalg.norm(np.cross(host(geo.tri_e1), host(geo.tri_e2)), axis=1)
    kcast = kernel_cast_ok(geo)
    evt_area = float(areas[bc[tri_f] == int(BC.ROUGH)].sum()) if kcast else float(areas.sum())
    if evt_area == 0.0:
        return floor
    tabs = mat if hasattr(mat, "omega_vel") else mat.device_tables("cpu")
    ov = host(tabs.omega_vel)
    act = host(tabs.active).astype(bool)
    v = np.linalg.norm(ov[:, 1:4], axis=1)
    vbar = float(v[act].mean()) if act.any() else float(v.mean())
    rate = evt_area * vbar * float(params.dt) / (4.0 * float(geo.volume))
    if dkern is None:
        dkern = btab is not None and dkern_active(geo, btab, params, mat)
    if dkern:
        spec = btab._host["specularity"]  # (NU, M), zeroed where corr < 0
        normals = btab._host["u_normals"]  # (NU, 3)
        v3 = ov[:, 1:4].astype(np.float64)
        p_max = 0.0
        for r in range(normals.shape[0]):
            dest = np.maximum(v3 @ normals[r], 0.0)
            tot = dest.sum()
            if tot > 0:
                p_max = max(p_max, float((dest * spec[r]).sum() / tot))
        frac = min(1.0, p_max + 0.15)
        floor = max(params.inj_cap, N_shard // 128)
        est = int(rate * N_shard * frac)
        return int(np.clip(est, floor, max(floor, N_shard // 8)))
    est = int(rate * N_shard * (1.0 if kcast else 1.25))
    return int(np.clip(est, floor, max(floor, N_shard // 8)))


def step_seed(state: SimState) -> int:
    """The per-step seed of kernel A's in-kernel draws: a host integer from
    the run's seed and the step (no device read)."""
    from nanokappa_torch.ops.megastep import lowbias32

    return lowbias32((state.gen.initial_seed() & 0xFFFFFFFF) ^ lowbias32(state.step))


def expand_slim_mirror(pool: torch.Tensor, flip_axis: int) -> torch.Tensor:
    """(18, N) slim pool -> the JAX package's full (N, 8) mirror cache
    (nanokappa_tpu/sim/fused.py _expand_slim_mirror): under the slim gate the
    partner's omega and lifetime bits equal the main mode's and its
    velocity is the main one with the wall-axis component negated."""
    m_mode_b = pool[R_MMODE]
    tau_b = pool[R_TAUB]
    has = as_i32(m_mode_b) >= 0
    v = [torch.where(has, -pool[3 + k] if k == flip_axis else pool[3 + k], 0.0)
         for k in range(3)]
    cols = [
        m_mode_b,
        torch.where(has, pool[C_OMEGA], 0.0),
        *v,
        torch.where(has, pool[C_TAU], 0.0),
        tau_b,
        torch.where(has, tau_b, 0.0),
    ]
    return torch.stack(cols, dim=1)


def degen_split(btab, corr: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The k model's degenerate-branch split drawn at cache fill
    (nanokappa_tpu/sim/fused.py kmodel_degen_split :363): the cached partner
    swaps to its equal-frequency partner branch where `u` >= 1/2, so the
    next in-kernel reflection takes the partner with probability 1/2."""
    dp = btab.degen_partner
    partner = dp[torch.clamp(corr, 0, dp.shape[0] - 1).long()]
    return torch.where((corr >= 0) & (partner >= 0) & (u >= 0.5), partner, corr)


def mirror_assemble(mat, mode, corr, m_omega, m_vel, sv, T_sv):
    """(mrows (8, E), a): the full mirror cache rows 16 + X_* of lanes whose
    partner is `corr` (with its omega and velocity), and the main mode's
    lifetime intercept a for C_TAU (nanokappa_tpu/sim/fused.py
    _mirror_assemble :502). Both slope pairs come from slope_pair itself,
    so full- and slim-path lifetimes agree bit for bit."""
    M = mat.tau.shape[1]
    has = corr >= 0
    a, b = slope_pair(mat, T_sv, sv, mode)
    a_m, b_m = slope_pair(mat, T_sv, sv, torch.clamp(corr, 0, M - 1))
    return torch.stack([
        as_f32(corr),
        torch.where(has, m_omega, 0.0),
        *[torch.where(has, m_vel[:, k], 0.0) for k in range(3)],
        torch.where(has, a_m, 0.0),
        b,
        torch.where(has, b_m, 0.0),
    ]), a


def mirror_rows(btab, mat, mtab, rows, T_sv, sv, u=None):
    """Fresh full mirror cache rows for (possibly mode-changed) particle
    rows, e.g. the narrow machinery's outputs (nanokappa_tpu/sim/fused.py
    _mirror_rows :542): the partner from the combined wall table `mtab`
    ([p, corr, omega, vx, vy, vz, ..] per mode); with uniforms `u` the k
    model's split is drawn and the effective partner's omega and velocity
    gathered again. Returns (mrows (8, E), a) as mirror_assemble."""
    M = mat.tau.shape[1]
    mode = torch.clamp(as_i32(rows[C_MODE]), 0, M - 1)
    sc = mtab[mode.long()]
    corr = as_i32(sc[:, 1])
    if u is None:
        m_om, m_v = sc[:, 2], sc[:, 3:6]
    else:
        corr = degen_split(btab, corr, u)
        ov = mat.omega_vel[torch.clamp(corr, 0, M - 1).long()]
        m_om, m_v = ov[:, 0], ov[:, 1:4]
    return mirror_assemble(mat, mode, corr, m_om, m_v, sv, T_sv)


def layout_rows(route: Route, btab, mat, mtab, rows, sv, T_sv, gen) -> torch.Tensor:
    """Fresh (16, E) particle rows, injected or out of the narrow rounds, as
    the rows of the route's pool layout, the partner read from the
    combined wall table `mtab` ([p, corr, omega, vx, vy, vz, ..] per mode)
    at the lanes' modes: on "slim" the slope form's intercept a in C_TAU,
    then the partner row and the slope b; on "full" the intercept and the
    whole mirror cache (mirror_rows), the k model's split drawn where the
    route draws it (one uniform a lane from `gen`); on "plain" the rows as
    they are. `sv` holds the lanes' subvolumes. C_TAU is written on every
    lane: the caller appends only the valid ones."""
    if route.layout == "slim":
        mode = torch.clamp(as_i32(rows[C_MODE]), 0, mat.tau.shape[1] - 1)
        a, b = slope_pair(mat, T_sv, sv, mode)
        rows[C_TAU] = a
        return torch.cat([rows, mtab[mode.long(), 1][None], b[None]])
    if route.layout == "full":
        u = torch.rand(rows.shape[1], generator=gen, device=rows.device) if route.k_split else None
        mrows, a = mirror_rows(btab, mat, mtab, rows, T_sv, sv, u)
        rows[C_TAU] = a
        return torch.cat([rows, mrows])
    return rows


def _append_window(pool, rows, valid, tail: int) -> bool:
    """Write `rows` (C, w) into pool lanes [tail, tail + w) where `valid`;
    the window's other lanes keep their rows (nanokappa_tpu/sim/fused.py
    _append_window, here plain slicing at a host offset). Returns False, and
    writes nothing, when the pool has no room for the whole window."""
    w = rows.shape[1]
    if tail + w > pool.shape[1]:
        return False
    win = pool[:, tail : tail + w]
    win.copy_(torch.where(valid[None], rows, win))
    return True


def make_step_v2(
    geo: DeviceGeometry,
    mat: MaterialTables,
    btab: BoundaryTables,
    rtab: ReservoirTables,
    params: SimParams,
    comm=None,
    route: Route | None = None,
):
    """Returns step(state) -> (state, StepOutputs), advancing `state` in
    place, on the configuration's route (build_route when not given). With
    `comm` (parallel/sharding.py ShardComm) the state is one shard of the
    pool: the step's subvolume sums, ledger, losses and frozen count are
    summed over the shards in one all-reduce before the normalisation and
    the T(E) inversion (sim/step.py postlude), so every shard ends the step
    with the same T_sv and outputs; `comm=None` is one shard, with no
    collective."""
    from nanokappa_torch.ops.megastep import R8, drift_megastep, mega_config
    from nanokappa_torch.sim.step import postlude

    route = route or build_route(geo, btab, params, mat)
    layout = route.layout
    device = geo.device
    R = geo.n_reservoirs
    SV = geo.n_subvols
    EVT_CAP = route.evt_cap
    cfg = mega_config(geo, mat, btab, params, EVT_CAP, route.flip_axis, kernel_cast=route.kernel_cast,
                      layout=layout, dkern=route.dkern)
    SV8 = cfg.sv8
    # rounds 2+ of the narrow machinery: the mirror path's buffer is already
    # the deep-chain tail (E/4); off it first bounces dominate, and with
    # in-kernel diffuse the buffer is mostly specular lanes that can chain
    # (nanokappa_tpu/sim/fused.py:971-973)
    evt2_cap = None if route.mirror else (EVT_CAP // 8 if route.dkern else EVT_CAP // 16)
    # the narrow rounds as kernel F (one launch a round) where it covers the
    # geometry: the box's slab cast on slices; the torch round elsewhere
    narrow = event_round.round_tables(geo, mat, btab, params) if route.kernel_f else None
    # the combined wall table [p, corr, omega, vx, vy, vz, ..] of every mode
    mtab = torch.as_tensor(np.ascontiguousarray(combined_mirror_rows(btab, mat)),
                           device=device) if route.mirror else None
    lane_e = torch.arange(EVT_CAP, device=device)
    lane_i = torch.arange(params.inj_cap, device=device)

    def step(state: SimState):
        if state.layout != layout:
            raise ValueError(f"the step runs the {layout!r} pool, the state is {state.layout!r}")
        pool = state.pool
        tail = state.tail

        # 1. injection rows appended at the pool tail; with no room for the
        # whole window the batch is dropped and counted
        lost_inj = 0
        if R > 0:
            rows, n_valid, new_counter, dropped = sample_injections(
                state.res_counter, geo, rtab, params, state.gen, state.n_leaving,
                shard=0 if comm is None else comm.rank,
            )
            if route.mirror:
                rows = layout_rows(route, btab, mat, mtab, rows, subvol_id(geo, rows[C_POS].T),
                                   state.T_sv, state.gen)
            if not route.kernel_cast:
                # pre-cast at buffer width (kernel A cannot cast here):
                # freshness rides the sign of C_TCOLL, t_enc = -t/dt - 1 < 0,
                # with the real facet in C_CF, so the lane still skips the
                # deferred RTA it predates
                t_b, f_b = raycast(geo, rows[C_POS].T, rows[C_VEL].T, as_i32(rows[C_ONF]))
                rows[C_TCOLL] = -(t_b / params.dt) - 1.0
                rows[C_CF] = as_f32(f_b)
            if _append_window(pool, rows, lane_i < n_valid, tail):
                tail += n_valid
                lost_inj = dropped
            else:
                lost_inj = dropped + n_valid
            state.res_counter = new_counter

        # 2. kernel A: one pass over the pool
        rows_x, _, counts, kledger, kbins = drift_megastep(
            pool, state.T_sv, state.step > 0, cfg, seed=step_seed(state)
        )
        frozen_k = counts[0] - counts[2]

        # 3. the narrow machinery on the exported rows
        vbuf = lane_e < counts[2]
        rows_out, mledger, lost_stuck, lost_def, frozen2, swaps = run_event_buffer(
            rows_x[:16], vbuf, geo, mat, btab, params, state.gen, state.T_sv,
            R8, evt2_cap=evt2_cap, kernel=narrow,
        )

        # 4. bin the event rows (their end-of-step state); with the kernel's
        # sums this partitions the population exactly
        alive_e = (rows_out[C_ALIVE] > 0.5) & vbuf
        sv_e = subvol_id(geo, rows_out[C_POS].T)
        e_e = particle_energies(
            rows_out[C_OMEGA], rows_out[C_DEV], alive_e,
            state.T_sv[sv_e.long()], params.t_reference,
        )
        vel_e = torch.where(alive_e[None], rows_out[C_VEL], 0.0)
        vals_e = torch.stack(
            [e_e, e_e * vel_e[0], e_e * vel_e[1], e_e * vel_e[2], alive_e.float()], 1
        )
        ebins = segment_sum(vals_e, torch.where(alive_e, sv_e, SV8), SV8)

        # 5. the event rows append at the tail, uncompacted (the window
        # advances the tail by EVT_CAP; dead lanes keep the window's rows),
        # with fresh caches for the (possibly mode-changed) rows
        rows_out[C_SV] = as_f32(sv_e)
        rows_out = layout_rows(route, btab, mat, mtab, rows_out, sv_e, state.T_sv, state.gen)
        if _append_window(pool, rows_out, alive_e, tail):
            tail += EVT_CAP
            lost3 = torch.zeros((), dtype=torch.int32, device=device)
        else:
            lost3 = alive_e.sum(dtype=torch.int32)

        # 6. the postlude both steps share
        state.tail = tail
        state.kernel_events = state.kernel_events + torch.cat(
            [counts[3:5], swaps[None], counts[2:3]]
        )
        sums = (kbins + ebins)[:SV]
        return postlude(
            state, geo, mat, params, comm, sums, kledger + mledger,
            torch.stack([lost3 + lost_inj, lost_stuck, lost_def]).to(torch.int32),
            (frozen_k + frozen2).to(torch.int32),
        )

    return step


def refresh_tau_T(state: SimState, geo, mat, params) -> SimState:
    """Refresh the cached lifetimes of the alive lanes at the subvolumes'
    CURRENT temperatures (nanokappa_tpu/sim/fused.py refresh_tau_T :1254):
    on the slim layout the slope-form pairs (a, b) of the T-grid bins (the
    partner's pair equals the main mode's under the slim gate, so one
    refresh serves both); on the full layout the pairs of the main mode
    and of the cached partner; on the plain layout the full lifetime at
    each particle's interpolated temperature
    (nanokappa_tpu/sim/step.py refresh_tau :513)."""
    pool = state.pool
    alive = state.alive
    sv = subvol_id(geo, pool[C_POS].T)
    M = mat.tau.shape[1]
    mode = torch.clamp(state.mode, 0, M - 1)
    if state.layout == "slim":
        a, b = slope_pair(mat, state.T_sv, sv, mode)
        pool[C_TAU] = torch.where(alive, a, pool[C_TAU])
        pool[R_TAUB] = torch.where(alive, b, pool[R_TAUB])
    elif state.layout == "full":
        m_mode = as_i32(pool[R_MMODE])
        has = alive & (m_mode >= 0)
        a, b = slope_pair(mat, state.T_sv, sv, mode)
        a_m, b_m = slope_pair(mat, state.T_sv, sv, torch.clamp(m_mode, 0, M - 1))
        pool[C_TAU] = torch.where(alive, a, pool[C_TAU])
        pool[R_XTAU] = torch.where(has, a_m, pool[R_XTAU])
        pool[R_XTAUB] = torch.where(alive, b, pool[R_XTAUB])
        pool[R_XMTAUB] = torch.where(has, b_m, pool[R_XMTAUB])
    else:
        if params.temp_interp == "nearest":
            tau = lifetime_by_sv(mat, state.T_sv, sv, mode)
        else:
            T_p = interp_T_particles(geo, state.T_sv, pool[C_POS].T, sv, params.temp_interp)
            tau = lifetime_lookup(mat, T_p, mode)
        pool[C_TAU] = torch.where(alive, tau, pool[C_TAU])
    return state


def make_finalize(geo, mat, params):
    """Apply the PENDING deferred RTA so written particle data matches the
    reference's end-of-step state; returns a finalised copy (the running
    state stays un-finalised — the next drift kernel applies it there).
    On the slim and full layouts the lifetime is the slope form
    tau = a + b*T (C_TAU holds a, TAUB_ROW[layout] holds b); on the plain
    layout C_TAU is the lifetime."""
    tau_T = host(mat.tau_T)
    t_lo, t_hi = float(tau_T[0]), float(tau_T[-1])

    def finalize(state: SimState) -> SimState:
        T_p = interp_T_particles(
            geo, state.T_sv, state.pos, state.sv_col, params.temp_interp
        )
        ok = state.alive & (state.coll_facet != STALE) & (state.step > 0)
        tau = state.tau
        if state.layout in TAUB_ROW:
            tau = tau + state.pool[TAUB_ROW[state.layout]] * torch.clamp(T_p, t_lo, t_hi)
        dev = rta_scatter(
            mat, state.dev, state.mode, state.omega, T_p, ok,
            params.dt, params.t_reference, tau=tau,
        )
        pool = state.pool.clone()
        pool[C_DEV] = dev
        return replace(state, pool=pool)

    return finalize
