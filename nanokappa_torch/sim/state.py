"""Simulation state: the particle pool as one (C, N) float32 SoA tensor.

The JAX package carries a packed (N, 16) row matrix plus an (N, 8)
specular-mirror side pool (nanokappa_tpu/sim/state.py). The port keeps the
same column indices as pool ROWS, in one of three layouts named by the
state's `layout` tag:
  * "slim" (18 rows), the in-kernel specular-mirror path of eta = 0 walls
    (sim/fused.py mirror_eligible, slim gate): rows 16-17 are the only two
    mirror columns the step reads, row 16 = partner mode id (X_MODE) and
    row 17 = the lifetime slope b (X_TAUB); C_TAU holds the intercept a of
    tau(T) = a + b*T on the particle's temperature-grid bin;
  * "full" (24 rows), the same mirror path where the partner is not the
    exact crystal mirror (no slim axis, or the k model's degenerate split
    drawn at cache fill): rows 16-23 are the whole mirror cache, 16 + X_*
    (partner mode, omega, velocity, lifetime intercept a_m, the main
    mode's slope b, the partner's slope b_m); C_TAU holds the intercept a;
  * "plain" (16 rows), every other path, e.g. rough eta > 0 walls with
    in-kernel diffuse reflection: the particle rows only, and C_TAU holds
    the full cached lifetime tau(T_local, mode), refreshed when a subvolume
    temperature drifts by more than params.tau_dT (the JAX package's
    mirror-off path, nanokappa_tpu/ops/megastep.py:537-544).
Integer columns are int32 bitcast into the float32 rows (`as_i32` /
`as_f32`); small ids read as denormals and STALE = -2 as a NaN payload, so
they only ever move bit-for-bit.

Host-side construction (`init_state`) is the JAX package's NumPy code, so the
same seed gives the same initial particles in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from nanokappa_torch.geometry.device import DeviceGeometry, host
from nanokappa_torch.geometry.domain import BC, Domain
from nanokappa_torch.material.tables import Material, bose_einstein

# coll_facet sentinels
STALE = -2  # needs a ray cast (fresh injection / initialisation / resample)
NOHIT = -1  # ray cast found nothing (defective; particle is quarantined)


@dataclass(frozen=True)
class SimParams:
    """The run's static parameters (the JAX package's SimParams, less the
    TPU-only and ablation fields)."""

    dt: float  # ps
    n_cap: int  # particle pool capacity
    inj_cap: int  # injection buffer size
    k_max: int = 8  # event rounds
    c_max: int = 3  # max particles per (reservoir, mode) per step
    energy_normal: str = "mean"
    temp_interp: str = "linear"
    res_gen: str = "constant"
    scat_model: str = "velocity"
    particle_density: float = 0.0
    n_active_modes: int = 0
    t_reference: float = 300.0
    evt_cap: int = 0  # event-buffer width (0 = autosize)
    n_shards: int = 1
    tau_dT: float = 0.25  # K of subvolume-temperature drift that triggers
    #   the cached-lifetime refresh on the plain layout
    step_impl: str = "auto"  # "auto" takes the fused v2 step wherever the
    #   configuration is eligible (sim/fused.py v2_eligible), the general v1
    #   step elsewhere; "v1" / "v2" force one (nanokappa_tpu/sim/state.py:57)


# pool rows (the JAX package's packed columns, sim/state.py:72-107)
C_POS = slice(0, 3)  # position, angstrom
C_VEL = slice(3, 6)  # cached group velocity of `mode`, A/ps
C_OMEGA = 6  # cached angular frequency, rad THz
C_TAU = 7  # lifetime intercept a of tau(T) = a + b*T (slope form)
C_DEV = 8  # occupation deviation n - n0(T_ref)
C_MODE = 9  # flattened mode index (i32 bitcast)
C_CF = 10  # next-hit facet / STALE / NOHIT (i32 bitcast)
C_TCOLL = 11  # time to next boundary hit, in dt units
C_ONF = 12  # facet the particle sits on, excluded from its next ray cast
C_REM = 13  # remaining fraction of the current dt
C_ALIVE = 14  # 1.0 = alive, 0.0 = dead slot
C_SV = 15  # subvolume id (i32 bitcast), refreshed by the drift kernel
N_COLS = 16

# columns of the JAX package's (N, 8) mirror side pool
X_MODE = 0  # correspondence mode (i32 bitcast); -1 = none -> export
X_OMEGA = 1
X_VEL = slice(2, 5)
X_TAU = 5
X_TAUB = 6
X_MTAUB = 7
M_COLS = 8

# the slim-mirror rows of the port's pool ("slim" layout only)
R_MMODE = 16  # = X_MODE
R_TAUB = 17  # = X_TAUB
# the full mirror cache's rows ("full" layout): 16 + X_*
R_XOMEGA = 16 + X_OMEGA
R_XVEL = slice(16 + X_VEL.start, 16 + X_VEL.stop)
R_XTAU = 16 + X_TAU
R_XTAUB = 16 + X_TAUB
R_XMTAUB = 16 + X_MTAUB
LAYOUT_ROWS = {"slim": 18, "plain": 16, "full": 24}
# the row of the main mode's lifetime slope b on the slope-form layouts
TAUB_ROW = {"slim": R_TAUB, "full": R_XTAUB}

# the JAX package rounds pool capacities to its Pallas tile width
# (nanokappa_tpu/ops/megastep.py BN); the port keeps the same capacities so
# that parity runs line up
POOL_TILE = 32768


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """The int32 bits of a float32 row (no arithmetic touches them)."""
    return x.contiguous().view(torch.int32)


def as_f32(x: torch.Tensor) -> torch.Tensor:
    """Integer ids as the float32 bit patterns a pool row stores."""
    return x.to(torch.int32).contiguous().view(torch.float32)


@dataclass
class SimState:
    pool: torch.Tensor  # (LAYOUT_ROWS[layout], N) f32; see the row map above
    layout: str  # "slim" | "full" | "plain", see the module docstring
    T_sv: torch.Tensor  # (SV,) f32 subvolume temperatures
    Np_sv: torch.Tensor  # (SV,) i32
    T_tau: torch.Tensor  # (SV,) f32 temperatures at the last lifetime refresh
    tail: int  # append position: lanes >= tail are dead (after a compaction)
    res_counter: np.ndarray  # (S,R,M) f32 host accumulator ('pooled' uses
    #   [0, :, 0])
    n_leaving: torch.Tensor  # (R,) i32
    res_energy_balance: torch.Tensor  # (R,) f32 ledger
    res_heat_flux: torch.Tensor  # (R,3) f32 ledger
    lost: torch.Tensor  # (3,) i32 [capacity drops, k_max-stuck, defective]
    frozen: torch.Tensor  # () i32 postponed-but-alive events (cumulative)
    kernel_events: torch.Tensor  # (4,) i64 kernel A's in-kernel diffuse
    #   re-emissions and flagged specular exports, the narrow machinery's
    #   k-model degenerate-branch swaps, and kernel A's exported rows
    #   (cumulative)
    gen: torch.Generator = field(repr=False)  # the run's random stream
    step: int = 0

    @property
    def pos(self) -> torch.Tensor:
        return self.pool[C_POS].T

    @property
    def omega(self) -> torch.Tensor:
        return self.pool[C_OMEGA]

    @property
    def tau(self) -> torch.Tensor:
        return self.pool[C_TAU]

    @property
    def dev(self) -> torch.Tensor:
        return self.pool[C_DEV]

    @property
    def mode(self) -> torch.Tensor:
        return as_i32(self.pool[C_MODE])

    @property
    def coll_facet(self) -> torch.Tensor:
        return as_i32(self.pool[C_CF])

    @property
    def alive(self) -> torch.Tensor:
        return self.pool[C_ALIVE] > 0.5

    @property
    def sv_col(self) -> torch.Tensor:
        return as_i32(self.pool[C_SV])


def make_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def round_pool_cap(n_cap: int, n_shards: int = 1) -> int:
    """Round a requested pool capacity UP to the JAX package's widths: a
    power of two in [1024, POOL_TILE) or a multiple of POOL_TILE."""
    w = -(-n_cap // n_shards)
    if w >= POOL_TILE:
        w = -(-w // POOL_TILE) * POOL_TILE
    else:
        w = max(1024, 1 << (w - 1).bit_length())
    return w * n_shards


def particle_count(spec: tuple, mat: Material, domain: Domain) -> tuple[int, float]:
    """Resolve the --particles (kind, value) spec into (N_p, particle_density).

    Reference classes/Population.py:50-63."""
    kind, value = spec[0], float(spec[1])
    n_sv = domain.n_of_subvols
    if kind == "pmps":
        n_p = int(np.ceil(value * mat.n_active_modes * n_sv))
    elif kind == "total":
        n_p = int(np.ceil(value))
    elif kind == "pv":
        n_p = int(np.ceil(value * domain.volume))
    else:
        raise ValueError(f"unknown particle spec '{kind}'")
    return n_p, n_p / domain.volume


def nearest_center_ids(positions: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest-subvolume-centre ids, over 1M-row chunks."""
    n = positions.shape[0]
    out = np.empty(n, dtype=np.int64)
    for s in range(0, n, 1 << 20):
        blk = positions[s : s + (1 << 20)]
        d2 = ((blk[:, None, :] - centers[None]) ** 2).sum(axis=-1)
        out[s : s + (1 << 20)] = np.argmin(d2, axis=1)
    return out


def initial_modes(n_p: int, mat: Material) -> np.ndarray:
    """Tile the active modes cyclically (reference classes/Population.py:127-144)."""
    active = np.nonzero(~mat.inactive_mask.reshape(-1))[0]
    reps = int(np.ceil(n_p / len(active)))
    return np.tile(active, reps)[:n_p].astype(np.int32)


def initial_subvol_temperatures(
    temp_dist: str,
    domain: Domain,
    subvol_temp=(),
) -> np.ndarray:
    """Initial per-subvolume temperatures (reference classes/Population.py:565-655)."""
    n_sv = domain.n_of_subvols
    bound_T = domain.res_values[
        domain.bound_cond[domain.res_facets] == BC.TEMPERATURE
    ]
    if temp_dist == "custom":
        return np.asarray(subvol_temp, dtype=float)
    if len(bound_T) == 0:
        bound_T = np.array([300.0])
    if temp_dist == "cold":
        return np.full(n_sv, bound_T.min())
    if temp_dist == "hot":
        return np.full(n_sv, bound_T.max())
    if temp_dist == "mean":
        return np.full(n_sv, bound_T.mean())
    if temp_dist == "random":
        return np.random.rand(n_sv) * np.ptp(bound_T) + bound_T.min()
    if temp_dist == "linear":
        res_T_facets = domain.res_facets[
            domain.bound_cond[domain.res_facets] == BC.TEMPERATURE
        ]
        bp = domain.mesh.facet_centroids[res_T_facets]
        if len(bound_T) == 1:
            return np.full(n_sv, bound_T[0])
        if len(bound_T) == 2:
            direction = bp[1] - bp[0]
            alphas = ((domain.subvol_center - bp[0]) * direction).sum(axis=1)
            alphas /= (direction**2).sum()
            return bound_T[0] + alphas * (bound_T[1] - bound_T[0])
        d = np.linalg.norm(
            domain.subvol_center[None, :, :] - bp[:, None, :], axis=2
        ).T  # (SV,R)
        w = 1.0 / np.maximum(d, 1e-12)
        w /= w.sum(axis=1, keepdims=True)
        return (bound_T * w).sum(axis=1)
    raise ValueError(f"unknown temp_dist '{temp_dist}'")


def init_state(
    mat: Material,
    domain: Domain,
    geo: DeviceGeometry,
    params: SimParams,
    n_p: int,
    btab,
    temp_dist: str = "cold",
    part_dist: str = "random_subvol",
    subvol_temp=(),
    seed: int = 0,
    positions: np.ndarray | None = None,
    modes: np.ndarray | None = None,
    occupation: np.ndarray | None = None,
    empty_subvols=(),
    host_only: bool = False,
) -> SimState:
    """The initial pool, built on the host exactly as the JAX package's
    init_state builds it (same NumPy draws in the same order), in the layout
    the step runs (sim/fused.py pool_layout): on "slim" with the mirror
    partner and slope-form lifetimes, on "full" with the whole mirror cache
    (the k model's degenerate split drawn), on "plain" with full lifetimes.
    Then moved to the geometry's device and given its first ray cast. A
    resumed run passes the particles of a particle_data.txt as positions,
    modes and occupation: its cache is filled, and its split drawn, anew.
    `host_only` keeps the state in host memory without its first ray cast:
    the global state each rank of a sharded run builds from the run's seed
    before parallel/sharding.py shard_state keeps the rank's segment (with
    params.n_shards = S: the reservoir accumulators are (S, R, M), and the
    live particles spread evenly, so each segment gets an equal share of
    them and of dead-lane headroom)."""
    from nanokappa_torch.sim.boundary_tables import K_MODELS, combined_mirror_rows
    from nanokappa_torch.sim.fused import pool_layout, require_slice

    require_slice(geo, btab, params, mat)
    layout = pool_layout(geo, btab, params, mat)
    rng = np.random.default_rng(seed)
    n_cap = params.n_cap
    R = geo.n_reservoirs
    M = mat.n_modes
    SV = domain.n_of_subvols

    if positions is None:
        if part_dist in ("random_domain", "random_subvol"):
            positions = domain.mesh.sample_volume(n_p, rng)
            if len(empty_subvols):
                # resample until no particle starts in an excluded subvolume
                # (reference --empty_subvols, classes/Population.py:209-246)
                empty = np.asarray(list(empty_subvols), dtype=int)
                for _ in range(100):
                    ids = nearest_center_ids(positions, domain.subvol_center)
                    bad = np.isin(ids, empty)
                    if not bad.any():
                        break
                    positions[bad] = domain.mesh.sample_volume(int(bad.sum()), rng)
        elif part_dist == "center_domain":
            positions = np.tile(domain.mesh.center_mass, (n_p, 1))
        elif part_dist == "center_subvol":
            # particles at each subvolume centre, proportional to its volume
            # (reference classes/Population.py:248-268)
            keep = np.ones(domain.n_of_subvols, dtype=bool)
            keep[list(empty_subvols)] = False
            vols = np.where(keep, domain.subvol_volume, 0.0)
            counts = np.ceil(n_p * vols / vols.sum()).astype(int)
            positions = np.repeat(domain.subvol_center, counts, axis=0)[:n_p]
        else:
            raise ValueError(f"unknown part_dist '{part_dist}'")
    if modes is None:
        modes = initial_modes(n_p, mat)

    T_sv = initial_subvol_temperatures(temp_dist, domain, subvol_temp)

    # particle temperatures = their subvolume's (nearest interp at init)
    sv = nearest_center_ids(positions, domain.subvol_center)
    T_p = T_sv[sv]

    omega_p = mat.omega.reshape(-1)[modes]
    if occupation is None:
        dev = bose_einstein(T_p, omega_p) - bose_einstein(params.t_reference, omega_p)
    else:
        dev = occupation - bose_einstein(params.t_reference, omega_p)

    slots = (np.arange(n_p, dtype=np.int64) * n_cap) // n_p
    alive = np.zeros(n_cap, dtype=bool)
    alive[slots] = True

    def full(x, fill):
        out = np.full((n_cap,) + x.shape[1:], fill, dtype=x.dtype)
        out[slots] = x
        return out

    vel_p = mat.group_vel.reshape(-1, 3)[modes]
    ti = np.clip(np.searchsorted(mat.tau_T, T_p) - 1, 0, len(mat.tau_T) - 2)
    tau_flat = mat.tau.reshape(len(mat.tau_T), -1)

    if layout != "plain" or (params.scat_model in K_MODELS and int(btab.n_rough) > 0):
        # the specular partner of each particle's mode; under the k model
        # the degenerate-branch split is drawn here, at cache fill, whatever
        # the layout (nanokappa_tpu/sim/state.py:449-461: the same NumPy
        # draw in the same place, so the later draws line up too)
        sc = combined_mirror_rows(btab, mat)
        cm = (
            np.full(n_p, -1, np.int32) if sc is None
            else sc[:, 1].view(np.int32)[modes]
        )
        if params.scat_model in K_MODELS:
            part = host(btab.degen_partner)[np.clip(cm, 0, M - 1)]
            u_sp = rng.random(cm.shape[0])
            cm = np.where((cm >= 0) & (part >= 0) & (u_sp >= 0.5), part, cm)
    pool = np.zeros((LAYOUT_ROWS[layout], n_cap), dtype=np.float32)
    if layout in ("slim", "full"):
        # the mirror cache with slope-form lifetimes tau(T) = a + b*T on
        # the particle's T-grid bin: C_TAU holds the intercept a (on "slim"
        # the partner's lifetime bits equal the main mode's)
        dTb = np.maximum(mat.tau_T[ti + 1] - mat.tau_T[ti], 1e-30)
        ok = mat.tau_T[ti + 1] > mat.tau_T[ti]
        b_main = np.where(
            ok, (tau_flat[ti + 1, modes] - tau_flat[ti, modes]) / dTb, 0.0
        )
        tau_p = tau_flat[ti, modes] - b_main * mat.tau_T[ti]
        m_mode = np.full(n_cap, -1, np.int32)
        m_mode[slots] = cm
        pool[R_MMODE] = m_mode.view(np.float32)
        pool[TAUB_ROW[layout]] = full(b_main.astype(np.float32), 0.0)
    if layout == "full":
        has = cm >= 0
        cmc = np.clip(cm, 0, M - 1)
        m_omega = mat.omega.reshape(-1)[cmc].astype(np.float32)
        m_vel = mat.group_vel.reshape(-1, 3)[cmc].astype(np.float32)
        b_mir = np.where(
            ok, (tau_flat[ti + 1, cmc] - tau_flat[ti, cmc]) / dTb, 0.0
        )
        a_mir = tau_flat[ti, cmc] - b_mir * mat.tau_T[ti]
        pool[R_XOMEGA] = full(np.where(has, m_omega, 0.0).astype(np.float32), 0.0)
        pool[R_XVEL] = full(np.where(has[:, None], m_vel, 0.0).astype(np.float32), 0.0).T
        pool[R_XTAU] = full(np.where(has, a_mir, 0.0).astype(np.float32), 0.0)
        pool[R_XMTAUB] = full(np.where(has, b_mir, 0.0).astype(np.float32), 0.0)
    if layout == "plain":
        # the full lifetime at the particle's temperature
        wt = np.clip(
            (T_p - mat.tau_T[ti]) / (mat.tau_T[ti + 1] - mat.tau_T[ti]), 0.0, 1.0
        )
        tau_p = (1 - wt) * tau_flat[ti, modes] + wt * tau_flat[ti + 1, modes]

    pool[C_POS] = full(positions.astype(np.float32), 0.0).T
    pool[C_VEL] = full(vel_p.astype(np.float32), 0.0).T
    pool[C_OMEGA] = full(omega_p.astype(np.float32), 0.0)
    pool[C_TAU] = full(tau_p.astype(np.float32), 0.0)
    pool[C_DEV] = full(dev.astype(np.float32), 0.0)
    pool[C_MODE] = full(modes.astype(np.int32), 0).view(np.float32)
    pool[C_CF] = np.full(n_cap, STALE, np.int32).view(np.float32)
    pool[C_TCOLL] = np.inf
    pool[C_ONF] = np.full(n_cap, -1, np.int32).view(np.float32)
    pool[C_REM] = 0.0
    pool[C_ALIVE] = alive.astype(np.float32)
    pool[C_SV] = full(sv.astype(np.int32), 0).view(np.float32)

    device = torch.device("cpu") if host_only else geo.device
    state = SimState(
        pool=torch.as_tensor(pool, device=device),
        layout=layout,
        T_sv=torch.as_tensor(T_sv.astype(np.float32), device=device),
        Np_sv=torch.as_tensor(
            np.bincount(sv, minlength=SV).astype(np.int32), device=device
        ),
        T_tau=torch.as_tensor(T_sv.astype(np.float32), device=device),
        tail=n_cap,
        # random phase, like reference classes/Population.py:343
        res_counter=rng.random((params.n_shards, R, M)).astype(np.float32),
        n_leaving=torch.zeros(R, dtype=torch.int32, device=device),
        res_energy_balance=torch.zeros(R, dtype=torch.float32, device=device),
        res_heat_flux=torch.zeros((R, 3), dtype=torch.float32, device=device),
        lost=torch.zeros(3, dtype=torch.int32, device=device),
        frozen=torch.zeros((), dtype=torch.int32, device=device),
        kernel_events=torch.zeros(4, dtype=torch.int64, device=device),
        gen=make_generator(seed, device),
        step=0,
    )
    return state if host_only else prime_collision_cache(state, geo, params.dt)


def prime_collision_cache(state: SimState, geo: DeviceGeometry, dt: float) -> SimState:
    """Full-width initial ray cast ('Getting first boundary collisions...',
    reference classes/Population.py:308-316)."""
    from nanokappa_torch.ops.raycast import raycast

    pool = state.pool
    t, f = raycast(
        geo, pool[C_POS].T, pool[C_VEL].T,
        torch.full((pool.shape[1],), -1, dtype=torch.int32, device=pool.device),
    )
    pool[C_TCOLL] = t / dt
    pool[C_CF] = as_f32(torch.where(state.alive, f, STALE))
    return state
