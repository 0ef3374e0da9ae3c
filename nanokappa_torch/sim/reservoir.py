"""Isothermal reservoir subsystem: entry probabilities and device injection.

Host side precomputes per-(reservoir, mode) entry probabilities
(reference `enter_probability`, classes/Population.py:146-161):

    enter_prob[r, m] = max(v_m . (-n_r), 0) * dt / bound_thickness_r,
    bound_thickness_r = N_active_modes / (particle_density * A_r).

The JAX package's four generation schemes (nanokappa_tpu/sim/reservoir.py
sample_injections):
  * 'pooled': a scalar fractional accumulator per reservoir fixes each
    step's count, modes come from the Walker alias table of enter_prob,
    arrival times are uniform;
  * 'constant' (classes/Population.py:358-367): floor(enter_prob) copies of
    every (reservoir, mode) plus one more whenever its fractional
    accumulator crosses 1. The copies are the occupied lanes of a
    (c_max, R*M) lattice, packed to the front by kernel C (ops/compact.py)
    in lattice order; each copy's arrival time is its fraction of the step
    (the accumulator for copy 0, a uniform draw for the others);
  * 'fixed_rate': the same lattice, with floor(enter_prob) copies plus one
    more where a fresh per-(reservoir, mode) uniform `dice` falls at or
    below the fractional part (no accumulator); copy 0 arrives at
    dice / enter_prob;
  * 'one_to_one' (classes/Population.py:457-489): exactly as many
    particles as left each reservoir in the previous step (n_leaving; on
    several shards each regenerates its part of the global count),
    up to inj_cap // R a reservoir, modes by the Walker alias of
    enter_prob, arrival times uniform; the valid lanes of the
    (R, inj_cap // R) block are packed to the front by kernel C.
Injected particles sit uniformly on their reservoir facet: a box wall is a
rectangle, any other facet a triangle picked by area and a folded
barycentric draw. The accumulators of 'pooled' and 'constant' are float32
NumPy on the host — the same float32 arithmetic as the JAX package's device
arrays — so their per-step counts, and with them the pool's tail
arithmetic, are known without a device sync. 'fixed_rate' draws its dice on
the device and reads back the lattice's count (one two-int copy a step);
'one_to_one' reads back the previous step's n_leaving ((R,) ints a step).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from nanokappa_torch.geometry.device import DeviceGeometry, host, resolve_device
from nanokappa_torch.geometry.domain import Domain
from nanokappa_torch.material.tables import Material
from nanokappa_torch.sim.bose import occupation_delta_T
from nanokappa_torch.sim.state import (
    STALE, N_COLS, C_ALIVE, C_CF, C_DEV, C_MODE, C_OMEGA, C_ONF, C_POS,
    C_REM, C_SV, C_TAU, C_TCOLL, C_VEL, SimParams, as_f32,
)


RES_GENS = ("pooled", "constant", "fixed_rate", "one_to_one")  # --reservoir_gen


@dataclass(frozen=True)
class ReservoirTables:
    enter_prob: torch.Tensor  # (R,M) f32
    enter_alias: torch.Tensor  # (R,M,2) f32 Walker alias [accept p, bitcast
    #   partner id]
    enter_lambda: torch.Tensor  # (R,) f32 total entry rate per reservoir
    inj_props: torch.Tensor  # (R,M,5) f32 per-(reservoir, mode) injection
    #   properties [omega, vx, vy, vz, tau(T_res)]
    n_reservoirs: int = field(metadata=dict(static=True))

    @property
    def enter_prob_host(self) -> np.ndarray:
        """(R, M) float32 entry probabilities on the host (the 'constant'
        accumulator's increment), cached like `lambda_host`."""
        cached = getattr(self, "_enter_prob_host", None)
        if cached is None:
            cached = self.enter_prob.detach().cpu().numpy()
            object.__setattr__(self, "_enter_prob_host", cached)
        return cached

    @property
    def lambda_host(self) -> np.ndarray:
        """(R,) float32 entry rates on the host (the pooled accumulator's
        increment), cached so a step never reads them back from the device."""
        cached = getattr(self, "_lambda_host", None)
        if cached is None:
            cached = self.enter_lambda.detach().cpu().numpy()
            object.__setattr__(self, "_lambda_host", cached)
        return cached


def build_reservoir_tables(
    mat: Material,
    domain: Domain,
    dt: float,
    particle_density: float,
    device=None,
) -> ReservoirTables:
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    res = domain.res_facets
    R = len(res)
    M = mat.n_modes
    if R == 0:
        return ReservoirTables(
            enter_prob=f32(np.zeros((0, M))),
            enter_alias=f32(np.zeros((0, M, 2))),
            enter_lambda=f32(np.zeros(0)),
            inj_props=f32(np.zeros((0, M, 5))),
            n_reservoirs=0,
        )
    v = mat.group_vel.reshape(M, 3)
    normals = domain.mesh.facet_normals[res]  # outward
    areas = domain.mesh.facet_areas[res]
    bound_thickness = mat.n_active_modes / (particle_density * areas)  # (R,)
    proj = v @ (-normals.T)  # (M,R) projection on inward normals
    ep = np.maximum(proj.T * dt / bound_thickness[:, None], 0.0)  # (R,M)
    from nanokappa_torch.sim.boundary_tables import build_alias

    ap = np.ones((R, M))
    ai = np.zeros((R, M), dtype=np.int64)
    for r in range(R):
        ap[r], ai[r] = build_alias(ep[r])
    alias = np.stack(
        [ap.astype(np.float32), ai.astype(np.int32).view(np.float32)],
        axis=-1,
    )

    # per-(reservoir, mode) injection properties at the reservoir
    # temperature (flux facets read 0 K after nan_to_num, clamping the
    # lifetime lerp at the table edge)
    T_res = np.nan_to_num(np.asarray(domain.res_values, dtype=np.float64))
    tau_T = np.asarray(mat.tau_T, dtype=np.float64)
    tau2d = np.asarray(mat.tau, dtype=np.float64).reshape(len(tau_T), M)
    nT = len(tau_T)
    ti = np.clip(np.searchsorted(tau_T, T_res) - 1, 0, max(nT - 2, 0))
    hi = np.minimum(ti + 1, nT - 1)
    w = np.clip(
        (T_res - tau_T[ti]) / np.maximum(tau_T[hi] - tau_T[ti], 1e-30),
        0.0, 1.0,
    )
    tau_res = tau2d[ti] * (1.0 - w)[:, None] + tau2d[hi] * w[:, None]
    om = np.asarray(mat.omega).reshape(1, M).repeat(R, axis=0)
    props = np.concatenate(
        [om[:, :, None], v.reshape(1, M, 3).repeat(R, axis=0),
         tau_res[:, :, None]], axis=-1
    )
    return ReservoirTables(
        enter_prob=f32(ep),
        enter_alias=f32(alias),
        enter_lambda=f32(ep.sum(axis=1)),
        inj_props=f32(props),
        n_reservoirs=R,
    )


def autosize_inj_cap(rtab: ReservoirTables, n_shards: int = 1) -> int:
    """Injection-buffer width from the expected entry rate: sum(enter_prob)
    IS the expected count; 1.3x + 128 covers the fractional-draw noise."""
    if rtab.n_reservoirs == 0:
        return 128
    exp = float(np.sum(host(rtab.enter_prob))) / max(n_shards, 1)
    return max(512, -(-int(1.3 * exp + 128) // 128) * 128)


def autosize_c_max(rtab: ReservoirTables, n_shards: int = 1) -> int:
    """Copies per (reservoir, mode) per step of the deterministic
    generation lattice: floor(max enter rate) + 1 fractional."""
    if rtab.n_reservoirs == 0:
        return 3
    max_ep = float(np.max(host(rtab.enter_prob))) / max(n_shards, 1)
    return max(3, int(max_ep) + 1)


def pooled_counts(res_counter: np.ndarray, rtab: ReservoirTables, n_shards: int):
    """One step of the pooled accumulator, on the host in float32.

    Returns (per-reservoir counts (R,) int64, new res_counter)."""
    lam = rtab.lambda_host / np.float32(n_shards)
    acc = res_counter[0, :, 0] + lam
    n_r = np.floor(acc).astype(np.int32)
    new_counter = res_counter.copy()
    new_counter[0, :, 0] = acc - n_r.astype(np.float32)
    return n_r.astype(np.int64), new_counter


def constant_counts(res_counter: np.ndarray, rtab: ReservoirTables, n_shards: int, c_max: int):
    """One step of the 'constant' scheme's per-(reservoir, mode) fractional
    accumulator, on the host in float32.

    Returns (counts (R*M,) int32 copies of each (reservoir, mode), the
    number of them the (c_max, R*M) lattice cannot hold, new res_counter)."""
    ep = rtab.enter_prob_host / np.float32(n_shards)
    fixed = np.floor(ep)
    counter = res_counter[0] + (ep - fixed)
    extra = (counter >= np.float32(1.0)).astype(np.float32)
    new_counter = (counter - extra)[None]
    counts = (fixed + extra).astype(np.int32).reshape(-1)
    clipped = int(np.maximum(counts - c_max, 0).sum())
    return counts, clipped, new_counter


def _lattice(counts_d, copy0, ep, M: int, params: SimParams, gen, dev):
    """The copy lattice of the 'constant' and 'fixed_rate' schemes: lane
    l = c * R*M + rm holds copy c of (reservoir, mode) rm where
    counts_d[rm] > c, packed to the front by kernel C (ops/compact.py) in
    lattice order. Copy 0 arrives at the fraction copy0 / enter_prob of the
    step (the accumulator, or the dice), copy c >= 1 at (c + u) /
    enter_prob. Returns (inj_res, inj_mode, inj_dtin), (cap,) each."""
    from nanokappa_torch.ops.compact import compact_indices

    RM = ep.shape[0]
    cap, c_max, dt = params.inj_cap, params.c_max, params.dt
    u = torch.rand((c_max, RM), generator=gen, device=dev)
    c_lat = torch.arange(c_max, dtype=torch.float32, device=dev)[:, None]
    frac_lat = torch.where(ep[None] > 0, (c_lat + u) / ep[None], 0.0)
    frac_lat[0] = torch.where(ep > 0, copy0 / ep, 0.0)
    lat_valid = counts_d[None, :] > torch.arange(c_max, device=dev)[:, None]
    order, _ = compact_indices(lat_valid.reshape(-1), cap)
    order = order.long()
    rm = torch.clamp(order % RM, max=RM - 1)
    frac = frac_lat.reshape(-1)[torch.clamp(order, max=c_max * RM - 1)]
    inj_dtin = torch.clamp(dt * (1.0 - frac), 0.0, dt)
    return rm // M, rm % M, inj_dtin


def _constant_lattice(res_counter, rtab: ReservoirTables, params: SimParams, gen, dev):
    """The 'constant' scheme's draws: (inj_res, inj_mode, inj_dtin (cap,)
    in lattice order, n_valid, dropped, new res_counter)."""
    M = rtab.enter_prob.shape[1]
    counts, clipped, new_counter = constant_counts(res_counter, rtab, params.n_shards, params.c_max)
    total = int(counts.sum()) - clipped
    n_valid = min(total, params.inj_cap)
    dropped = max(total - n_valid, 0) + clipped
    ep = rtab.enter_prob.reshape(-1) / params.n_shards
    counter_d = torch.as_tensor(new_counter.reshape(-1), device=dev)
    inj = _lattice(torch.as_tensor(counts, device=dev), counter_d, ep, M, params, gen, dev)
    return (*inj, n_valid, dropped, new_counter)


def _fixed_rate_lattice(rtab: ReservoirTables, params: SimParams, gen, dev):
    """The 'fixed_rate' scheme's draws (nanokappa_tpu/sim/reservoir.py:202-247):
    (inj_res, inj_mode, inj_dtin (cap,) in lattice order, n_valid, dropped).
    floor(enter_prob) copies of each (reservoir, mode) plus one where its
    dice <= the fractional part; counts above c_max are clipped into
    `dropped`. The dice are drawn on the device; the lattice's count and
    the clip come back in one copy."""
    M = rtab.enter_prob.shape[1]
    ep = rtab.enter_prob.reshape(-1) / params.n_shards
    fixed = torch.floor(ep)
    dice = torch.rand(ep.shape[0], generator=gen, device=dev)
    counts = (fixed + (dice <= ep - fixed).float()).to(torch.int32)
    kept = torch.clamp(counts, max=params.c_max)
    inj = _lattice(counts, dice, ep, M, params, gen, dev)
    total, clipped = torch.stack([kept.sum(), (counts - kept).sum()]).tolist()
    n_valid = min(total, params.inj_cap)
    return (*inj, n_valid, max(total - n_valid, 0) + clipped)


def one_to_one_share(n_leaving, shard: int, n_shards: int):
    """Shard `shard`'s part of the global n_leaving under 'one_to_one': the
    quotient, plus one of the remainder on the low shards
    (nanokappa_tpu/sim/reservoir.py:293-297), so the parts sum to it."""
    return n_leaving // n_shards + (shard < n_leaving % n_shards)


def _one_to_one(n_leaving: torch.Tensor, rtab: ReservoirTables, params: SimParams, gen, dev,
                shard: int = 0):
    """The 'one_to_one' scheme's draws (nanokappa_tpu/sim/reservoir.py:289-318):
    (inj_res, inj_mode, inj_dtin (cap,), n_valid, dropped). Reservoir r
    regenerates its shard's part of the n_leaving[r] particles that left
    it in the previous step (one_to_one_share), in its block of per =
    inj_cap // R lanes (the rest are dropped),
    modes by the Walker alias of enter_prob (distribution-identical to the
    reference's roulette); kernel C packs the valid lanes of the (R, per)
    block to the front, in block order. n_leaving is read back once."""
    from nanokappa_torch.ops.compact import compact_indices

    R, M_tab = rtab.enter_alias.shape[:2]
    cap, dt = params.inj_cap, params.dt
    per = cap // R
    share = n_leaving.to(device=dev, dtype=torch.int32)
    if params.n_shards > 1:
        share = one_to_one_share(share, shard, params.n_shards)
    share_h = np.asarray(share.tolist(), dtype=np.int64)
    n_valid = int(np.minimum(share_h, per).sum())
    dropped = max(int(share_h.sum()) - n_valid, 0)
    lane = torch.arange(R * per, device=dev)
    res_l = lane // per
    u3 = torch.rand((R * per, 3), generator=gen, device=dev)
    jdraw = torch.clamp((u3[:, 0] * M_tab).to(torch.int32), max=M_tab - 1)
    pa = rtab.enter_alias[res_l, jdraw.long()]
    modes = torch.where(u3[:, 1] < pa[:, 0], jdraw, pa[:, 1].contiguous().view(torch.int32))
    valid = (lane % per) < share[res_l]
    order, _ = compact_indices(valid, cap)
    order = torch.clamp(order.long(), max=R * per - 1)
    return res_l[order], modes[order], dt * u3[order, 2], n_valid, dropped


def _facet_positions(geo: DeviceGeometry, inj_res, gen, cap: int, dev, u2=None):
    """Uniform positions on each lane's reservoir facet: a box wall as a
    rectangle (at the uniforms `u2` when given), any other facet by an
    area-CDF triangle pick and a folded barycentric draw
    (nanokappa_tpu/sim/reservoir.py:336-369)."""
    if geo.is_box and geo.res_rect.shape[0] == geo.n_reservoirs:
        if u2 is None:
            u2 = torch.rand((cap, 2), generator=gen, device=dev)
        rect = geo.res_rect[inj_res]  # (cap,9)
        return rect[:, 0:3] + u2[:, :1] * rect[:, 3:6] + u2[:, 1:2] * rect[:, 6:9]
    ut = torch.rand(cap, generator=gen, device=dev)
    cdf = geo.res_tri_cdf[inj_res]  # (cap, K): K triangles per facet
    k = torch.clamp((cdf < ut[:, None]).sum(dim=1), max=geo.res_tri_cdf.shape[1] - 1)
    tri = geo.res_tri_idx[inj_res, k].long()
    b = torch.rand((cap, 2), generator=gen, device=dev)
    b = torch.where((b.sum(dim=1) > 1.0)[:, None], 1.0 - b, b)
    return geo.tri_origin[tri] + b[:, :1] * geo.tri_e1[tri] + b[:, 1:] * geo.tri_e2[tri]


def sample_injections(
    res_counter: np.ndarray,
    geo: DeviceGeometry,
    rtab: ReservoirTables,
    params: SimParams,
    gen: torch.Generator,
    n_leaving: torch.Tensor | None = None,
    shard: int = 0,
):
    """Generate this step's reservoir particles WITHOUT placing them;
    'one_to_one' takes the previous step's (R,) n_leaving, of which shard
    `shard` of params.n_shards regenerates its part (every other scheme
    runs at rate / n_shards with the shard's own accumulator).

    Returns (rows_T (16, cap) f32 packed columns, valid lanes first;
    n_valid (host int); new res_counter; dropped (host int))."""
    if params.res_gen not in RES_GENS:
        raise ValueError(f"unknown reservoir_gen {params.res_gen!r}")
    R, M_tab = rtab.enter_alias.shape[:2]
    cap = params.inj_cap
    dev = geo.device
    dt = params.dt

    if params.res_gen == "pooled":
        n_r, new_counter = pooled_counts(res_counter, rtab, params.n_shards)
        boundaries = np.cumsum(n_r)
        total = int(boundaries[-1])
        n_valid = min(total, cap)
        dropped = max(total - n_valid, 0)

        lane = torch.arange(cap, dtype=torch.int32, device=dev)
        # searchsorted(boundaries, lane, side='right') clamped to R-1, from
        # the host boundaries as scalars (no host-to-device copy)
        inj_res = torch.zeros(cap, dtype=torch.int64, device=dev)
        for r in range(R - 1):
            inj_res += lane >= int(boundaries[r])
        u5 = torch.rand((cap, 5), generator=gen, device=dev)
        jdraw = torch.clamp((u5[:, 0] * M_tab).to(torch.int32), max=M_tab - 1)
        pa = rtab.enter_alias[inj_res, jdraw.long()]  # (cap,2): one row gather
        accept = u5[:, 1] < pa[:, 0]
        inj_mode = torch.where(accept, jdraw, pa[:, 1].contiguous().view(torch.int32))
        inj_dtin = dt * u5[:, 2]
        inj_pos = _facet_positions(geo, inj_res, gen, cap, dev, u2=u5[:, 3:5])
    else:
        # each scheme's compaction already packs the valid lanes first, and
        # every unused lane holds the sentinel's values: the JAX package's
        # re-compaction of the valid prefix is the identity here, as it
        # skips it for 'pooled'
        new_counter = res_counter
        if params.res_gen == "constant":
            inj_res, inj_mode, inj_dtin, n_valid, dropped, new_counter = _constant_lattice(
                res_counter, rtab, params, gen, dev
            )
        elif params.res_gen == "fixed_rate":
            inj_res, inj_mode, inj_dtin, n_valid, dropped = _fixed_rate_lattice(rtab, params, gen, dev)
        else:
            if n_leaving is None:
                raise ValueError("reservoir_gen='one_to_one' needs the previous step's n_leaving")
            inj_res, inj_mode, inj_dtin, n_valid, dropped = _one_to_one(
                n_leaving, rtab, params, gen, dev, shard
            )
        inj_pos = _facet_positions(geo, inj_res, gen, cap, dev)

    T_res = geo.res_temperature[inj_res]
    props = rtab.inj_props[inj_res, inj_mode.long()]  # (cap, 5)
    inj_omega = props[:, 0]
    rows = torch.empty((N_COLS, cap), dtype=torch.float32, device=dev)
    rows[C_POS] = inj_pos.T
    rows[C_VEL] = props[:, 1:4].T
    rows[C_OMEGA] = inj_omega
    rows[C_TAU] = props[:, 4]
    rows[C_DEV] = occupation_delta_T(T_res, params.t_reference, inj_omega)
    rows[C_MODE] = as_f32(inj_mode)
    rows[C_CF] = as_f32(torch.full((cap,), STALE, dtype=torch.int32, device=dev))
    rows[C_TCOLL] = float("inf")
    rows[C_ONF] = as_f32(geo.res_facet[inj_res])
    rows[C_REM] = inj_dtin / dt
    rows[C_ALIVE] = 1.0
    rows[C_SV] = 0.0
    return rows, n_valid, new_counter, dropped


def inject(state, geo: DeviceGeometry, rtab: ReservoirTables, params: SimParams, shard: int = 0):
    """The v1 step's injection (nanokappa_tpu/sim/reservoir.py inject :408)
    on the port's pool discipline: this step's reservoir particles appended
    at the pool tail, as the v2 step appends them. The port has no free
    list — dead lanes stay dead until kernel B compacts the pool — so the
    JAX package's slot order (pops from a free list of dead lanes) is not
    kept; the lanes a particle occupies are not observable (nothing reads
    a lane's position in the pool). Updates state.pool, state.tail and
    state.res_counter in place.

    Returns (stale_idx (inj_cap,) int32: the appended lanes, which the
    cascade ray-casts, and the pool width N on unused lanes; capacity
    drops, a host int for lost[0]: the generator's clip plus the particles
    past the pool's end)."""
    pool = state.pool
    N = pool.shape[1]
    cap = params.inj_cap
    lane = torch.arange(cap, dtype=torch.int32, device=pool.device)
    if rtab.n_reservoirs == 0:
        return torch.full((cap,), N, dtype=torch.int32, device=pool.device), 0
    rows, n_valid, new_counter, dropped = sample_injections(
        state.res_counter, geo, rtab, params, state.gen, state.n_leaving, shard
    )
    # the valid rows come first: the lanes that fit are one slice
    tail = state.tail
    n_used = max(0, min(n_valid, N - tail))
    pool[:, tail : tail + n_used] = rows[:, :n_used]
    state.tail = tail + n_used
    state.res_counter = new_counter
    stale = torch.where(lane < n_used, lane + tail, N).to(torch.int32)
    return stale, dropped + (n_valid - n_used)
