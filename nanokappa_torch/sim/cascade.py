"""The boundary-event cascade: the v1 step's whole cascade
(`cascade_tallies`) and the narrow machinery both steps share
(`run_event_buffer`): absorb / periodic / reflect on a fixed-width buffer
of particle rows.

Torch twin of nanokappa_tpu/sim/cascade.py (`run_cascade` :133,
`run_event_buffer` :283 and `_event_round` :482). Per round, a lane sitting
on facet `coll_facet`:
  T/F facet -> absorbed, energy/flux ledgered per reservoir
               (classes/Population.py:1565-1608);
  P facet   -> translated by the facet-pair centroid offset
               (classes/Population.py:1463-1489);
  R facet   -> specular with probability = Ziman specularity (through the
               `spec2` decision table, occupation conserved) else diffuse
               re-emission at the local wall temperature, drawn by Walker
               alias through `diff2` (classes/Population.py:941-1015).
               Rows that kernel A exports flagged (C_TCOLL < -1.5) already
               won their specular Bernoulli in the kernel: round 1 takes
               that draw as THE draw instead of drawing again. Under the
               k (wavevector) model a specular lane swaps to its
               equal-frequency partner branch with probability 1/2
               (classes/Population.py:1017-1040).
Round 1 runs at buffer width; the few survivors are compacted (kernel C,
ops/compact.py) into a narrow buffer for the remaining rounds. Given kernel
F's tables (the v2 step on a box with slices), a CUDA buffer's rounds run
there instead, one launch a round (ops/event_round.py); these torch rounds
are its plain twin, and what every other configuration runs. With kernel
A's cast off (meshes over 128 triangles) every boundary hit arrives here,
absorbing and periodic ones included, and each round's re-cast goes
through ops/raycast.py to kernel E.

Rows are SoA (16, E): the drift kernel exports them in that layout.

The v1 cascade (`cascade_tallies`) runs the stale lanes' ray cast, one
full-width drift written in place into the pool's rows, the event
compaction (kernel C at the pool's width), the narrow machinery on the
gathered event rows, and their merge back into the pool (kernel D,
ops/scatter_rows.py).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from nanokappa_torch.constants import HBAR
from nanokappa_torch.geometry.device import DeviceGeometry
from nanokappa_torch.geometry.domain import BC
from nanokappa_torch.material.tables import MaterialTables
from nanokappa_torch.ops.compact import compact_indices
from nanokappa_torch.ops.raycast import raycast
from nanokappa_torch.ops.scatter_rows import scatter_rows
from nanokappa_torch.sim.binning import interp_T_particles, segment_sum, subvol_id
from nanokappa_torch.sim.bose import occupation_delta_T, occupation_delta_omega
from nanokappa_torch.sim.boundary_tables import K_MODELS, BoundaryTables
from nanokappa_torch.sim.scatter import blend_tau_sv, lifetime_by_sv, lifetime_lookup
from nanokappa_torch.sim.state import (
    C_ALIVE, C_CF, C_DEV, C_MODE, C_OMEGA, C_ONF, C_POS, C_REM, C_SV, C_TAU,
    C_TCOLL, C_VEL, STALE, SimParams, SimState, as_f32, as_i32,
)

_REMAIN_EPS = 1e-5  # fraction of dt below which the remaining path is dust


def pad8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


@dataclass
class _Buf:
    pos: torch.Tensor  # (E,3)
    mode: torch.Tensor  # (E,) i32
    vel: torch.Tensor  # (E,3)
    omega: torch.Tensor
    tau: torch.Tensor
    dev: torch.Tensor
    alive: torch.Tensor  # (E,) bool
    t_coll: torch.Tensor
    coll_facet: torch.Tensor  # (E,) i32
    on_facet: torch.Tensor  # (E,) i32
    remaining: torch.Tensor
    ledger: torch.Tensor  # (R8,5): [energy, flux xyz, absorbed count]
    lost: torch.Tensor  # () i32 defective lanes
    swaps: torch.Tensor  # () i64 k-model degenerate-branch swaps
    round: int

    def pending(self) -> torch.Tensor:
        return self.alive & (self.remaining > _REMAIN_EPS)

    def rows(self, alive: torch.Tensor, sv_bits: torch.Tensor) -> torch.Tensor:
        """(16, E) packed rows of the buffer's lanes."""
        return torch.cat(
            [
                self.pos.T, self.vel.T, self.omega[None], self.tau[None],
                self.dev[None], as_f32(self.mode)[None],
                as_f32(self.coll_facet)[None], self.t_coll[None],
                as_f32(self.on_facet)[None], self.remaining[None],
                alive.float()[None], sv_bits[None],
            ]
        )


def v1_event_cap(params: SimParams) -> int:
    """EVT_CAP of the v1 cascade: the event compaction's width
    (nanokappa_tpu/sim/cascade.py:154), at one shard's pool."""
    return pad8(params.evt_cap or max(params.inj_cap, params.n_cap // params.n_shards // 16))


def _set_lanes(row: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """A copy of the (N,) `row` with `vals` at the lanes idx; lanes idx == N
    (the sentinel) land in a spare element that is dropped."""
    ext = torch.cat([row, row[:1]])
    ext[idx.long()] = vals
    return ext[:-1]


def settle_cascade(state: SimState, R: int, ledger, lost, frozen) -> SimState:
    """Add a step's tallies to the state (sim/step.py postlude): n_leaving,
    the reservoir ledgers, the (3,) losses and the frozen count."""
    state.n_leaving = ledger[:R, 4].to(torch.int32)
    state.res_energy_balance = state.res_energy_balance - ledger[:R, 0]
    state.res_heat_flux = state.res_heat_flux + ledger[:R, 1:4]
    state.lost = state.lost + lost
    state.frozen = state.frozen + frozen
    return state


def cascade_tallies(
    state: SimState,
    stale_idx: torch.Tensor,  # (inj_cap,) i32 lanes needing a ray cast (the
    #   injections sim/reservoir.py inject appended); N on unused lanes
    geo: DeviceGeometry,
    mat: MaterialTables,
    btab: BoundaryTables,
    params: SimParams,
    gen: torch.Generator,
):
    """The v1 step's drift + boundary cascade on the plain 16-row pool,
    IN PLACE (nanokappa_tpu/sim/cascade.py run_cascade :133): the stale
    lanes' ray cast; one full-width drift of every alive lane by
    min(t_coll, remaining), written into the pool's C_POS, C_CF, C_TCOLL
    and C_REM rows; the lanes still on their way at a facet compacted by
    kernel C into an EVT_CAP-wide buffer (ascending, sentinel N; the events
    beyond EVT_CAP stay frozen for the step); the narrow machinery on their
    rows; the rows merged back by kernel D. Absorbed lanes stay dead where
    they are until kernel B compacts the pool (the port has no free list).
    Returns the step's tallies as device tensors, no host read: the
    (R8, 5) ledger, the (3,) int32 losses [0, k_max-stuck, defective] and
    the int32 frozen count, which a sharded step sums over the shards
    before the step's postlude (sim/step.py) adds them to the state."""
    pool = state.pool
    if state.layout != "plain":
        raise ValueError(f"the v1 cascade runs the 'plain' pool, the state is {state.layout!r}")
    dt = params.dt
    N = pool.shape[1]
    R = geo.n_reservoirs
    R8 = pad8(R + 1)
    EVT_CAP = v1_event_cap(params)
    dev = pool.device

    # ---- stale ray casts at the freshly injected lanes ---------------------
    rows_s = pool[:, torch.clamp(stale_idx, max=N - 1).long()]
    t_b, f_b = raycast(geo, rows_s[C_POS].T, rows_s[C_VEL].T, as_i32(rows_s[C_ONF]))
    coll_old = as_i32(pool[C_CF])
    t_coll = _set_lanes(pool[C_TCOLL], stale_idx, t_b / dt)
    coll_facet = _set_lanes(coll_old, stale_idx, f_b)
    alive = pool[C_ALIVE] > 0.5
    # defensive: a STALE alive lane left over (an externally edited state)
    # freezes for this step instead of drifting blindly
    was_stale = coll_old == STALE
    still_stale = alive & (coll_facet == STALE)
    t_coll = torch.where(still_stale, float("inf"), t_coll)
    # remaining dt fraction: fresh injections carry their partial dt_in/dt
    # in C_REM (they are the lanes that were STALE before the cast)
    remaining = torch.where(
        was_stale & alive, pool[C_REM], torch.where(alive, 1.0, 0.0)
    )

    # ---- phase A: one full-width drift, in place ------------------------------
    step_frac = torch.where(alive & ~still_stale, torch.minimum(t_coll, remaining), 0.0)
    step_frac = torch.where(torch.isfinite(step_frac), step_frac, remaining)
    step_frac = torch.where(still_stale, 0.0, step_frac)
    pool[C_POS] = pool[C_POS] + pool[C_VEL] * (dt * step_frac)[None]
    pool[C_TCOLL] = t_coll - step_frac
    rem_after = torch.where(alive, remaining - step_frac, 0.0)
    pool[C_REM] = rem_after
    pool[C_CF] = as_f32(coll_facet)
    event = alive & (rem_after > _REMAIN_EPS) & (coll_facet >= 0)

    # ---- phase B: the compacted event rows through the narrow machinery -------
    pidx, n_evt = compact_indices(event, EVT_CAP)
    frozen = event.sum(dtype=torch.int32) - n_evt  # beyond capacity: frozen
    vbuf = torch.arange(EVT_CAP, device=dev) < n_evt
    rows = pool[:, torch.clamp(pidx, max=N - 1).long()]
    rows_out, ledger, lost_stuck, lost_def, frozen2, swaps = run_event_buffer(
        rows, vbuf, geo, mat, btab, params, gen, state.T_sv, R8,
        evt2_cap=EVT_CAP // 16,  # kinetic buffer: survivors are rare
    )
    # pidx ascending + unique; its sentinel lanes are dropped
    scatter_rows(pool, rows_out.contiguous(), pidx)

    state.kernel_events[2] += swaps
    lost = torch.stack([torch.zeros_like(lost_stuck), lost_stuck, lost_def]).to(torch.int32)
    return ledger, lost, (frozen + frozen2 + still_stale.sum(dtype=torch.int32)).to(torch.int32)


def run_event_buffer(
    rows: torch.Tensor,  # (16, E) packed rows of pending-event particles
    vbuf: torch.Tensor,  # (E,) validity mask (False = padding lane)
    geo: DeviceGeometry,
    mat: MaterialTables,
    btab: BoundaryTables,
    params: SimParams,
    gen: torch.Generator,
    T_sv: torch.Tensor,
    R8: int,
    evt2_cap: int | None = None,  # width of the rounds-2+ buffer; None ->
    #   E // 4 (the mirror path's deep-chain sizing)
    kernel=None,  # kernel F's tables (ops/event_round.py round_tables): a
    #   CUDA buffer's rounds run there, one launch a round
):
    """Lanes enter sitting on facet C_CF with C_REM > 0. Returns
    (rows_out (16, E) with C_ALIVE updated, ledger (R8,5), lost_stuck
    (quarantined after k_max rounds), lost_defective (no boundary found),
    frozen (narrow-buffer overflow), swaps (the k model's degenerate-branch
    swaps)) — counts as device scalars. `rows` is left as it was."""
    E = rows.shape[1]
    dev = rows.device
    EVT2 = pad8(max(evt2_cap if evt2_cap is not None else E // 4, 512))
    if kernel is not None and dev.type == "cuda":
        from nanokappa_torch.ops.event_round import event_rounds

        return event_rounds(kernel, rows, vbuf, gen, T_sv, R8, EVT2)
    buf = _Buf(
        pos=rows[C_POS].T,
        mode=as_i32(rows[C_MODE]),
        vel=rows[C_VEL].T,
        omega=rows[C_OMEGA],
        tau=rows[C_TAU],
        dev=rows[C_DEV],
        alive=vbuf,
        t_coll=torch.zeros(E, device=dev),
        coll_facet=torch.where(vbuf, as_i32(rows[C_CF]), -1),
        on_facet=as_i32(rows[C_ONF]),
        remaining=torch.where(vbuf, rows[C_REM], 0.0),
        ledger=torch.zeros((R8, 5), device=dev),
        lost=torch.zeros((), dtype=torch.int32, device=dev),
        swaps=torch.zeros((), dtype=torch.int64, device=dev),
        round=0,
    )
    tau_sv_blend = blend_tau_sv(mat, T_sv)

    def body(b, forced=None):
        return _event_round(
            b, geo, mat, btab, params, R8, T_sv, tau_sv_blend, gen, forced
        )

    # ---- round 1 at full buffer width; most events finish here -------------
    # forced-specular lanes: kernel A's Bernoulli already decided them (only
    # round 1 sees flags; later rounds are fresh wall hits)
    buf1 = body(buf, forced=vbuf & (rows[C_TCOLL] < -1.5))

    # ---- rounds 2+ on a compacted narrow buffer ------------------------------
    surv = buf1.pending()
    sidx2, n2 = compact_indices(surv, EVT2)
    frozen2 = surv.sum(dtype=torch.int32) - n2  # overflow: stay alive, frozen
    v2 = torch.arange(EVT2, device=dev) < n2
    g = torch.clamp(sidx2, max=E - 1).long()
    buf2 = _Buf(
        pos=buf1.pos[g],
        mode=buf1.mode[g],
        vel=buf1.vel[g],
        omega=buf1.omega[g],
        tau=buf1.tau[g],
        dev=buf1.dev[g],
        alive=v2,
        t_coll=torch.where(v2, buf1.t_coll[g], 0.0),
        coll_facet=torch.where(v2, buf1.coll_facet[g], -1),
        on_facet=buf1.on_facet[g],
        remaining=torch.where(v2, buf1.remaining[g], 0.0),
        ledger=buf1.ledger,
        lost=buf1.lost,
        swaps=buf1.swaps,
        round=buf1.round,
    )
    # the reference's `while np.any(calculated_ts < 1)` (one host read per
    # round; the deep chains behind it are rare)
    while buf2.round < params.k_max and bool(buf2.pending().any()):
        buf2 = body(buf2)

    sv_bits = rows[C_SV]
    rows_out = buf1.rows(buf1.alive, sv_bits)
    # stuck after k_max rounds: quarantine (reference indexes_del_extra,
    # classes/Population.py:1553,1572)
    stuck2 = buf2.pending()
    lost_stuck = stuck2.sum(dtype=torch.int32)
    rows2 = buf2.rows(buf2.alive & ~stuck2, sv_bits[g])
    # scatter the narrow results back; sentinel lanes (index E) land in a
    # spare column that is dropped
    ext = torch.cat([rows_out, torch.zeros((rows.shape[0], 1), device=dev)], 1)
    ext[:, sidx2.long()] = rows2
    return ext[:, :E], buf2.ledger, lost_stuck, buf2.lost, frozen2, buf2.swaps


def _event_round(
    b: _Buf,
    geo: DeviceGeometry,
    mat: MaterialTables,
    btab: BoundaryTables,
    params: SimParams,
    R8: int,
    T_sv: torch.Tensor,
    tau_sv_blend: torch.Tensor,
    gen: torch.Generator,
    forced: torch.Tensor | None = None,  # lanes whose specular Bernoulli
    #   kernel A already won (round 1 only)
) -> _Buf:
    dt = params.dt
    E = b.pos.shape[0]
    # ONE uniform tensor serves specularity, alias slot and alias accept
    u4 = torch.rand((E, 4), generator=gen, device=b.pos.device)

    at_wall = b.alive & (b.remaining > _REMAIN_EPS) & (b.t_coll <= 1e-9)
    cf = torch.clamp(b.coll_facet, 0, geo.n_facets - 1)
    cfl = cf.long()
    at_wall = at_wall & (b.coll_facet >= 0)
    bc = geo.facet_bc[cfl]

    # --- absorption at reservoirs (T/F) -------------------------------------
    absorb = at_wall & ((bc == int(BC.TEMPERATURE)) | (bc == int(BC.FLUX)))
    res_id = geo.facet_res[cfl]
    T_res = geo.facet_value[cfl]
    dn_abs = b.dev - occupation_delta_T(T_res, params.t_reference, b.omega)
    e_abs = HBAR * b.omega * dn_abs
    n_out = geo.facet_normal[cfl]
    vdn = (b.vel * n_out).sum(dim=1)
    # reference ledger: hflux += e*v/(v.n) (classes/Population.py:1599-1600),
    # with the grazing-incidence obliquity clamped at 1e3x (|v.n| >= 1e-3|v|)
    vmag = torch.linalg.vector_norm(b.vel, dim=1)
    vdn_safe = torch.sign(vdn) * torch.maximum(vdn.abs(), 1e-3 * vmag)
    flux_w = torch.where(vdn_safe.abs() > 1e-30, e_abs / vdn_safe, 0.0)
    seg = torch.where(absorb & (res_id >= 0), res_id, R8 - 1)
    fw = torch.where(absorb, flux_w, 0.0)
    vals = torch.stack(
        [
            torch.where(absorb, e_abs, 0.0),
            fw * b.vel[:, 0],
            fw * b.vel[:, 1],
            fw * b.vel[:, 2],
            absorb.float(),
        ],
        dim=1,
    )
    ledger = b.ledger + segment_sum(vals, seg, R8)
    alive = b.alive & ~absorb
    remaining = torch.where(absorb, 0.0, b.remaining)

    # --- periodic translation -------------------------------------------------
    per = at_wall & (bc == int(BC.PERIODIC))
    pos = b.pos + torch.where(per, 1.0, 0.0)[:, None] * geo.periodic_shift[cfl]
    on_facet = torch.where(per, geo.periodic_pair[cfl], b.on_facet)

    # --- rough-wall reflection -------------------------------------------------
    ref = at_wall & (bc == int(BC.ROUGH))
    if btab.n_rough > 0:
        i_rough = torch.clamp(
            geo.facet_rough[cfl], 0, btab.row_of_rough.shape[0] - 1
        ).long()
        # a back-side hit (velocity against the stored normal) uses the row
        # built for the flipped normal (two-sided internal membranes)
        row = torch.where(
            vdn < 0.0, btab.row_back[i_rough], btab.row_of_rough[i_rough]
        ).long()
    else:
        row = torch.zeros_like(cfl)
    sc = btab.spec2[row, b.mode.long()]  # (E,2) [specularity, bitcast(corr)]
    p_spec = sc[:, 0]
    corr_m = as_i32(sc[:, 1])
    bern = u4[:, 0] <= p_spec
    if forced is not None:
        # a forced lane without a partner still diffuses (always-diffuse rule)
        bern = bern | forced
    spec = ref & bern & (corr_m >= 0)
    diff = ref & ~spec

    # diffuse re-emission by Walker alias sampling
    M = btab.diffuse_prob.shape[1]
    j = torch.clamp((u4[:, 1] * M).to(torch.int32), max=M - 1)
    pa = btab.diff2[row, j.long()]  # (E,2) [alias prob, bitcast(alias idx)]
    accept = u4[:, 2] < pa[:, 0]
    mode_diff = torch.where(accept, j, as_i32(pa[:, 1]))

    changed = spec | diff
    mode_spec = torch.where(spec, corr_m, b.mode)
    swaps = b.swaps
    if params.scat_model in K_MODELS:
        # the k model's degenerate-branch split (classes/Population.py:
        # 1017-1040): a specular lane whose mode has an equal-frequency
        # partner branch swaps to it with probability 1/2
        partner = btab.degen_partner[torch.clamp(mode_spec, 0, M - 1).long()]
        swap = spec & (partner >= 0) & (u4[:, 3] >= 0.5)
        mode_spec = torch.where(swap, partner, mode_spec)
        swaps = swaps + swap.sum(dtype=torch.int64)
    mode = torch.where(spec, mode_spec, torch.where(diff, mode_diff, b.mode))
    ov = mat.omega_vel[mode.long()]  # (E,4) shared table
    omega_new = torch.where(changed, ov[:, 0], b.omega)
    vel_new = torch.where(changed[:, None], ov[:, 1:4], b.vel)

    sv_here = subvol_id(geo, pos)
    T_wall = interp_T_particles(geo, T_sv, pos, sv_here, params.temp_interp)
    if params.temp_interp == "nearest":
        tau_new = lifetime_by_sv(mat, T_sv, sv_here, mode, tau_sv=tau_sv_blend)
    else:
        tau_new = lifetime_lookup(mat, T_wall, mode)
    tau_new = torch.where(changed, tau_new, b.tau)
    dev = torch.where(
        spec,
        b.dev + occupation_delta_omega(params.t_reference, b.omega, omega_new),
        torch.where(
            diff,
            occupation_delta_T(T_wall, params.t_reference, omega_new),
            b.dev,
        ),
    )
    on_facet = torch.where(ref, cf, on_facet)

    # --- re-cast + drift the buffer ---------------------------------------------
    recast = per | ref
    t_ps, facet_new = raycast(geo, pos, vel_new, on_facet)
    t_coll = torch.where(recast, t_ps / dt, b.t_coll)
    coll_facet = torch.where(recast, facet_new, b.coll_facet)

    step_frac = torch.where(
        alive & (remaining > 0), torch.minimum(t_coll, remaining), 0.0
    )
    step_frac = torch.where(torch.isfinite(step_frac), step_frac, remaining)
    pos = pos + vel_new * (dt * step_frac)[:, None]
    t_coll = t_coll - step_frac
    remaining = torch.clamp(remaining - step_frac, min=0.0)
    # defective lanes (no boundary found): drain them like the reference's
    # indexes_del_extra
    bad = alive & (remaining > _REMAIN_EPS) & (coll_facet < 0)
    alive = alive & ~bad
    remaining = torch.where(bad, 0.0, remaining)

    return replace(
        b,
        pos=pos,
        mode=mode,
        vel=vel_new,
        omega=omega_new,
        tau=tau_new,
        dev=dev,
        alive=alive,
        t_coll=t_coll,
        coll_facet=coll_facet,
        on_facet=on_facet,
        remaining=remaining,
        ledger=ledger,
        lost=b.lost + bad.sum(dtype=torch.int32),
        swaps=swaps,
        round=b.round + 1,
    )
