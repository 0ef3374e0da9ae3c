"""The general (v1) step and the multi-step runner around either step.

Torch twin of nanokappa_tpu/sim/step.py `make_step` (:58, the v1 step),
`build_step` (:269) and `make_v2_block_runner` (:347): n_outer blocks of
n_inner steps, a lifetime refresh gated per block, one ledger reset per
block, and the pool defragmented (kernel B) whenever the coming
sub-block's appends could reach the capacity. `build_step` takes the fused
v2 step (sim/fused.py make_step_v2) wherever `v2_eligible`, the v1 step
elsewhere; both run in the same runner. The JAX package's `lax.cond`s
become host `if`s: the tail is a host integer, so the compaction test reads
nothing from the device; the lifetime gate reads one flag per block and
each compaction one tail count.

The v1 step (reference classes/Population.py:1724-1769 run_timestep):
  1. reservoir injections appended at the pool tail (sim/reservoir.py
     inject),
  2. the drift + boundary cascade (sim/cascade.py run_cascade: kernel C
     compacts the events, kernel D merges them back),
  3. subvolume binning and the temperature refresh (sim/binning.py
     bin_all),
  4. RTA scattering toward the particle temperatures of the new profile
     (nearest, linear on slices, or the radial RBF), with cached lifetimes.
It runs on the plain 16-row pool and has no deferred RTA (no finalize).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from nanokappa_torch.constants import EVPSA2_IN_WM2
from nanokappa_torch.ops.compact_pool import compact_pool
from nanokappa_torch.sim.binning import (
    bin_sums, interp_T_particles, lookup_E_of_T, lookup_T_of_E, normalize_bins,
    particle_energies, subvol_id,
)
from nanokappa_torch.sim.cascade import cascade_tallies, settle_cascade
from nanokappa_torch.sim.fused import (
    event_window, make_step_v2, refresh_tau_T, require_slice, v2_eligible,
)
from nanokappa_torch.sim.reservoir import inject
from nanokappa_torch.sim.scatter import rta_scatter
from nanokappa_torch.sim.state import (
    C_DEV, C_OMEGA, C_POS, C_SV, C_TAU, C_VEL, TAUB_ROW, SimParams, SimState, as_f32,
)


@dataclass
class StepOutputs:
    T_sv: torch.Tensor  # (SV,)
    E_sv: torch.Tensor  # (SV,) energy density eV/A^3 (incl. reference)
    phi_sv: torch.Tensor  # (SV,3) heat flux W/m^2
    Np_sv: torch.Tensor  # (SV,) i32
    N_p: torch.Tensor  # () particle count
    total_energy: torch.Tensor  # () sum of particle deviation energies (eV)
    res_energy_balance: torch.Tensor  # (R,) raw ledger (eV)
    res_heat_flux: torch.Tensor  # (R,3) raw ledger
    n_leaving: torch.Tensor  # (R,)
    lost: torch.Tensor  # () lost particles (cumulative, total)
    lost_split: torch.Tensor  # (3,) [capacity drops, k_max-stuck, defective]
    frozen: torch.Tensor  # () postponed events (cumulative)


def stack_outputs(outs: list[StepOutputs]) -> StepOutputs:
    return StepOutputs(
        **{f.name: torch.stack([getattr(o, f.name) for o in outs]) for f in fields(StepOutputs)}
    )


def make_step(geo, mat, btab, rtab, params: SimParams, comm=None):
    """step(state) -> (state, StepOutputs), advancing `state` in place: the
    fused v2 step where the configuration is eligible (sim/fused.py
    v2_eligible), else the v1 step. With `comm` (parallel/sharding.py
    ShardComm) the state is one shard of the pool, and the step's sums are
    added up over the shards in one all-reduce before they are normalised."""
    if v2_eligible(geo, params):
        return make_step_v2(geo, mat, btab, rtab, params, comm)
    require_slice(geo, btab, params, mat)
    R = geo.n_reservoirs
    shard = 0 if comm is None else comm.rank

    def step(state: SimState):
        if state.layout != "plain":
            raise ValueError(f"the v1 step runs the 'plain' pool, the state is {state.layout!r}")
        # 1. reservoir injection, 2. drift + boundary cascade
        stale_idx, lost_inj = inject(state, geo, rtab, params, shard)
        ledger, lost, frozen = cascade_tallies(state, stale_idx, geo, mat, btab, params, state.gen)

        # 3. rebin + refresh temperatures (classes/Population.py:685-728);
        # the energies are taken against the SUBVOLUME temperature
        pool = state.pool
        alive = state.alive
        pos = pool[C_POS].T
        sv = subvol_id(geo, pos)
        energies = particle_energies(
            pool[C_OMEGA], pool[C_DEV], alive, state.T_sv[sv.long()], params.t_reference,
        )
        sums = bin_sums(geo, energies, pool[C_VEL].T, sv, alive)
        total_energy = energies.sum()
        if comm is not None:
            # the raw sums of every shard, before the normalisation
            lost = torch.stack([lost[0] + lost_inj, lost[1], lost[2]])
            lost_inj = 0
            sums, total_energy, ledger, lost, frozen = comm.reduce_sums(
                sums, total_energy, ledger, lost, frozen
            )
        settle_cascade(state, R, ledger, lost, frozen)
        e_dev_sv, phi, np_sv = normalize_bins(
            geo, mat, sums, params.energy_normal, params.particle_density,
        )
        phi = phi * EVPSA2_IN_WM2
        E_sv = e_dev_sv + lookup_E_of_T(mat, state.T_sv)
        T_new = lookup_T_of_E(mat, E_sv)

        # 4. RTA scattering toward the particle temperatures of the new
        # profile, with the cached lifetimes
        T_p = interp_T_particles(geo, T_new, pos, sv, params.temp_interp)
        pool[C_DEV] = rta_scatter(
            mat, pool[C_DEV], state.mode, pool[C_OMEGA], T_p, alive,
            params.dt, params.t_reference, tau=pool[C_TAU],
        )
        pool[C_SV] = as_f32(sv)

        if lost_inj:  # capacity drops (rare: a host-to-device copy)
            state.lost = state.lost + torch.tensor([lost_inj, 0, 0], dtype=torch.int32).to(pool.device)
        state.T_sv = T_new
        state.Np_sv = np_sv
        state.step += 1
        out = StepOutputs(
            T_sv=T_new,
            E_sv=E_sv,
            phi_sv=phi,
            Np_sv=np_sv,
            N_p=np_sv.sum(),
            total_energy=total_energy,
            res_energy_balance=state.res_energy_balance,
            res_heat_flux=state.res_heat_flux,
            n_leaving=state.n_leaving,
            lost=state.lost.sum(),
            lost_split=state.lost,
            frozen=state.frozen,
        )
        return state, out

    return step


def build_step(geo, mat, btab, rtab, params: SimParams, n_inner: int = 1, n_outer: int = 1):
    """run(state) -> (state, outputs): advances n_outer blocks of n_inner
    steps IN PLACE (the returned state is the one passed in). outputs is the
    last step's StepOutputs when n_outer == 1, else one stacked row per
    block. The step is the fused v2 one where v2_eligible, else v1."""
    step = make_step(geo, mat, btab, rtab, params)
    return make_v2_block_runner(geo, mat, btab, params, step, n_inner, n_outer)


def make_v2_block_runner(geo, mat, btab, params: SimParams, step, n_inner: int, n_outer: int):
    # Tail-room invariant: each v2 step appends up to EVT_CAP + inj_cap rows
    # at the tail, each v1 step inj_cap (its event rows merge in place), and
    # only compaction reclaims dead lanes. Sub-blocks of m steps with m
    # sized so the appends cannot outrun ~N/5 of slack (the wire's kinetic
    # event window makes m smaller than the film's).
    N = params.n_cap // params.n_shards  # one shard's pool
    per_step = params.inj_cap
    if v2_eligible(geo, params):
        per_step += event_window(geo, mat, btab, params)
    m = max(1, min(n_inner, (N // 5) // max(1, per_step)))
    while n_inner % m:  # largest divisor of n_inner <= the safe bound
        m -= 1
    n_sub = n_inner // m
    need = m * per_step  # worst-case tail growth of one sub-block
    spare = {}  # the second pool buffer kernel B writes into

    def compacted(state: SimState) -> SimState:
        out, tail = compact_pool(state.pool, spare.get("pool"))
        spare["pool"] = state.pool
        state.pool = out
        state.tail = int(tail)  # one host read per compaction
        return state

    def sub(state: SimState):
        if state.tail + need > N:
            compacted(state)
        for _ in range(m):
            state, out = step(state)
        return state, out

    def block(state: SimState):
        maybe_refresh_tau(state, geo, mat, params)
        for _ in range(n_sub):
            state, last = sub(state)
        reset_ledgers(state)
        return state, last

    def run_blocks(state: SimState):
        # one unconditional compaction at entry establishes the tail (a
        # fresh init_state spreads particles across the whole pool)
        compacted(state)
        if n_outer == 1:
            return block(state)
        outs = [block(state)[1] for _ in range(n_outer)]
        return state, stack_outputs(outs)

    return run_blocks


def maybe_refresh_tau(state: SimState, geo, mat, params) -> SimState:
    """Run the full-pool lifetime refresh only when it is due (one host read
    of the flag; nanokappa_tpu/sim/step.py:471):
      * slim and full layouts (slope form): tau(T) = a + b*T is exact
        within a T-grid bin, so when a subvolume temperature CROSSES a bin
        boundary;
      * plain layout (cached full lifetimes): when a subvolume temperature
        drifted more than params.tau_dT since the last refresh."""
    nT = mat.tau_T.shape[0]

    def tbin(T):
        return torch.clamp(torch.searchsorted(mat.tau_T, T) - 1, 0, max(nT - 2, 0))

    if state.layout in TAUB_ROW:
        due = torch.any(tbin(state.T_sv) != tbin(state.T_tau))
    else:
        due = torch.any((state.T_sv - state.T_tau).abs() > params.tau_dT)
    if bool(due):
        refresh_tau_T(state, geo, mat, params)
        state.T_tau = state.T_sv
    return state


def reset_ledgers(state: SimState) -> SimState:
    """Zero the reservoir balance ledgers (reference restart_reservoir_balance,
    classes/Population.py:1695-1699)."""
    state.res_energy_balance = torch.zeros_like(state.res_energy_balance)
    state.res_heat_flux = torch.zeros_like(state.res_heat_flux)
    return state
