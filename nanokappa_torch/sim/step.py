"""The multi-step runner around the fused step.

Torch twin of nanokappa_tpu/sim/step.py `build_step` (:269, v2 branch) and
`make_v2_block_runner` (:347): n_outer blocks of n_inner steps, a lifetime
refresh gated per block, one ledger reset per block, and the pool
defragmented (kernel B) whenever the coming sub-block's appends could reach
the capacity. The JAX package's `lax.cond`s become host `if`s: the tail is a
host integer, so the compaction test reads nothing from the device; the
lifetime gate reads one flag per block and each compaction one tail count.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from nanokappa_torch.ops.compact_pool import compact_pool
from nanokappa_torch.sim.fused import event_window, make_step_v2, refresh_tau_T
from nanokappa_torch.sim.state import TAUB_ROW, SimParams, SimState


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


def build_step(geo, mat, btab, rtab, params: SimParams, n_inner: int = 1, n_outer: int = 1):
    """run(state) -> (state, outputs): advances n_outer blocks of n_inner
    steps IN PLACE (the returned state is the one passed in). outputs is the
    last step's StepOutputs when n_outer == 1, else one stacked row per
    block."""
    step = make_step_v2(geo, mat, btab, rtab, params)
    return make_v2_block_runner(geo, mat, btab, params, step, n_inner, n_outer)


def make_v2_block_runner(geo, mat, btab, params: SimParams, step, n_inner: int, n_outer: int):
    # Tail-room invariant: each step appends up to EVT_CAP + inj_cap rows at
    # the tail and only compaction reclaims dead lanes. Sub-blocks of m steps
    # with m sized so the appends cannot outrun ~N/5 of slack (the wire's
    # kinetic event window makes m smaller than the film's).
    N = params.n_cap
    per_step = event_window(geo, mat, btab, params) + params.inj_cap
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
