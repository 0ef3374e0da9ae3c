"""Particle-axis data parallelism over torch.distributed.

Torch counterpart of nanokappa_tpu/parallel/sharding.py. The algorithm's
communication structure is the JAX package's:

  * the particle pool splits along its lane axis into S contiguous
    segments, one a process ("rank"): drift, cascade, scattering and ray
    casting are embarrassingly parallel, and particles never migrate;
  * the material, geometry and boundary tables are replicated (each rank
    builds its own);
  * the per-subvolume sums and the reservoir ledgers are the only traffic
    between ranks: ONE float64 all-reduce a step (ShardComm.reduce_sums),
    of the raw sums before the normalisation and the T(E) inversion, so
    every rank ends each step with the same T_sv, ledgers and outputs, bit
    for bit;
  * each rank owns its slice of the reservoir process (rate / S, its own
    accumulator, its own random stream: shard_seed) and its own tail.

A rank's step runs as the one-shard step does; `comm=None` is one shard
with no collective at all. The collectives sit outside every
data-dependent branch (the narrow rounds' loop, the compaction test, the
lifetime refresh and the driver's event-window regrow all decide on a
rank's own lanes or on replicated values), so every rank calls each one
the same number of times.

An optional replica axis (make_ensemble_groups, build_ensemble_step) runs
independent Monte Carlo chains, each over its own particle group; their
outputs meet only at readout.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, fields

import torch
import torch.distributed as dist

from nanokappa_torch.sim.state import C_ALIVE, SimState, make_generator, prime_collision_cache


@dataclass
class ShardComm:
    """One rank's view of its particle group: the only hook the step sees."""

    rank: int  # this rank's shard index within the group
    size: int  # S, the group's shard count
    device: torch.device  # this rank's device
    group: object = None  # the process group (None: the default world)
    host_group: object = None  # a gloo group over the same ranks for host
    #   tensors (checkpoint gathers); None: `group` takes them
    seconds: float = 0.0  # host time spent in allreduce_sum_
    calls: int = 0  # allreduce_sum_ calls

    def allreduce_sum_(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum `flat` over the group's ranks, in place."""
        t0 = time.perf_counter()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return flat

    def reduce_sums(self, *parts: torch.Tensor) -> list[torch.Tensor]:
        """The parts summed over the ranks, in ONE all-reduce of a float64
        buffer (integer counts stay exact), each back in its dtype and
        shape."""
        flat = torch.cat([p.reshape(-1).to(torch.float64) for p in parts])
        self.allreduce_sum_(flat)
        out, o = [], 0
        for p in parts:
            out.append(flat[o:o + p.numel()].reshape(p.shape).to(p.dtype))
            o += p.numel()
        return out

    def gather_host(self, rows: torch.Tensor) -> torch.Tensor | None:
        """Rank 0 gets every rank's (n_r, K) host rows concatenated in rank
        order; the other ranks get None. Two collectives on the host group:
        the row counts, then the rows padded to the longest."""
        group = self.host_group if self.host_group is not None else self.group
        n = torch.tensor([rows.shape[0]], dtype=torch.int64)
        counts = [torch.zeros_like(n) for _ in range(self.size)]
        dist.all_gather(counts, n, group=group)
        width = max(int(c) for c in counts)
        pad = torch.zeros((width, rows.shape[1]), dtype=rows.dtype)
        pad[: rows.shape[0]] = rows
        bufs = [torch.empty_like(pad) for _ in range(self.size)] if self.rank == 0 else None
        dist.gather(pad, bufs, dst=_global_rank(group, 0), group=group)
        if self.rank != 0:
            return None
        return torch.cat([b[: int(c)] for b, c in zip(bufs, counts)])


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def shard_seed(seed: int, rank: int) -> int:
    """Rank `rank`'s random seed: the run's seed on rank 0 (so one shard
    draws the unsharded run's streams), mixed with the rank elsewhere — its
    torch Generator and kernel A's in-kernel step seeds (sim/fused.py
    step_seed) then differ on every rank (the JAX package folds the shard
    index into its key, nanokappa_tpu/sim/fused.py:777-778)."""
    from nanokappa_torch.ops.megastep import lowbias32

    return int(seed) ^ lowbias32(rank)


def _backend_group(ranks, backend: str):
    """A group over `ranks`; the default world when it is all of them."""
    if list(ranks) == list(range(dist.get_world_size())):
        return None
    return dist.new_group(list(ranks), backend=backend)


def _host_group(group_ranks):
    """A gloo group over the same ranks when the world runs another backend
    (NCCL takes no host tensors), else None. Every rank must call it for
    every group, in one order."""
    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(list(group_ranks), backend="gloo")


def make_particle_group(n_shards: int, device) -> ShardComm | None:
    """The counterpart of make_particle_mesh: the first n_shards ranks of the
    initialised world as one particle group, on this rank's `device`. Call
    it on every rank; a rank outside the group gets None."""
    world = dist.get_world_size()
    n = int(n_shards)
    if n > world:
        raise ValueError(f"{n} particle shards need {n} ranks; the world has {world}")
    ranks = range(n)
    group = _backend_group(ranks, dist.get_backend())
    host = _host_group(ranks)
    me = dist.get_rank()
    if me >= n:
        return None
    return ShardComm(me, n, torch.device(device), group, host)


def make_ensemble_groups(n_replicas: int, n_particle_shards: int, device):
    """The counterpart of make_ensemble_mesh: world rank w = r * P + p is
    particle shard p of replica r. Returns (this rank's particle group, its
    replica axis: the ranks holding shard p of every replica, with rank =
    the replica index). Call it on every rank."""
    P, Rn = int(n_particle_shards), int(n_replicas)
    if Rn * P != dist.get_world_size():
        raise ValueError(
            f"{Rn} replicas x {P} shards need {Rn * P} ranks; the world has "
            f"{dist.get_world_size()}"
        )
    me = dist.get_rank()
    backend = dist.get_backend()
    dev = torch.device(device)
    particle = replica = None
    for r in range(Rn):  # every rank creates every group, in one order
        ranks = [r * P + p for p in range(P)]
        g, h = _backend_group(ranks, backend), _host_group(ranks)
        if me in ranks:
            particle = ShardComm(me - r * P, P, dev, g, h)
    for p in range(P):
        ranks = [r * P + p for r in range(Rn)]
        g, h = _backend_group(ranks, backend), _host_group(ranks)
        if me in ranks:
            replica = ShardComm(me // P, Rn, dev, g, h)
    return particle, replica


def shard_state(state: SimState, comm: ShardComm | None, geo, dt: float) -> SimState:
    """This rank's shard of a global state (nanokappa_tpu/parallel/sharding.py
    shard_state and state_specs :54-82), on comm.device:
      * the pool's lane axis splits into comm.size contiguous segments, and
        the rank keeps segment comm.rank, its tail past its last alive lane
        (the JAX init's per-shard local free lists,
        nanokappa_tpu/sim/state.py:405-428: nothing appends before the
        runner's first compaction);
      * the reservoir accumulators are (S, R, M): the rank keeps row rank;
      * the (SV,) arrays and the ledgers are replicated;
      * the random stream is the rank's own (shard_seed).
    The state must come from init_state with params.n_shards = comm.size,
    host_only (so one device holds only its segment): the segment gets its
    first ray cast (geo, dt) on the device. `comm=None` returns the state
    as it is."""
    if comm is None:
        return state
    S, r = comm.size, comm.rank
    N = state.pool.shape[1]
    if N % S or state.res_counter.shape[0] != S:
        raise ValueError(
            f"a {N}-lane state with {state.res_counter.shape[0]} reservoir "
            f"accumulators cannot split into {S} shards: build it with n_shards={S}"
        )
    n = N // S
    dev = comm.device
    pool = state.pool[:, r * n:(r + 1) * n].to(dev, copy=True)
    alive = torch.nonzero(pool[C_ALIVE] > 0.5)
    out = SimState(
        pool=pool,
        layout=state.layout,
        T_sv=state.T_sv.to(dev, copy=True),
        Np_sv=state.Np_sv.to(dev, copy=True),
        T_tau=state.T_tau.to(dev, copy=True),
        tail=int(alive[-1]) + 1 if len(alive) else 0,
        res_counter=state.res_counter[r:r + 1].copy(),
        n_leaving=state.n_leaving.to(dev, copy=True),
        res_energy_balance=state.res_energy_balance.to(dev, copy=True),
        res_heat_flux=state.res_heat_flux.to(dev, copy=True),
        lost=state.lost.to(dev, copy=True),
        frozen=state.frozen.to(dev, copy=True),
        kernel_events=state.kernel_events.to(dev, copy=True),
        gen=make_generator(shard_seed(state.gen.initial_seed(), r), dev),
        step=state.step,
    )
    return prime_collision_cache(out, geo, dt)


def build_sharded_step(geo, mat, btab, rtab, params, comm: ShardComm | None,
                       n_inner: int = 1, n_outer: int = 1, route=None):
    """run(state) -> (state, outputs) on this rank's shard
    (nanokappa_tpu/parallel/sharding.py build_sharded_step :85): the port's
    block runner (sim/step.py make_v2_block_runner: the lifetime refresh,
    the compaction cadence, one ledger reset a block) around the v2 or the
    v1 step with `comm` threaded in, so each step's sums are added up over
    the ranks in one all-reduce; `route` is the configuration's
    (sim/fused.py build_route, built here when not given). params.n_shards
    must equal comm.size; outputs are replicated. `comm=None` is sim/step.py
    build_step."""
    from nanokappa_torch.sim.fused import build_route
    from nanokappa_torch.sim.step import make_step, make_v2_block_runner

    S = 1 if comm is None else comm.size
    if params.n_shards != S:
        raise ValueError(f"params.n_shards = {params.n_shards}, the particle group has {S} ranks")
    route = route or build_route(geo, btab, params, mat)
    step = make_step(geo, mat, btab, rtab, params, comm, route=route)
    return make_v2_block_runner(geo, mat, btab, params, step, n_inner, n_outer, route)


def build_ensemble_step(geo, mat, btab, rtab, params, particle: ShardComm,
                        replica: ShardComm, n_inner: int = 1):
    """run(state) -> (state, outputs) of one replica's particle shard
    (nanokappa_tpu/parallel/sharding.py build_ensemble_step :210): the
    particle sums reduce over the replica's particle group only, so each
    replica is an independent chain (its own T_sv); the StepOutputs come
    back on every rank with a leading replica axis, through one all-reduce
    over the replica axis at readout (each replica's row, zero elsewhere).
    params.n_shards must equal the particle group's size."""
    from nanokappa_torch.sim.step import StepOutputs

    run_local = build_sharded_step(geo, mat, btab, rtab, params, particle, n_inner)

    def run(state: SimState):
        state, out = run_local(state)
        fs = [getattr(out, f.name) for f in fields(StepOutputs)]
        row = torch.cat([t.reshape(-1).to(torch.float64) for t in fs])
        rows = torch.zeros((replica.size, row.numel()), dtype=torch.float64, device=row.device)
        rows[replica.rank] = row
        replica.allreduce_sum_(rows)
        parts, o = {}, 0
        for f, t in zip(fields(StepOutputs), fs):
            parts[f.name] = rows[:, o:o + t.numel()].reshape((replica.size,) + tuple(t.shape)).to(t.dtype)
            o += t.numel()
        return state, StepOutputs(**parts)

    return run


def stack_ensemble_state(states: list[SimState], particle: ShardComm,
                         replica: ShardComm, geo, dt: float) -> SimState:
    """This rank's shard of its replica's state (nanokappa_tpu/parallel/
    sharding.py stack_ensemble_state :297): `states` holds one global
    state a replica, each built with its own seed so the chains are
    independent; the rank keeps its replica's segment (shard_state)."""
    if len(states) != replica.size:
        raise ValueError(f"{len(states)} states for {replica.size} replicas")
    return shard_state(states[replica.rank], particle, geo, dt)
