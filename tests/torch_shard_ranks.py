"""Rank functions of the port's sharded tests (tests/test_torch_sharding.py,
tests/test_torch_ensemble.py, tests/test_torch_launch_threads.py), started
by nanokappa_torch.parallel.launch on the CPU over gloo through
start_ranks. A spawned rank imports this module, so it imports torch and
the port only; each rank writes what the test reads into
`<out>/rank<r>.npz`."""

from __future__ import annotations

import multiprocessing
import os
import threading
from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import torch

from torch_parity import FILM_FULL


def start_ranks(fn, n_ranks: int, out_dir: str, *args):
    """launch(fn, n_ranks, out_dir, "gloo", "cpu", out_dir, *args) in a
    thread of this process. The returned wait(seconds) joins it and
    re-raises a rank's error. If the ranks outlive `seconds` it kills every
    process this one has spawned (the ranks of any other start_ranks still
    running too) and fails: a hung rank fails its own tests, and neither
    the suite's clock nor its cores."""
    from nanokappa_torch.parallel.launch import launch

    err = []

    def run():
        try:
            launch(fn, n_ranks, out_dir, "gloo", "cpu", out_dir, *args)
        except Exception as e:  # re-raised by wait, in the test's thread
            err.append(e)

    th = threading.Thread(target=run)
    th.start()

    def wait(seconds: float):
        th.join(timeout=seconds)
        if th.is_alive():
            for p in multiprocessing.active_children():
                p.kill()
            th.join(timeout=30)  # launch sees its ranks die and returns
            raise AssertionError(f"{fn.__name__} on {n_ranks} ranks outlived {seconds} s")
        if err:
            raise err[0]

    return wait


def report_threads(comm, out_dir: str):
    """The torch threads the launcher left this rank."""
    _save(out_dir, comm.rank, threads=np.int64(torch.get_num_threads()))


def port_film(n_p: int, n_cap: int, n_shards: int, mesh=(6, 6, 6), res_gen="constant",
              step_impl="auto"):
    """The film of tests/test_sim_box.py:film_setup (FILM_FULL: 5000 A, 10
    slices, eta = 0 walls, 302 / 298 K) on the port, on the CPU, for
    `n_shards` shards: the injection buffer autosized for one shard."""
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.reservoir import autosize_inj_cap, build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, particle_count

    f = SimpleNamespace()
    f.mat = synthetic_material(mesh=mesh)
    f.dom = build_domain(**FILM_FULL)
    f.n_p, rho = particle_count(("total", n_p), f.mat, f.dom)
    f.rtab = build_reservoir_tables(f.mat, f.dom, 1.0, rho, device="cpu")
    f.params = SimParams(
        dt=1.0, n_cap=n_cap, inj_cap=autosize_inj_cap(f.rtab, n_shards),
        particle_density=rho, n_active_modes=f.mat.n_active_modes, t_reference=300.0,
        res_gen=res_gen, n_shards=n_shards, step_impl=step_impl,
    )
    f.geo = build_device_geometry(f.dom, device="cpu")
    f.btab = build_boundary_tables(f.mat, f.dom, "velocity", device="cpu")
    f.tabs = f.mat.device_tables("cpu")
    return f


def global_state(f, seed: int, host_only: bool = True):
    from nanokappa_torch.sim.state import init_state

    return init_state(f.mat, f.dom, f.geo, f.params, f.n_p, f.btab, temp_dist="linear",
                      seed=seed, host_only=host_only)


def outputs_dict(out) -> dict:
    return {f.name: getattr(out, f.name).numpy() for f in fields(out)}


def _save(out_dir: str, rank: int, **arrays):
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)


def film_two_shards(comm, out_dir: str, n_p: int, n_cap: int, seed: int, blocks: int):
    """The film in comm.size shards for `blocks` x 10 steps, then the escape
    repair (tests/test_sharding.py:112) on a fresh state's shards with 200
    lanes of the global pool pushed far outside."""
    from nanokappa_torch.parallel import build_sharded_step, shard_state
    from nanokappa_torch.sim.fused import step_seed
    from nanokappa_torch.sim.repair import make_contains_check
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, C_POS

    torch.set_num_threads(min(torch.get_num_threads(), 2))  # small ops: more threads only contend
    f = port_film(n_p, n_cap, comm.size)
    state = shard_state(global_state(f, seed), comm, f.geo, f.params.dt)
    g = torch.Generator()
    g.set_state(state.gen.get_state())
    first = dict(step_seed=np.int64(step_seed(state)), uniform=torch.rand(4, generator=g).numpy())
    run = build_sharded_step(f.geo, f.tabs, f.btab, f.rtab, f.params, comm, n_inner=10)
    for _ in range(blocks):
        state, out = run(state)
    res = dict(first, calls=np.int64(comm.calls), tail=np.int64(state.tail),
               **{f"out_{k}": v for k, v in outputs_dict(out).items()})

    # the escape repair on 2 shards: 200 alive lanes of the global pool,
    # spread over it (so every shard gets some), moved far outside the box
    f2 = f
    g2 = global_state(f2, seed + 5)
    alive = np.nonzero(g2.pool[C_ALIVE].numpy() > 0.5)[0]
    idx = alive[:: max(1, len(alive) // 200)][:200]
    g2.pool[C_POS][:, torch.as_tensor(idx)] = 1e6
    s2 = shard_state(g2, comm, f2.geo, f2.params.dt)
    n = s2.pool.shape[1]
    mine = idx[(idx >= comm.rank * n) & (idx < (comm.rank + 1) * n)] - comm.rank * n
    interior = f2.dom.mesh.sample_volume(1 << 10, np.random.default_rng(1))
    check = make_contains_check(f2.geo, torch.as_tensor(interior, dtype=torch.float32), f2.params.dt)
    s2, n_esc = check(s2, torch.Generator().manual_seed(comm.rank))
    (n_total,) = comm.reduce_sums(n_esc)
    live = s2.pool[C_ALIVE] > 0.5
    healed = s2.pool[C_POS][:, live].T.numpy()
    cf = s2.pool[C_CF].contiguous().view(torch.int32).numpy()[mine]
    run2 = build_sharded_step(f2.geo, f2.tabs, f2.btab, f2.rtab, f2.params, comm, n_inner=2)
    s2, out2 = run2(s2)
    _save(out_dir, comm.rank, **res, n_pushed=np.int64(len(idx)), n_mine=np.int64(len(mine)),
          n_esc=np.int64(int(n_esc)), n_esc_total=np.int64(int(n_total)), healed=healed,
          healed_cf=cf, bounds=f2.dom.mesh.bounds, after_N_p=out2.N_p.numpy(),
          after_lost=out2.lost.numpy())


def ensemble(comm, out_dir: str, n_replicas: int, n_shards: int, n_p: int, n_cap: int,
             calls: int, n_inner: int):
    """n_replicas independent chains of the film, each over n_shards ranks
    (tests/test_sharding.py:59): the world's comm is regrouped into the
    particle groups and the replica axis."""
    from nanokappa_torch.parallel import (
        build_ensemble_step, make_ensemble_groups, stack_ensemble_state,
    )

    particle, replica = make_ensemble_groups(n_replicas, n_shards, "cpu")
    f = port_film(n_p, n_cap, n_shards)
    states = [global_state(f, 100 + i) for i in range(n_replicas)]
    state = stack_ensemble_state(states, particle, replica, f.geo, f.params.dt)
    run = build_ensemble_step(f.geo, f.tabs, f.btab, f.rtab, f.params, particle, replica,
                              n_inner=n_inner)
    for _ in range(calls):
        state, out = run(state)
    _save(out_dir, comm.rank, replica=np.int64(replica.rank), shard=np.int64(particle.rank),
          **outputs_dict(out))


def one_shard_film(comm, out_dir: str, n_p: int, n_cap: int, seed: int, blocks: int):
    """The port's unsharded film (build_step, no collective) for `blocks` x
    10 steps, in a rank of its own so that it runs beside the sharded one:
    its T_sv into `<out>/one.npz`."""
    from nanokappa_torch.sim.step import build_step

    torch.set_num_threads(min(torch.get_num_threads(), 2))
    f = port_film(n_p, n_cap, 1)
    state = global_state(f, seed, host_only=False)
    run = build_step(f.geo, f.tabs, f.btab, f.rtab, f.params, n_inner=10)
    for _ in range(blocks):
        state, out = run(state)
    np.savez(os.path.join(out_dir, "one.npz"), T_sv=out.T_sv.numpy())


def world_of_one(store: str):
    """A gloo world of one process (this one) and its ShardComm."""
    import torch.distributed as dist

    from nanokappa_torch.parallel import make_particle_group

    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    return make_particle_group(1, "cpu")
