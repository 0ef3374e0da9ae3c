"""Particle-axis sharding of the port (nanokappa_torch/parallel) on the CPU
over gloo, against the JAX package's (nanokappa_tpu/parallel/sharding.py):
the initial shards against JAX init_state + shard_state through convert.py,
one_to_one's split, one shard through a ShardComm bit for bit against the
unsharded step (v2 and v1), and two spawned ranks (started once for the
file) on the film at 16,000 particles for 20 x 10 steps beside the port's
one-shard run and JAX build_sharded_step on 2 of conftest's 8 virtual
devices, then the escape repair on two ranks (tests/test_sharding.py:112)."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import FILM, assert_same, build_pair, jax_fields, np_
from torch_shard_ranks import film_two_shards, one_shard_film, port_film, start_ranks, world_of_one

N_P, N_CAP, BLOCKS = 16000, 32768, 20


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank film run and the port's one-shard film, each spawned once
    and side by side, while this process runs JAX build_sharded_step on 2
    devices."""
    out = tmp_path_factory.mktemp("shards")
    waits = [
        start_ranks(film_two_shards, 2, str(out), N_P, N_CAP, 4, BLOCKS),
        start_ranks(one_shard_film, 1, str(out), N_P, N_CAP, 3, BLOCKS),
    ]
    ref = dict(jax=jax_two_shards())
    for wait in waits:
        wait(120)
    ref["one"] = np.load(out / "one.npz")["T_sv"]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    return ranks, ref


def jax_two_shards():
    """JAX build_sharded_step on 2 virtual devices, the same film (its XLA
    step: the Pallas kernels would run in interpret mode), seed 4."""
    import jax

    from nanokappa_tpu.geometry.device import build_device_geometry
    from nanokappa_tpu.geometry.domain import build_domain
    from nanokappa_tpu.material import synthetic_material
    from nanokappa_tpu.parallel import build_sharded_step, make_particle_mesh, shard_state
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables
    from nanokappa_tpu.sim.reservoir import build_reservoir_tables
    from nanokappa_tpu.sim.state import SimParams, init_state
    from torch_parity import FILM_FULL

    assert len(jax.devices()) >= 2
    t = port_film(N_P, N_CAP, 2)
    mat = synthetic_material(mesh=(6, 6, 6))
    dom = build_domain(**FILM_FULL)
    p = t.params
    params = SimParams(dt=p.dt, n_cap=p.n_cap, inj_cap=p.inj_cap, particle_density=p.particle_density,
                       n_active_modes=p.n_active_modes, t_reference=p.t_reference, n_shards=2,
                       step_impl="v1")
    geo = build_device_geometry(dom)
    mesh = make_particle_mesh(2)
    state = shard_state(init_state(mat, dom, geo, params, t.n_p, temp_dist="linear", seed=4), mesh)
    run = build_sharded_step(geo, mat.device_tables(), build_boundary_tables(mat, dom),
                             build_reservoir_tables(mat, dom, p.dt, p.particle_density),
                             params, mesh, n_inner=10)
    for _ in range(BLOCKS):
        state, out = run(state)
    return np.asarray(out.T_sv)


def test_two_ranks_match_one_shard_and_jax(two_ranks):
    ranks, ref = two_ranks
    T = ranks[0]["out_T_sv"]
    assert np.abs(T - ref["one"]).max() < 0.35, (T, ref["one"])
    assert np.abs(T - ref["jax"]).max() < 0.35, (T, ref["jax"])
    assert np.all((T > 298.0) & (T < 302.0)) and T[0] > T[-1], T
    # population within 10% of the one-shard run's target, nothing lost
    assert abs(int(ranks[0]["out_N_p"]) - N_P) < 0.1 * N_P
    assert int(ranks[0]["out_lost"]) == 0
    # one all-reduce a step
    assert int(ranks[0]["calls"]) == int(ranks[1]["calls"]) == 10 * BLOCKS


def test_two_ranks_outputs_replicated_and_draws_differ(two_ranks):
    ranks, _ = two_ranks
    for k in ranks[0]:
        if k.startswith("out_"):
            assert_same(ranks[0][k], ranks[1][k], k)
    assert ranks[0]["step_seed"] != ranks[1]["step_seed"]
    assert not np.array_equal(ranks[0]["uniform"], ranks[1]["uniform"])


def test_two_ranks_escape_repair(two_ranks):
    ranks, _ = two_ranks
    assert all(int(r["n_mine"]) > 0 for r in ranks)  # every shard got some
    assert sum(int(r["n_esc"]) for r in ranks) == int(ranks[0]["n_pushed"]) == 200
    assert all(int(r["n_esc_total"]) == 200 for r in ranks)
    for r in ranks:
        lo, hi = r["bounds"]
        assert np.all(r["healed"] >= lo - 1.0) and np.all(r["healed"] <= hi + 1.0)
        assert np.all(r["healed_cf"] >= 0)  # collision cache rebuilt
        assert int(r["after_N_p"]) > 0 and int(r["after_lost"]) == 0


@pytest.fixture(scope="module")
def pair():
    return build_pair(FILM, mesh=(4, 4, 4), n_p=3000, n_cap=8192)


def test_shard_state_matches_jax_shards(pair):
    """Two shards of the port's host-built film concatenate to the one-shard
    init's lanes; against JAX init_state + shard_state at n_shards = 2
    (convert.py shards_from_jax): the same segments, the JAX local free
    lists are the segments' dead lanes, the same tails and accumulators."""
    import jax

    from nanokappa_tpu.parallel import make_particle_mesh, shard_state as j_shard
    from nanokappa_tpu.sim.state import init_state as j_init
    from nanokappa_torch.convert import shards_from_jax
    from nanokappa_torch.parallel import ShardComm, shard_state
    from nanokappa_torch.sim.state import C_ALIVE, init_state

    j, t = pair
    tp = dataclasses.replace(t.params, n_shards=2)
    jp = dataclasses.replace(j.params, n_shards=2)
    init = dict(temp_dist="linear", seed=3)
    one = init_state(t.mat, t.dom, t.geo, t.params, t.n_p, t.btab, **init)
    host = init_state(t.mat, t.dom, t.geo, tp, t.n_p, t.btab, host_only=True, **init)
    shards = [shard_state(host, ShardComm(r, 2, torch.device("cpu")), t.geo, tp.dt) for r in range(2)]
    assert_same(torch.cat([s.pool for s in shards], 1), one.pool, "pool")

    jstate = j_shard(j_init(j.mat, j.dom, j.geo, jp, j.n_p, btab=j.btab, **init),
                     make_particle_mesh(2, jax.devices()[:2]))
    d = jax_fields(jstate)
    conv = shards_from_jax(d, "slim", device="cpu", seed=3, v1=True)
    n = 4096
    for r, (s, c) in enumerate(zip(shards, conv)):
        assert_same(s.pool, c.pool, f"pool[{r}]")
        # the JAX shard's own rows, as its device holds them
        packed_r = np.asarray(jstate.packed.addressable_shards[r].data)
        assert_same(np_(s.pool[:16]).T, packed_r, f"jax shard {r}")
        dead = np.nonzero(np_(s.pool[C_ALIVE]) < 0.5)[0]
        fc = int(d["free_count"][r])
        assert fc == len(dead)
        assert np.array_equal(np.sort(d["free_list"][r * n : r * n + fc]), dead)
        assert s.tail == c.tail == int(np.nonzero(np_(s.pool[C_ALIVE]) > 0.5)[0][-1]) + 1
        assert_same(s.res_counter, c.res_counter, "res_counter")
        assert_same(s.res_counter[0], host.res_counter[r], "res_counter row")
        for name in ("T_sv", "Np_sv", "T_tau", "n_leaving", "lost", "frozen"):
            assert_same(getattr(s, name), getattr(c, name), name)
        assert s.gen.initial_seed() == c.gen.initial_seed()
    assert shards[0].gen.initial_seed() == 3 != shards[1].gen.initial_seed()


def test_one_to_one_split_matches_jax(pair):
    """one_to_one_share is JAX's split (nanokappa_tpu/sim/reservoir.py:
    293-297), shard by shard, and the parts add up to n_leaving; JAX
    sample_injections on shard 1 of 3 draws the same number of valid lanes
    as the port's on the same n_leaving."""
    import jax
    import jax.numpy as jnp

    from nanokappa_tpu.sim.reservoir import sample_injections as j_sample
    from nanokappa_torch.sim.reservoir import one_to_one_share, sample_injections

    n = np.arange(0, 50, dtype=np.int32)
    for S in (1, 2, 3, 4, 7):
        parts = [one_to_one_share(torch.as_tensor(n), r, S).numpy() for r in range(S)]
        for r, part in enumerate(parts):
            want = n // S + (jnp.asarray(r, jnp.int32) < n % S).astype(jnp.int32)
            np.testing.assert_array_equal(part, np.asarray(want))
        np.testing.assert_array_equal(np.sum(parts, 0), n)

    j, t = pair
    jp = dataclasses.replace(j.params, n_shards=3, res_gen="one_to_one")
    tp = dataclasses.replace(t.params, n_shards=3, res_gen="one_to_one")
    leaving = np.array([37, 8], np.int32)
    js = dataclasses.replace(j.state, n_leaving=jnp.asarray(leaving))
    jout = jax.jit(lambda s, k: j_sample(s, j.geo, j.tabs, j.rtab, jp, k, 1))(js, jax.random.PRNGKey(0))
    tout = sample_injections(t.state.res_counter, t.geo, t.rtab, tp, torch.Generator(),
                             torch.as_tensor(leaving), shard=1)
    assert int(jout[1]) == tout[1] == sum(int(x) for x in one_to_one_share(leaving, 1, 3))


@pytest.mark.parametrize("step_impl", ["v2", "v1"])
def test_one_shard_comm_is_the_unsharded_step(step_impl, tmp_path):
    """A gloo world of one through ShardComm (one float64 all-reduce a step)
    runs the unsharded step bit for bit for 10 steps: v2, and the film
    forced onto v1 (step_impl='v1', the plain pool)."""
    import torch.distributed as dist

    from nanokappa_torch.parallel import build_sharded_step, shard_state
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    f = port_film(3000, 4096, 1, mesh=(4, 4, 4), res_gen="pooled", step_impl=step_impl)
    kw = dict(temp_dist="linear", seed=3)
    ref = init_state(f.mat, f.dom, f.geo, f.params, f.n_p, f.btab, **kw)
    assert ref.layout == ("slim" if step_impl == "v2" else "plain")
    comm = world_of_one(str(tmp_path / "rdv"))
    try:
        host = init_state(f.mat, f.dom, f.geo, f.params, f.n_p, f.btab, host_only=True, **kw)
        mine = shard_state(host, comm, f.geo, f.params.dt)
        run0 = build_step(f.geo, f.tabs, f.btab, f.rtab, f.params, n_inner=5, n_outer=2)
        run1 = build_sharded_step(f.geo, f.tabs, f.btab, f.rtab, f.params, comm, n_inner=5, n_outer=2)
        ref, o0 = run0(ref)
        mine, o1 = run1(mine)
        calls = comm.calls
    finally:
        dist.destroy_process_group()
    assert calls == 10
    assert_same(o1, o0, "outputs")
    assert_same(mine.pool, ref.pool, "pool")
    assert mine.tail == ref.tail
