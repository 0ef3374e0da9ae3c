"""The k model's degenerate split on partners that differ in velocity,
against the JAX v1 step on the CPU.

The synthetic material's degenerate branches share frequency and
velocity, so the split (a specular lane whose outgoing mode has an
equal-frequency partner branch takes it with probability 1/2,
nanokappa_tpu/sim/cascade.py:590-594) changes no trajectory on it. Here
tests/torch_parity.py:split_velocity slows the second branch of every
pair to 0.6 of its speed (the 6^3 table's 434 pairs), so each swap
changes the lane's speed. The bench film's box, reservoirs and eta = 0
walls under the k model, whose 6^3 map covers too few wall-incident modes
for the mirror path: kernel A's in-kernel-diffuse branch flags the
specular winners, and the narrow rounds split them. From one initial
state, 200 steps of the port's fused step and of the JAX v1 step: the
mean T_sv of each slice and the mean kappa over steps 100-200 agree within
5 standard errors of their difference (the standard errors of 10-step
block means; tests/torch_parity.py:assert_drivers_agree's rule), and the
port's split swapped lanes to partners of another speed.
"""

import dataclasses

import numpy as np
import pytest

from torch_parity import FILM, build_pair, np_, split_velocity


STEPS = 200


@pytest.fixture(scope="module")
def kfilm_split():
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
    from nanokappa_tpu.sim.reservoir import build_reservoir_tables as j_rt
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.reservoir import build_reservoir_tables

    j, t = build_pair(FILM, mesh=(6, 6, 6), n_p=6000, n_cap=8192)
    j.mat, t.mat = split_velocity(j.mat), split_velocity(t.mat)
    j.tabs, t.tabs = j.mat.device_tables(), t.mat.device_tables("cpu")
    j.btab, t.btab = j_bt(j.mat, j.dom, "k"), build_boundary_tables(t.mat, t.dom, "k", device="cpu")
    rho = t.params.particle_density
    j.rtab, t.rtab = j_rt(j.mat, j.dom, 1.0, rho), build_reservoir_tables(t.mat, t.dom, 1.0, rho, device="cpu")
    j.params = dataclasses.replace(j.params, scat_model="k")
    t.params = dataclasses.replace(t.params, scat_model="k")
    return j, t


def test_crafted_partners_differ_in_velocity(kfilm_split):
    j, t = kfilm_split
    dp = np_(t.btab.degen_partner)
    assert np.array_equal(dp, np.asarray(j.btab.degen_partner))
    has = np.nonzero(dp >= 0)[0]
    ov = np_(t.tabs.omega_vel).astype(np.float64)
    speed = np.linalg.norm(ov[:, 1:4], axis=1)
    np.testing.assert_array_equal(ov[has, 0], ov[dp[has], 0])  # still degenerate
    moving = speed[has] > 0
    ratio = speed[dp[has]][moving] / speed[has][moving]
    assert len(ratio) > 100 and np.all(np.isclose(ratio, 0.6) | np.isclose(ratio, 1 / 0.6))


def test_split_on_differing_partners_matches_jax_v1(kfilm_split):
    import jax

    from nanokappa_tpu.sim.state import SimParams as JParams, SimState as JState
    from nanokappa_tpu.sim.step import make_step
    from nanokappa_torch.convert import state_to_jax
    from nanokappa_torch.sim.fused import dkern_active, mirror_eligible
    from nanokappa_torch.sim.kappa import kappa_slice
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    j, t = kfilm_split
    assert not mirror_eligible(t.geo, t.btab, t.params, t.tabs)
    assert dkern_active(t.geo, t.btab, t.params, t.tabs)
    state = init_state(t.mat, t.dom, t.geo, t.params, t.n_p, t.btab, temp_dist="linear", seed=5)
    d = state_to_jax(state)
    dead = np.nonzero(np_(state.pool[14]) < 0.5)[0].astype(np.int32)
    d["free_list"][: len(dead)] = dead  # the v1 step injects into free slots
    d["free_count"] = np.array([len(dead)], np.int32)
    js = JState(**{k: jax.numpy.asarray(v) for k, v in d.items()}, key=jax.random.PRNGKey(5))
    state, out = build_step(t.geo, t.tabs, t.btab, t.rtab, t.params, n_inner=1, n_outer=STEPS)(state)
    jparams = JParams(step_impl="v1", **{f.name: getattr(j.params, f.name) for f in dataclasses.fields(j.params)
                                          if f.name != "step_impl"})
    step = jax.jit(make_step(j.geo, j.tabs, j.btab, j.rtab, jparams))
    res_T, L = np.array([302.0, 298.0]), 2e3
    T_j, k_j, k_t = [], [], []
    for k in range(STEPS):
        js, jo = step(js)
        T_j.append(np.asarray(jo.T_sv))
        k_j.append(kappa_slice(np.asarray(jo.T_sv), np.asarray(jo.phi_sv), np.asarray(jo.Np_sv), res_T, L, 0)[1])
        k_t.append(kappa_slice(np_(out.T_sv[k]), np_(out.phi_sv[k]), np_(out.Np_sv[k]), res_T, L, 0)[1])
        assert int(jo.lost) == 0
    assert int(out.lost[-1]) == 0

    def blocks(x):
        b = np.asarray(x, np.float64)[STEPS // 2:].reshape(-1, 10, *np.shape(x)[1:]).mean(1)
        return b.mean(0), b.std(0, ddof=1) / np.sqrt(len(b))

    for name, a, b in (("T_sv", T_j, np_(out.T_sv)), ("kappa", k_j, k_t)):
        (mj, sj), (mt, st) = blocks(a), blocks(b)
        print(f"{name}: JAX v1 {np.round(mj, 4)} +- {np.round(sj, 4)}, port {np.round(mt, 4)} +- {np.round(st, 4)}")
        assert np.all(np.abs(mj - mt) <= 5.0 * np.hypot(sj, st)), (name, mj, mt, sj, st)
    T = np_(out.T_sv[-1])
    assert np.all((T > 298.0) & (T < 302.0)) and T[0] > T[-1]
    assert int(state.kernel_events[2]) > 100  # the narrow rounds' degenerate swaps
