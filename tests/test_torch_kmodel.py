"""The k (wavevector) boundary model off the mirror path, against the JAX
package.

  * The degenerate-branch split (nanokappa_tpu/sim/cascade.py:590-594): a
    specular lane whose outgoing mode has an equal-frequency partner branch
    swaps to it when the round's fourth uniform is >= 1/2. On a buffer of
    lanes arriving at the film's eta = 0 wall (specularity 1 wherever the k
    map has a partner), the swap fraction among them passes a chi-square
    test against 1/2 (p > 0.001), every swapped lane carries the partner's
    table row, and the swaps are counted.
  * The k film under linear temperatures (the synthetic 6^3 grid's k map
    covers too few wall-incident modes for the mirror gate, so kernel A's
    in-kernel diffuse branch runs, its specular winners flagged to the
    narrow machinery that splits them): from one initial state, 4 steps of
    the port's fused step against the JAX v1 step, T_sv within 0.05 K, the
    populations within 30, nothing lost; the port counts swaps.
  * The route (sim/fused.py build_route) admits a k-model configuration
    on the mirror path, on tests/test_kmodel_mirror.py's crafted
    full-coverage involution table, and puts it on the full 24-row mirror
    layout with the split drawn at cache fill (the test keeps the name it
    had while the port refused this configuration).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import FILM, build_pair, np_


@pytest.fixture(scope="module")
def kfilm():
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables

    j, t = build_pair(FILM, mesh=(6, 6, 6))
    j.btab, t.btab = j_bt(j.mat, j.dom, "k"), build_boundary_tables(t.mat, t.dom, "k", device="cpu")
    j.params = dataclasses.replace(j.params, scat_model="k", temp_interp="linear")
    t.params = dataclasses.replace(t.params, scat_model="k", temp_interp="linear")
    return j, t


def test_kmodel_swap_fraction(kfilm):
    from scipy.stats import chi2

    from nanokappa_torch.sim.cascade import run_event_buffer

    _, t = kfilm
    bc, normals = np_(t.geo.facet_bc), np_(t.geo.facet_normal)
    bottom = int(np.nonzero((bc == 3) & (normals[:, 2] < -0.5))[0][0])
    row = int(np_(t.btab.row_of_rough)[np_(t.geo.facet_rough)[bottom]])
    corr = t.btab._host["corr"][row]
    partner = np_(t.btab.degen_partner)
    ov = np_(t.tabs.omega_vel)
    ok = (corr >= 0) & (ov[:, 3] < -1.0)
    ok &= partner[np.clip(corr, 0, None)] >= 0
    modes = np.nonzero(ok)[0]
    assert len(modes) > 10
    E = 20_000
    rng = np.random.default_rng(9)
    mode = modes[rng.integers(0, len(modes), E)].astype(np.int32)
    lo, hi = t.dom.mesh.bounds
    rows = np.zeros((16, E), np.float32)
    rows[0] = rng.uniform(lo[0] + 100, hi[0] - 100, E)
    rows[1] = rng.uniform(lo[1] + 50, hi[1] - 50, E)
    rows[2] = lo[2]
    rows[3:6] = ov[mode, 1:4].T
    rows[6] = ov[mode, 0]
    rows[9] = mode.view(np.float32)
    rows[10] = np.full(E, bottom, np.int32).view(np.float32)
    rows[12] = np.full(E, -1, np.int32).view(np.float32)
    rows[13] = 1e-3  # the lane ends its flight just off the wall
    rows[14] = 1.0
    out, _, _, _, _, swaps = run_event_buffer(
        torch.as_tensor(rows), torch.ones(E, dtype=torch.bool), t.geo, t.tabs, t.btab,
        t.params, torch.Generator().manual_seed(4), torch.full((t.geo.n_subvols,), 300.0), 8,
    )
    new = np_(out[9]).view(np.int32)
    spec, sw = corr[mode], partner[corr[mode]]
    assert np.all((new == spec) | (new == sw))
    n_swap = int((new == sw).sum())
    assert n_swap == int(swaps)
    stat = (n_swap - E / 2) ** 2 / (E / 4)
    assert chi2.sf(stat, 1) > 1e-3, (n_swap, E)
    swapped = new == sw
    np.testing.assert_array_equal(np_(out[6])[swapped], ov[sw[swapped], 0])
    np.testing.assert_array_equal(np_(out[3:6]).T[swapped], ov[sw[swapped], 1:4])


def test_kmodel_film_matches_jax_v1(kfilm):
    import jax

    from nanokappa_tpu.sim.state import SimParams as JParams, SimState as JState
    from nanokappa_tpu.sim.step import make_step
    from nanokappa_torch.convert import state_to_jax
    from nanokappa_torch.sim.fused import build_route, dkern_active, mirror_eligible
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    j, t = kfilm
    assert not mirror_eligible(t.geo, t.btab, t.params, t.tabs)
    assert dkern_active(t.geo, t.btab, t.params, t.tabs)
    route = build_route(t.geo, t.btab, t.params, t.tabs)  # admitted: no raise
    assert (route.step, route.layout, route.dkern, route.k_split) == ("v2", "plain", True, False)
    state = init_state(t.mat, t.dom, t.geo, t.params, t.n_p, t.btab, temp_dist="linear", seed=5)
    d = state_to_jax(state)
    dead = np.nonzero(np_(state.pool[14]) < 0.5)[0].astype(np.int32)
    d["free_list"][: len(dead)] = dead  # the v1 step injects into free slots
    d["free_count"] = np.array([len(dead)], np.int32)
    js = JState(**{k: jax.numpy.asarray(v) for k, v in d.items()}, key=jax.random.PRNGKey(5))
    run = build_step(t.geo, t.tabs, t.btab, t.rtab, t.params, n_inner=1, n_outer=4)
    state, out = run(state)
    jparams = JParams(step_impl="v1", **{f.name: getattr(j.params, f.name) for f in dataclasses.fields(j.params)
                                          if f.name != "step_impl"})
    step = jax.jit(make_step(j.geo, j.tabs, j.btab, j.rtab, jparams))
    for k in range(4):
        js, jo = step(js)
        np.testing.assert_allclose(np_(out.T_sv[k]), np.asarray(jo.T_sv), atol=0.05, err_msg=f"T_sv step {k}")
        assert int(out.lost[k]) == 0 and int(jo.lost) == 0
        assert abs(int(out.N_p[k]) - int(jo.N_p)) < 30
    assert int(state.kernel_events[1]) > 0 and int(state.kernel_events[2]) > 0


def test_require_slice_refuses_the_kmodel_mirror(kfilm):
    from nanokappa_torch.sim.fused import build_route, mirror_eligible

    _, t = kfilm
    M = t.mat.n_modes
    ident = np.tile(np.arange(M, dtype=np.int32), (t.btab.n_rows, 1))
    spec = np.ones_like(t.btab._host["specularity"])
    crafted = dataclasses.replace(
        t.btab, spec2=torch.as_tensor(np.stack([spec, ident.view(np.float32)], axis=-1)),
    )
    object.__setattr__(crafted, "_host", {**t.btab._host, "specularity": spec, "corr": ident})
    assert mirror_eligible(t.geo, crafted, t.params, t.tabs)
    route = build_route(t.geo, crafted, t.params, t.tabs)  # admitted: no raise
    assert route.k_split and route.layout == "full"
