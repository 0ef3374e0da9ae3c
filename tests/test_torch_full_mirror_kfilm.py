"""The k film on the full mirror path against the JAX v1 step, on
tests/torch_parity.py:craft_kmirror's tables (the k model's degenerate
partners and diffuse weights, the exact crystal mirror as correspondence:
at this grid the k map itself covers too few wall-incident modes for the
mirror gate).

  * The split drawn at cache fill: among the alive lanes whose mirror
    partner has a degenerate branch, the share whose cache took the branch
    is 1/2 within 4 standard deviations (binomial), at initialisation and
    at the narrow machinery's refill (sim/fused.py mirror_rows on the
    run's rows, uniforms from a torch Generator).
  * From one initial state (the bench film's T/T/R/R/P walls, pooled
    reservoirs), 30 steps of the port's fused step on the 24-row pool and
    of the JAX v1 step, which splits at every specular event: their
    T_sv averaged over the last 15 steps agree within 0.35 K (the Monte
    Carlo bound of tests/test_kmodel_mirror.py::test_kmodel_v1_v2_parity),
    nothing is lost and the populations stay within 5% of each other.
"""

import dataclasses

import numpy as np

from torch_parity import FILM, kmirror_pair, np_, split_share


def within_4_sigma(n: int, k: int) -> bool:
    return n > 0 and abs(k - n / 2) <= 4 * np.sqrt(n / 4)


def test_kfilm_full_mirror_matches_jax_v1():
    import jax

    from nanokappa_tpu.sim.state import SimParams as JParams, SimState as JState
    from nanokappa_tpu.sim.step import make_step
    from nanokappa_torch.convert import state_to_jax
    from nanokappa_torch.sim.step import build_step

    j, t = kmirror_pair(FILM, n_p=6000, n_cap=8192, seed=5)
    state = t.state
    assert state.layout == "full"
    n, k = split_share(state, t.btab, t.tabs)
    assert within_4_sigma(n, k), (n, k)

    d = state_to_jax(state)
    dead = np.nonzero(np_(state.pool[14]) < 0.5)[0].astype(np.int32)
    d["free_list"][: len(dead)] = dead  # the v1 step injects into free slots
    d["free_count"] = np.array([len(dead)], np.int32)
    js = JState(**{k: jax.numpy.asarray(v) for k, v in d.items()}, key=jax.random.PRNGKey(5))
    n_steps, tail = 30, 15
    run = build_step(t.geo, t.tabs, t.btab, t.rtab, t.params, n_inner=1, n_outer=n_steps)
    state, out = run(state)
    jparams = JParams(step_impl="v1", **{f.name: getattr(j.params, f.name) for f in dataclasses.fields(j.params)
                                          if f.name != "step_impl"})
    step = jax.jit(make_step(j.geo, j.tabs, j.btab, j.rtab, jparams))
    T_jax = []
    for _ in range(n_steps):
        js, jo = step(js)
        T_jax.append(np.asarray(jo.T_sv))
    assert int(jo.lost) == 0 and int(out.lost[-1]) == 0
    assert abs(int(out.N_p[-1]) - int(jo.N_p)) <= 0.05 * int(jo.N_p)
    T_port = np_(out.T_sv[-tail:]).mean(axis=0)
    dT = np.abs(T_port - np.mean(T_jax[-tail:], axis=0)).max()
    assert dT < 0.35, (dT, T_port)

    # the refill's split: fresh caches for the run's alive rows
    import torch

    from nanokappa_torch.sim.binning import subvol_id
    from nanokappa_torch.sim.boundary_tables import combined_mirror_rows
    from nanokappa_torch.sim.fused import mirror_rows

    rows = state.pool[:16, state.alive]
    mtab = torch.as_tensor(combined_mirror_rows(t.btab, t.tabs))
    u = torch.rand(rows.shape[1], generator=torch.Generator().manual_seed(11))
    mrows, _ = mirror_rows(t.btab, t.tabs, mtab, rows, state.T_sv, subvol_id(t.geo, rows[0:3].T), u)
    refilled = dataclasses.replace(state, pool=torch.cat([rows, mrows]))
    n, k = split_share(refilled, t.btab, t.tabs)
    assert within_4_sigma(n, k), (n, k)
