"""The whole fused step on the full 24-row mirror layout against the JAX
v2 step: the eta = 0 film without reservoirs (P/R/R/P) with the slim gate
turned off in both packages, from one converted initial state with a
temperature gradient, 4 steps (tests/test_torch_slice.py's deterministic
check on the slim layout). Lanes without a mirror partner still diffuse
with per-lane draws, so the tolerances are those of
tests/test_fused.py::test_v2_full_mirror_matches_v1: T_sv to rtol 1e-4,
Np_sv to 3 particles, nothing lost."""

import numpy as np

from torch_parity import CLOSED_FILM, build_pair, jax_fields, np_


def test_full_step_matches_jax_v2(monkeypatch):
    import jax

    import nanokappa_torch.sim.fused as t_fused
    import nanokappa_tpu.sim.boundary_tables as j_bt
    from nanokappa_tpu.sim.step import make_step
    from nanokappa_torch.convert import state_from_jax
    from nanokappa_torch.sim.step import build_step

    monkeypatch.setattr(t_fused, "slim_mirror_axis", lambda *a, **k: None)
    monkeypatch.setattr(j_bt, "slim_mirror_axis", lambda *a, **k: None)
    j, t = build_pair(
        CLOSED_FILM, temp_dist="custom", subvol_temp=(299.0, 299.5, 300.0, 300.5, 301.0),
    )
    assert t_fused.build_route(t.geo, t.btab, t.params, t.tabs).layout == "full"
    state = state_from_jax(jax_fields(j.state), "full", device="cpu", seed=3)
    run = build_step(t.geo, t.tabs, t.btab, t.rtab, t.params, n_inner=1, n_outer=4)
    _, out = run(state)

    step = jax.jit(make_step(j.geo, j.tabs, j.btab, j.rtab, j.params))
    js = j.state
    for k in range(4):
        js, jo = step(js)
        np.testing.assert_allclose(np_(out.T_sv[k]), np.asarray(jo.T_sv), rtol=1e-4, err_msg=f"T_sv step {k}")
        np.testing.assert_allclose(np_(out.Np_sv[k]), np.asarray(jo.Np_sv), atol=3, err_msg=f"Np_sv step {k}")
        assert int(out.lost[k]) == 0 and int(jo.lost) == 0
    assert int(out.N_p[-1]) == j.n_p  # closed box: every particle stays
