"""The full 24-row mirror layout's host side against the JAX package.

  * init_state on "full" is bit-equal to the JAX init's packed rows plus
    its (N, 8) mirror cache, for the velocity film with the slim gate
    turned off in both packages and for the k film on
    tests/torch_parity.py:craft_kmirror's tables (the degenerate split drawn
    with the same NumPy draws in the same place: the reservoir phase drawn
    after it is bit-equal too);
  * convert.py round-trips a full pool to the JAX arrays and back bit for
    bit;
  * the lifetime refresh after a temperature jump across grid bins
    (refresh_tau_T: the slope pairs of the main mode and of the cached
    partner) to float32 rounding (rtol 1e-6), and the pending deferred RTA
    (make_finalize, slope form from row 22) to 2e-6 of the occupations'
    scale (float32 exp/expm1 rounding in two frameworks).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import CLOSED_FILM, FILM, assert_bits, build_pair, jax_fields, kmirror_pair, np_


@pytest.fixture
def no_slim(monkeypatch):
    import nanokappa_torch.sim.fused as t_fused
    import nanokappa_tpu.sim.boundary_tables as j_bt

    monkeypatch.setattr(t_fused, "slim_mirror_axis", lambda *a, **k: None)
    monkeypatch.setattr(j_bt, "slim_mirror_axis", lambda *a, **k: None)


@pytest.mark.parametrize("case", ["velocity", "k"])
def test_init_full_bit_equal(case, request):
    from nanokappa_torch.convert import state_from_jax

    if case == "velocity":
        request.getfixturevalue("no_slim")
        j, t = build_pair(FILM, mesh=(6, 6, 6))
    else:
        j, t = kmirror_pair(FILM)
    assert t.state.layout == "full"
    ref = state_from_jax(jax_fields(j.state), "full", device="cpu")
    assert_bits(t.state.pool, ref.pool, "pool")
    np.testing.assert_array_equal(t.state.res_counter, ref.res_counter)
    xm = np_(t.state.pool[16]).view(np.int32)
    alive = np_(t.state.pool[14]) > 0.5
    assert (xm[alive] >= 0).mean() > 0.5 and (xm[~alive] == -1).all()


def test_convert_full_round_trip():
    from nanokappa_torch.convert import state_from_jax, state_to_jax

    j, _ = kmirror_pair(FILM, mesh=(4, 4, 4))
    d = jax_fields(j.state)
    back = state_to_jax(state_from_jax(d, "full", device="cpu"))
    for k in ("packed", "mirror", "T_sv", "res_counter"):
        assert_bits(back[k], d[k], k)


def test_full_refresh_and_finalize_match_jax():
    import jax.numpy as jnp

    from nanokappa_tpu.sim.fused import (
        from_transposed, make_finalize as j_final, refresh_tau_T as j_refresh,
        to_transposed,
    )
    from nanokappa_torch.convert import state_from_jax
    from nanokappa_torch.sim.fused import make_finalize, refresh_tau_T

    j, t = kmirror_pair(CLOSED_FILM, mesh=(4, 4, 4), temp_dist="custom",
                        subvol_temp=(299.0, 299.5, 300.0, 300.5, 301.0))
    js = dataclasses.replace(j.state, step=jnp.asarray(1, jnp.int32))
    ts = state_from_jax(jax_fields(js), "full", device="cpu")
    jf = np.asarray(j_final(j.geo, j.tabs, j.params, btab=j.btab)(js).dev)
    tf = np_(make_finalize(t.geo, t.tabs, t.params)(ts).dev)
    np.testing.assert_allclose(tf, jf, rtol=2e-6, atol=2e-6 * np.abs(jf).max())
    assert np.abs(tf - np_(ts.dev)).max() > 0  # the RTA did act

    T_new = np.array([281.0, 295.0, 300.0, 305.0, 319.0], np.float32)
    jT = dataclasses.replace(to_transposed(js, combined=True), T_sv=jnp.asarray(T_new))
    jr = from_transposed(j_refresh(jT, j.geo, j.tabs, j.params, use_mirror=True))
    ts.T_sv = torch.as_tensor(T_new)
    before = ts.pool.clone()
    refresh_tau_T(ts, t.geo, t.tabs, t.params)
    alive = np.asarray(jr.alive)
    jm = np.asarray(jr.mirror)
    for got, want in ((ts.tau, np.asarray(jr.tau)), (ts.pool[21], jm[:, 5]),
                      (ts.pool[22], jm[:, 6]), (ts.pool[23], jm[:, 7])):
        np.testing.assert_allclose(np_(got)[alive], want[alive], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[alive]).max())
    assert not torch.equal(ts.pool[22], before[22])  # the slopes moved bins
