"""Deterministic physics primitives of the port against the JAX package on
the same seeded inputs: Bose-Einstein occupation differences, the E <-> T
lookups, subvolume ids, particle energies, the slope-form lifetimes and the
box ray cast.

Tolerances: ints exact; floats to float32 rounding (rtol 1e-6: the two
frameworks may round expm1/exp/division differently by an ulp). An
occupation DIFFERENCE n0(T) - n0(T_ref) cancels near T_ref, so an ulp of its
operands is held against the operands' size: 4 eps (n0(T) + n0(T_ref)). The
kernel occupation twin is held to the JAX kernel's Taylor expm1 at 2e-5
(ops/kmath.py expm1k differs from expm1 by up to ~2e-5 relative).
"""

import numpy as np
import pytest
import torch

from torch_parity import FILM, build_pair, np_

RTOL = 1e-6  # float32 rounding: an ulp or two of 6e-8 each, accumulated
EPS = float(np.finfo(np.float32).eps)


def occ_scale(T, omega, T2=300.0, om2=None):
    """n0(T, omega) + n0(T2, om2) in float64: the size of the operands of an
    occupation difference."""
    from nanokappa_torch.material.tables import bose_einstein

    om2 = omega if om2 is None else om2
    return np.abs(bose_einstein(T, omega)) + np.abs(bose_einstein(T2, om2))


@pytest.fixture(scope="module")
def pair():
    return build_pair(FILM)


def _omega_T(rng, n, mat):
    om = np.asarray(mat.omega).reshape(-1)
    omega = rng.choice(om, n).astype(np.float32)
    omega[:5] = [0.0, -1.0, 1e-3, 200.0, 0.5]  # masked and extreme lanes
    T = rng.uniform(250.0, 350.0, n).astype(np.float32)
    T[5:8] = [0.0, -5.0, 1.0]
    return omega, T


def test_bose_occupation_deltas(pair):
    import jax.numpy as jnp

    from nanokappa_tpu.sim import bose as jb
    from nanokappa_torch.sim import bose as tb

    j, t = pair
    rng = np.random.default_rng(1)
    omega, T = _omega_T(rng, 4000, t.mat)
    om2 = np.roll(omega, 7)
    a = np.asarray(jb.occupation_delta_T(jnp.asarray(T), 300.0, jnp.asarray(omega)))
    b = np_(tb.occupation_delta_T(torch.as_tensor(T), 300.0, torch.as_tensor(omega)))
    assert (np.abs(b - a) <= RTOL * np.abs(a) + 4 * EPS * occ_scale(T, omega)).all()
    a = np.asarray(jb.occupation_delta_omega(300.0, jnp.asarray(omega), jnp.asarray(om2)))
    b = np_(tb.occupation_delta_omega(300.0, torch.as_tensor(omega), torch.as_tensor(om2)))
    lim = RTOL * np.abs(a) + 4 * EPS * occ_scale(300.0, omega, 300.0, om2)
    assert (np.abs(b - a) <= lim).all()


def test_kernel_occupation_twin(pair):
    import jax.numpy as jnp

    from nanokappa_tpu.ops import kmath as jk
    from nanokappa_torch.ops import kmath as tk

    j, t = pair
    omega, T = _omega_T(np.random.default_rng(2), 4000, t.mat)
    a = np.asarray(jk.occupation_delta_T_k(jnp.asarray(T), 300.0, jnp.asarray(omega)))
    b = np_(tk.occupation_delta_T_k(torch.as_tensor(T), 300.0, torch.as_tensor(omega)))
    # the Taylor twin's 2e-5, relative to each value and to the largest
    np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-5 * np.abs(a).max())
    x = np.linspace(-3, 3, 101).astype(np.float32)
    np.testing.assert_array_equal(np_(tk.signk(torch.as_tensor(x))), np.asarray(jk.signk(x)))


def test_energy_temperature_lookups(pair):
    import jax.numpy as jnp

    from nanokappa_tpu.sim import binning as jbin
    from nanokappa_torch.sim import binning as tbin

    j, t = pair
    rng = np.random.default_rng(3)
    T = rng.uniform(1.0, 520.0, 2000).astype(np.float32)  # incl. off-table ends
    E = np.asarray(jbin.lookup_E_of_T(j.tabs, jnp.asarray(T)))
    np.testing.assert_allclose(np_(tbin.lookup_E_of_T(t.tabs, torch.as_tensor(T))), E, rtol=RTOL)
    E = E * rng.uniform(0.99, 1.01, E.shape).astype(np.float32)
    a = np.asarray(jbin.lookup_T_of_E(j.tabs, jnp.asarray(E)))
    np.testing.assert_allclose(np_(tbin.lookup_T_of_E(t.tabs, torch.as_tensor(E))), a, rtol=RTOL)


def test_subvol_ids_and_energies(pair):
    import jax.numpy as jnp

    from nanokappa_tpu.sim import binning as jbin
    from nanokappa_torch.sim import binning as tbin

    j, t = pair
    rng = np.random.default_rng(4)
    n = 5000
    pos = (rng.random((n, 3)) * [2e3, 1e3, 1e3]).astype(np.float32)
    pos[:5, 0] = [0.0, 400.0, 800.0, 2e3, -1.0]  # slice edges and outside
    a = np.asarray(jbin.subvol_id(j.geo, jnp.asarray(pos)))
    b = np_(tbin.subvol_id(t.geo, torch.as_tensor(pos)))
    np.testing.assert_array_equal(b, a)
    omega, _ = _omega_T(rng, n, t.mat)
    dev = rng.normal(0, 0.05, n).astype(np.float32)
    alive = rng.random(n) < 0.8
    T_sv = np.asarray(j.state.T_sv)
    e_j = np.asarray(jbin.particle_energies(
        jnp.asarray(omega), jnp.asarray(dev), jnp.asarray(alive), jnp.asarray(T_sv[a]), 300.0
    ))
    e_t = np_(tbin.particle_energies(
        torch.as_tensor(omega), torch.as_tensor(dev), torch.as_tensor(alive),
        torch.as_tensor(T_sv[a]), 300.0,
    ))
    from nanokappa_torch.constants import HBAR

    lim = RTOL * np.abs(e_j) + 4 * EPS * HBAR * np.abs(omega) * (
        np.abs(dev) + occ_scale(T_sv[a], omega)
    )
    assert (np.abs(e_t - e_j) <= lim).all()
    # segment sums: the one-hot matmul's rows (ids past n_seg dropped)
    seg = np.where(alive, a, 9)
    vals = np.stack([e_j, e_j * 2, alive.astype(np.float32)], 1)
    sj = np.asarray(jbin.segment_matmul(jnp.asarray(vals), jnp.asarray(seg), 8))
    st = np_(tbin.segment_sum(torch.as_tensor(vals), torch.as_tensor(seg), 8))
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-5 * np.abs(vals).sum())


def test_lifetimes_slope_pair(pair):
    import jax.numpy as jnp

    from nanokappa_tpu.sim import scatter as js
    from nanokappa_torch.sim import scatter as ts

    j, t = pair
    rng = np.random.default_rng(5)
    n = 3000
    M = t.mat.n_modes
    T_sv = rng.uniform(285.0, 315.0, 5).astype(np.float32)
    T_sv[0] = 300.0  # on a grid point
    sv = rng.integers(0, 5, n).astype(np.int32)
    mode = rng.integers(0, M, n).astype(np.int32)
    aj, bj = js.slope_pair(j.tabs, jnp.asarray(T_sv), jnp.asarray(sv), jnp.asarray(mode))
    at, bt = ts.slope_pair(t.tabs, torch.as_tensor(T_sv), torch.as_tensor(sv), torch.as_tensor(mode))
    np.testing.assert_allclose(np_(at), np.asarray(aj), rtol=RTOL, atol=1e-6 * np.abs(aj).max())
    np.testing.assert_allclose(np_(bt), np.asarray(bj), rtol=RTOL, atol=1e-6 * np.abs(bj).max())
    lj = js.lifetime_by_sv(j.tabs, jnp.asarray(T_sv), jnp.asarray(sv), jnp.asarray(mode))
    lt = ts.lifetime_by_sv(t.tabs, torch.as_tensor(T_sv), torch.as_tensor(sv), torch.as_tensor(mode))
    np.testing.assert_allclose(np_(lt), np.asarray(lj), rtol=RTOL)
    # within the bin, a + b*T is the table lerp
    T = T_sv[sv]
    np.testing.assert_allclose(np_(at) + np_(bt) * T, np.asarray(lj), rtol=1e-4)


def test_box_raycast(pair):
    import jax.numpy as jnp

    from nanokappa_tpu.ops.raycast import _raycast_box as j_cast
    from nanokappa_torch.ops.raycast import _raycast_box as t_cast

    j, t = pair
    rng = np.random.default_rng(6)
    n = 5000
    pos = (rng.random((n, 3)) * [2e3, 1e3, 1e3]).astype(np.float32)
    pos[:3] = [[0.0, 10.0, 10.0], [2e3, 500.0, 1e3], [5.0, 0.0, 999.99]]  # on walls
    vel = rng.normal(0, 40.0, (n, 3)).astype(np.float32)
    vel[3:6, 1] = 0.0  # parallel to a wall pair
    ex = rng.integers(-1, 6, n).astype(np.int32)
    tj, fj = j_cast(j.geo, jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(ex))
    tt, ft = t_cast(t.geo, torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(ex))
    np.testing.assert_array_equal(np_(ft), np.asarray(fj))
    np.testing.assert_allclose(np_(tt), np.asarray(tj), rtol=RTOL)
