"""Linear temperature interpolation on slices against the JAX package.

  * `sim/binning.py:interp_T_particles(kind="linear")` and
    `sim/scatter.py:lifetime_lookup` against the JAX functions
    (nanokappa_tpu/sim/binning.py:49-59, sim/scatter.py:21) on positions
    across the film, beyond both end slice centres too (the lerp
    extrapolates there): rtol 1e-6. The JAX XLA path rounds the slice
    centres' origin and spacing in float32, the port in float64 once (the
    JAX kernel's host arithmetic, nanokappa_tpu/ops/megastep.py:1162-1165):
    a spacing one float32 ulp apart moves T by ~1e-7 relative.
  * the narrow machinery's lifetime at the particle temperature: lanes on
    a fully diffuse wall re-emit with tau = lifetime_lookup(T_wall) and the
    Bose-Einstein occupation at T_wall, T_wall from the JAX interpolator
    (rtol 1e-6).
Kernel A under linear temperatures against the Pallas kernel:
tests/test_torch_linear_kernel.py (the slim film) and
tests/test_torch_linear_dkern.py (in-kernel diffuse reflection).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import FILM, build_pair, np_

def linear_pair(domain_kw=FILM):
    """build_pair's configuration under linear temperatures in both
    packages (the initial state is the same: both initialise at the
    subvolume temperatures)."""
    j, t = build_pair(domain_kw)
    j.params = dataclasses.replace(j.params, temp_interp="linear")
    t.params = dataclasses.replace(t.params, temp_interp="linear")
    return j, t


@pytest.fixture(scope="module")
def film():
    return linear_pair()


def test_interp_and_lifetime_match_jax(film):
    import jax.numpy as jnp

    from nanokappa_tpu.sim.binning import interp_T_particles as j_interp
    from nanokappa_tpu.sim.scatter import lifetime_lookup as j_lifetime
    from nanokappa_torch.sim.binning import interp_T_particles
    from nanokappa_torch.sim.scatter import lifetime_lookup

    j, t = film
    rng = np.random.default_rng(3)
    lo, hi = t.dom.mesh.bounds
    pos = rng.uniform(lo, hi, (20_000, 3)).astype(np.float32)
    T_sv = rng.uniform(296.0, 304.0, t.geo.n_subvols).astype(np.float32)
    sv = np.zeros(len(pos), np.int32)  # unread by the linear path
    T = np_(interp_T_particles(t.geo, torch.as_tensor(T_sv), torch.as_tensor(pos), torch.as_tensor(sv), "linear"))
    jT = np.asarray(j_interp(j.geo, jnp.asarray(T_sv), jnp.asarray(pos), jnp.asarray(sv), "linear"))
    np.testing.assert_allclose(T, jT, rtol=1e-6)
    c = np_(t.geo.subvol_center)[:, 0]
    beyond = (pos[:, 0] < c[0]) | (pos[:, 0] > c[-1])
    assert beyond.sum() > 1000 and (T[beyond] < T_sv.min()).any() | (T[beyond] > T_sv.max()).any()
    mode = rng.integers(0, t.mat.n_modes, len(pos)).astype(np.int32)
    tau = np_(lifetime_lookup(t.tabs, torch.as_tensor(T), torch.as_tensor(mode)))
    jtau = np.asarray(j_lifetime(j.tabs, jnp.asarray(T), jnp.asarray(mode)))
    np.testing.assert_allclose(tau, jtau, rtol=1e-6)


def test_narrow_lifetime_at_the_particle_temperature(film):
    """A buffer of lanes sitting on the film's bottom z wall, made fully
    diffuse (specularity 0): every lane re-emits at its linear wall
    temperature."""
    import jax.numpy as jnp

    from nanokappa_tpu.sim.binning import interp_T_particles as j_interp
    from nanokappa_tpu.sim.scatter import lifetime_lookup as j_lifetime
    from nanokappa_torch.sim.bose import occupation_delta_T
    from nanokappa_torch.sim.cascade import run_event_buffer

    j, t = film
    rng = np.random.default_rng(5)
    E = 512
    lo, hi = t.dom.mesh.bounds
    bc = np_(t.geo.facet_bc)
    normals = np_(t.geo.facet_normal)
    bottom = int(np.nonzero((bc == 3) & (normals[:, 2] < -0.5))[0][0])
    mode = rng.integers(0, t.mat.n_modes, E).astype(np.int32)
    ov = np_(t.tabs.omega_vel)[mode]
    rows = np.zeros((16, E), np.float32)
    rows[0] = rng.uniform(lo[0] + 100, hi[0] - 100, E)
    rows[1] = rng.uniform(lo[1] + 50, hi[1] - 50, E)
    rows[2] = lo[2]
    rows[3:6] = ov[:, 1:4].T
    rows[5] = -np.abs(rows[5]) - 1.0  # arriving at the bottom wall
    rows[6] = ov[:, 0]
    rows[9] = mode.view(np.float32)
    rows[10] = np.full(E, bottom, np.int32).view(np.float32)
    rows[12] = np.full(E, -1, np.int32).view(np.float32)
    rows[13] = 0.5
    rows[14] = 1.0
    btab = dataclasses.replace(t.btab, spec2=torch.zeros_like(t.btab.spec2))  # p = 0, no partner
    T_sv = torch.as_tensor(np.linspace(301.0, 299.0, t.geo.n_subvols, dtype=np.float32))
    out, *_ = run_event_buffer(
        torch.as_tensor(rows), torch.ones(E, dtype=torch.bool), t.geo, t.tabs, btab,
        t.params, torch.Generator().manual_seed(2), T_sv, 8,
    )
    T_w = np.asarray(j_interp(j.geo, jnp.asarray(np_(T_sv)), jnp.asarray(rows[0:3].T),
                              jnp.zeros(E, jnp.int32), "linear"))
    new_mode = np_(out[9]).view(np.int32)
    assert (new_mode != mode).mean() > 0.9
    jtau = np.asarray(j_lifetime(j.tabs, jnp.asarray(T_w), jnp.asarray(new_mode)))
    np.testing.assert_allclose(np_(out[7]), jtau, rtol=1e-6)
    occ = np_(occupation_delta_T(torch.as_tensor(np.array(T_w)), 300.0, out[6]))
    np.testing.assert_allclose(np_(out[8]), occ, rtol=1e-6, atol=1e-9)
