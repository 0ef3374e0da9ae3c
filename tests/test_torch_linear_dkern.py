"""Kernel A's in-kernel diffuse branch (the "plain" pool) under linear
temperatures against the Pallas kernel (its dkern branch, interpret mode),
one step: the deferred RTA at the lerped particle temperature and the
diffuse re-emission at the lerped wall temperature
(nanokappa_tpu/ops/megastep.py:534, :788-791).

The construction is tests/test_torch_wire_kernel.py's, made deterministic
the same way: the top rough wall's eta (1e-4 A) makes every partnered
lane's specularity 1 (a certain flag), the bottom wall's (1e6 A) makes it 0
(a certain diffusion), and no lane can have two events in the step. Here
the box is sliced along z, the rough walls' axis, so a wall sits beyond the
end slice centre and its temperature is an extrapolation of the lerp; the
slice temperatures keep it inside the JAX presample pool's envelope (its
out-of-range lanes would export instead of diffusing).
  * the flagged and the diffused lanes are the same sets in both kernels;
  * every other lane: int rows exact, floats rtol 2e-5 (the JAX kernel's
    Taylor expm1 twin) — their deferred RTA ran at the lerped T; the
    occupation deviation to 2e-5 of its operands' size, n0(T) + n0(T_ref)
    + |dev| (away from T_ref the twin's 2e-5 on n0 survives the
    difference g = n0(T) - n0(T_ref), tests/test_torch_primitives.py:
    occ_scale);
  * counts, exported indices and rows match; the ledger and the sums of
    the lanes that did not diffuse to rtol 1e-5 of their absolute scale;
  * a diffused lane carries the Bose-Einstein occupation and the lifetime
    of its new mode at the lerp extrapolated to the bottom wall (rtol 1e-5:
    the hit lies within float32 rounding of the wall's plane).
"""

import numpy as np
import pytest
import torch

from test_torch_linear_t import linear_pair
from test_torch_primitives import occ_scale
from torch_parity import FILM, np_
from test_torch_wire_kernel import FLOAT_ROWS, INT_ROWS, REM, _close_rows, _energy_bins

ROUGH_Z = dict(FILM, subvolumes=("slice", 5, 2), bound_values=(302.0, 298.0, 1e6, 1e-4))


@pytest.fixture(scope="module")
def box():
    """tests/test_torch_wire_kernel.py's pool on the z-sliced box."""
    import jax.numpy as jnp

    from nanokappa_tpu.sim.fused import dkern_mode_rows, to_transposed

    j, t = linear_pair(ROUGH_Z)
    d2 = dkern_mode_rows(j.btab, j.tabs)
    stT = to_transposed(j.state, extra=d2[jnp.clip(j.state.mode, 0, d2.shape[0] - 1)])
    pool = np.array(stT.packed).reshape(18, -1)
    keep = np.nonzero(pool[14] > 0.5)[0]
    pool = np.concatenate([pool[:, keep], np.zeros((18, pool.shape[1] - len(keep)), np.float32)], 1)
    mesh = t.dom.mesh
    rng = np.random.default_rng(1)
    lo, hi = mesh.bounds
    lanes = np.nonzero(pool[14] > 0.5)[0]
    mv = lanes[rng.random(len(lanes)) < 0.4]
    vz = pool[5, mv]
    mv, vz = mv[np.abs(vz) > 5.0], vz[np.abs(vz) > 5.0]
    depth = rng.uniform(0.1, 0.9, len(mv)) * np.abs(vz) * REM
    pool[2, mv] = np.where(vz > 0, hi[2] - depth, lo[2] + depth)
    pool[10, mv] = np.array(-2, np.int32).view(np.float32)
    x = pool[0:3].T.astype(np.float64)
    dist = np.stack([(mesh.facet_centroids[f] - x) @ mesh.facet_normals[f] for f in range(mesh.n_facets)], 1)
    reach = 2.0 * REM * float(np.linalg.norm(pool[3:6], axis=0).max())
    alive = (pool[14] > 0.5) & ((dist < reach).sum(1) < 2)
    pool[14] = alive.astype(np.float32)
    pool[13] = np.where(alive, REM, 0.0)
    lanes = np.nonzero(alive)[0]
    pool[10, lanes[::20]] = np.array(-2, np.int32).view(np.float32)
    return j, t, pool


def test_linear_dkern_branch_matches_pallas(box):
    import jax.numpy as jnp

    from nanokappa_tpu.ops.megastep import drift_megastep as j_drift
    from nanokappa_tpu.sim.fused import _dkern_facet_tables, dkern_active as j_dkern
    from nanokappa_torch.ops.kmath import occupation_delta_T_k
    from nanokappa_torch.ops.megastep import SV_LINEAR, _tau_at, drift_megastep, mega_config
    from nanokappa_torch.sim.binning import interp_T_linear, linear_axis

    j, t, pool = box
    T_sv = torch.tensor([300.6, 300.3, 300.1, 299.8, 299.5])
    N = pool.shape[1]
    ecap = 1024
    dpool = j_dkern(j.geo, j.btab, j.params, j.tabs, N)
    assert dpool is not None
    dk = dict(
        pool=dpool, window=dpool.window, off=jnp.asarray(0, jnp.int32),
        seed=jnp.asarray(12345, jnp.int32), **_dkern_facet_tables(j.geo, j.btab),
    )
    L = N // 8
    jp, jidx, ecnt, acnt, _starts, kept, jled, jbins = j_drift(
        jnp.asarray(pool.reshape(18, N // L, L)), jnp.asarray(np_(T_sv)), jnp.asarray(1),
        j.geo, j.params, ecap=ecap, interpret=True, dk=dk,
    )
    jp = np.asarray(jp).reshape(18, N)[:16]
    cfg = mega_config(t.geo, t.tabs, t.btab, t.params, ecap)
    assert cfg.sv_mode == SV_LINEAR and cfg.dkern and t.geo.slice_axis == 2
    tp = torch.as_tensor(pool[:16].copy())
    rows, idx, counts, led, bins = drift_megastep(tp, T_sv, True, cfg, seed=777)
    tp = np_(tp)

    bc = np_(t.geo.facet_bc)
    rough = np.nonzero(bc == 3)[0]
    onf0 = pool[12].view(np.int32)

    def events(out):
        onf = out[12].view(np.int32)
        flag = out[11] < -1.5
        return flag, np.isin(onf, rough) & (onf != onf0) & ~flag

    jflag, jdiff = events(jp)
    tflag, tdiff = events(tp)
    np.testing.assert_array_equal(tflag, jflag)
    np.testing.assert_array_equal(tdiff, jdiff)
    assert tflag.sum() > 10 and tdiff.sum() > 10, (tflag.sum(), tdiff.sum())

    quiet = ~(tflag | tdiff)
    for r in INT_ROWS:
        np.testing.assert_array_equal(tp[r, quiet].view(np.int32), jp[r, quiet].view(np.int32), err_msg=f"row {r}")
    _close_rows(tp[:, quiet], jp[:, quiet], [r for r in FLOAT_ROWS if r != 8], "quiet lanes")
    c0, dc = linear_axis(t.geo)
    p0 = torch.as_tensor(pool[:16])
    T_p = np_(interp_T_linear(T_sv, p0[2], c0, dc)).astype(np.float64)
    scale = occ_scale(T_p, pool[6].astype(np.float64))[quiet] + np.abs(pool[8][quiet])
    assert (np.abs(tp[8, quiet] - jp[8, quiet]) <= 2e-5 * scale).all()

    k = int(np.asarray(kept).sum())
    assert counts[:3].tolist() == [int(np.asarray(ecnt).sum()), int(np.asarray(acnt).sum()), k]
    assert int(counts[3]) == tdiff.sum() and int(counts[4]) == tflag.sum() == k
    np.testing.assert_array_equal(np_(idx[:k]), np.asarray(jidx)[:k])
    for r in INT_ROWS:
        np.testing.assert_array_equal(np_(rows[r, :k]).view(np.int32), jp[r, np.asarray(jidx)[:k]].view(np.int32))
    _close_rows(np_(rows[:, :k]), jp[:, np.asarray(jidx)[:k]], FLOAT_ROWS, "exported")

    a, b = np_(led).astype(np.float64), np.asarray(jled, np.float64)
    scale = np.abs(b).sum(axis=0, keepdims=True) + np.abs(b).max()
    assert (np.abs(a - b) <= 1e-5 * np.abs(b) + 1e-5 * scale).all(), (a, b)
    sv8 = cfg.sv8
    a = np_(bins).astype(np.float64) - _energy_bins(tp, tdiff, T_sv, sv8)
    b = np.asarray(jbins, np.float64) - _energy_bins(jp, tdiff, T_sv, sv8)
    scale = np.abs(b).sum(axis=0, keepdims=True) + np.abs(b).max()
    assert (np.abs(a - b) <= 1e-5 * np.abs(b) + 1e-5 * scale).all(), (a, b)

    # each diffused lane left the bottom wall (z = 0) at the extrapolated T
    d = torch.as_tensor(tdiff)
    tpt = torch.as_tensor(tp)
    mode = tpt[9].contiguous().view(torch.int32)[d]
    T_w = interp_T_linear(T_sv, torch.zeros(int(d.sum())), c0, dc)
    assert bool((T_w > T_sv.max()).all() | (T_w < T_sv.min()).all())  # beyond the end centre
    np.testing.assert_allclose(np_(tpt[8][d]), np_(occupation_delta_T_k(T_w, 300.0, tpt[6][d])), rtol=1e-5)
    np.testing.assert_allclose(np_(tpt[7][d]), np_(_tau_at(cfg, T_w, mode)), rtol=1e-5)
