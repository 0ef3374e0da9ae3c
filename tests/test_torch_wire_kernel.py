"""Kernel A's mirror-off branch (in-kernel diffuse reflection, the "plain"
pool) against the JAX package's Pallas kernel (its dkern branch, interpret
mode), one step.

The JAX kernel with the wire's 32-triangle cast takes over a minute to
compile for the CPU, so the branch is held against it on a box (the slab
cast); the triangle cast itself is held against the Pallas kernel's
`_tri_raycast` in tests/test_torch_wire_cast.py, and the wire's whole step
against the JAX step in tests/test_torch_wire_step.py.

The two kernels draw their random numbers differently, so the comparison is
built to be deterministic: the top rough wall's eta (1e-4 A) makes the
Ziman specularity 1 in float32 for every mode with a specular partner (the
specular flag is then certain; every incident mode has one there), the
bottom wall's (1e6 A) makes it 0 (certain diffusion), and
every lane can have at most one event in the step (its leftover flight is
short, and lanes near two boundary planes are removed), so no lane diffuses
and then hits a second wall: the JAX kernel's round-1 redraws, which read
the wrong wall row (ROADMAP queue 3), never happen. Then:
  * the lanes that hit a rough wall are the same set in both kernels;
  * every other lane matches: int rows exactly, floats to rtol 2e-5 (the
    JAX kernel's Taylor expm1 twin);
  * counts, exported pool indices and the exported (flagged) rows match;
  * the ledger and the subvolume sums of the lanes that did not diffuse
    match to rtol 1e-5 of their absolute scale;
  * every diffused lane carries its new mode's table row, the
    Bose-Einstein occupation and the lifetime at the wall temperature.
"""

import numpy as np
import pytest
import torch

from torch_parity import FILM, build_pair, np_

INT_ROWS = [9, 10, 12, 14, 15]  # mode, facet, on-facet, alive, sv
FLOAT_ROWS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13]
REM = 0.25  # each lane's leftover flight this step, in dt


def _close_rows(a, b, rows, msg):
    for r in rows:
        x, y = np.asarray(a[r], np.float64), np.asarray(b[r], np.float64)
        fin = np.isfinite(y)
        np.testing.assert_array_equal(np.isfinite(x), fin, err_msg=f"{msg} row {r}")
        scale = np.abs(y[fin]).max(initial=0.0)
        np.testing.assert_allclose(x[fin], y[fin], rtol=2e-5, atol=2e-5 * scale, err_msg=f"{msg} row {r}")


def _energy_bins(pool, lanes, T_sv, sv8):
    """Per-subvolume [e, e vx, e vy, e vz, 1] of the given alive lanes."""
    from nanokappa_torch.constants import HBAR
    from nanokappa_torch.sim.bose import occupation_delta_T

    p = torch.as_tensor(pool[:, lanes])
    sv = p[15].contiguous().view(torch.int32).long()
    e = (HBAR * p[6] * (p[8] - occupation_delta_T(T_sv[sv], 300.0, p[6]))).double()
    vals = torch.stack([e, e * p[3], e * p[4], e * p[5], torch.ones_like(e)], 1)
    out = torch.zeros((sv8, 5), dtype=torch.float64)
    out.index_add_(0, sv, vals)
    return out.numpy()


@pytest.fixture(scope="module")
def box():
    """The film box with eta = 1e-4 and 1e6 A rough walls, its JAX pool in the
    in-kernel-diffuse 18-row layout, compacted, with a short leftover flight
    for every lane, many lanes moved next to a rough wall, those and 5% of
    the rest fresh (cast in-kernel), and the lanes within two flights of two
    boundary planes removed."""
    import jax.numpy as jnp

    from nanokappa_tpu.sim.fused import dkern_mode_rows, to_transposed

    j, t = build_pair(dict(FILM, bound_values=(302.0, 298.0, 1e6, 1e-4)))
    d2 = dkern_mode_rows(j.btab, j.tabs)
    stT = to_transposed(j.state, extra=d2[jnp.clip(j.state.mode, 0, d2.shape[0] - 1)])
    pool = np.array(stT.packed).reshape(18, -1)
    # compacted: the alive lanes in order at the front, zero lanes behind
    keep = np.nonzero(pool[14] > 0.5)[0]
    pool = np.concatenate([pool[:, keep], np.zeros((18, pool.shape[1] - len(keep)), np.float32)], 1)
    mesh = t.dom.mesh
    # move 40% of the lanes just inside the rough z wall their velocity
    # points at, within one leftover flight of it
    rng = np.random.default_rng(1)
    lo, hi = mesh.bounds
    lanes = np.nonzero(pool[14] > 0.5)[0]
    mv = lanes[rng.random(len(lanes)) < 0.4]
    vz = pool[5, mv]
    mv, vz = mv[np.abs(vz) > 5.0], vz[np.abs(vz) > 5.0]
    depth = rng.uniform(0.1, 0.9, len(mv)) * np.abs(vz) * REM
    pool[2, mv] = np.where(vz > 0, hi[2] - depth, lo[2] + depth)
    pool[10, mv] = np.array(-2, np.int32).view(np.float32)  # fresh: cast in-kernel
    x = pool[0:3].T.astype(np.float64)
    dist = np.stack([(mesh.facet_centroids[f] - x) @ mesh.facet_normals[f] for f in range(mesh.n_facets)], 1)
    reach = 2.0 * REM * float(np.linalg.norm(pool[3:6], axis=0).max())
    alive = (pool[14] > 0.5) & ((dist < reach).sum(1) < 2)
    pool[14] = alive.astype(np.float32)
    pool[13] = np.where(alive, REM, 0.0)
    lanes = np.nonzero(alive)[0]
    pool[10, lanes[::20]] = np.array(-2, np.int32).view(np.float32)
    return j, t, pool


def test_dkern_branch_matches_pallas(box):
    import jax.numpy as jnp

    from nanokappa_tpu.ops.megastep import drift_megastep as j_drift
    from nanokappa_tpu.sim.fused import _dkern_facet_tables, dkern_active as j_dkern
    from nanokappa_torch.ops.kmath import occupation_delta_T_k
    from nanokappa_torch.ops.megastep import drift_megastep, mega_config
    from nanokappa_torch.sim.fused import dkern_active, mirror_eligible
    from nanokappa_torch.sim.scatter import lifetime_by_sv

    j, t, pool = box
    # one wall temperature everywhere: a diffused lane's new occupation and
    # lifetime are then known whatever slice it diffused in
    T_sv = torch.full((t.geo.n_subvols,), 300.0)
    assert not mirror_eligible(t.geo, t.btab, t.params, t.tabs)
    assert dkern_active(t.geo, t.btab, t.params, t.tabs)
    N = pool.shape[1]
    ecap = 1024
    dpool = j_dkern(j.geo, j.btab, j.params, j.tabs, N)
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
    tp = torch.as_tensor(pool[:16].copy())
    rows, idx, counts, led, bins = drift_megastep(tp, T_sv, True, cfg, seed=777)
    tp = np_(tp)

    # the lanes with a rough-wall event: flagged specular, or diffused (now
    # sitting on the rough facet they left from)
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
    _close_rows(tp[:, quiet], jp[:, quiet], FLOAT_ROWS, "quiet lanes")

    k = int(np.asarray(kept).sum())
    assert counts[:3].tolist() == [int(np.asarray(ecnt).sum()), int(np.asarray(acnt).sum()), k]
    assert int(counts[3]) == tdiff.sum() and int(counts[4]) == tflag.sum() == k
    np.testing.assert_array_equal(np_(idx[:k]), np.asarray(jidx)[:k])
    assert (np_(idx[k:]) == N).all()
    for r in INT_ROWS:
        np.testing.assert_array_equal(np_(rows[r, :k]).view(np.int32), jp[r, np.asarray(jidx)[:k]].view(np.int32))
    _close_rows(np_(rows[:, :k]), jp[:, np.asarray(jidx)[:k]], FLOAT_ROWS, "exported")

    a, b = np_(led).astype(np.float64), np.asarray(jled, np.float64)
    scale = np.abs(b).sum(axis=0, keepdims=True) + np.abs(b).max()
    assert (np.abs(a - b) <= 1e-5 * np.abs(b) + 1e-5 * scale).all(), (a, b)
    # the diffused lanes' bins depend on their random new modes: compare
    # the sums of everything else
    sv8 = cfg.sv8
    a = np_(bins).astype(np.float64) - _energy_bins(tp, tdiff, T_sv, sv8)
    b = np.asarray(jbins, np.float64) - _energy_bins(jp, jdiff, T_sv, sv8)
    scale = np.abs(b).sum(axis=0, keepdims=True) + np.abs(b).max()
    assert (np.abs(a - b) <= 1e-5 * np.abs(b) + 1e-5 * scale).all(), (a, b)

    # each diffused lane: its new mode's table row, BE(T_wall), tau(T_wall)
    d = torch.as_tensor(tdiff)
    tpt = torch.as_tensor(tp)
    mode = tpt[9].contiguous().view(torch.int32).long()[d]
    assert torch.equal(tpt[6][d], t.tabs.omega_vel[mode, 0])
    assert torch.equal(tpt[3:6][:, d], t.tabs.omega_vel[mode, 1:4].T)
    T_w = torch.full((int(d.sum()),), 300.0)
    assert torch.equal(tpt[8][d], occupation_delta_T_k(T_w, 300.0, tpt[6][d]))
    sv = torch.zeros_like(mode)
    np.testing.assert_allclose(np_(tpt[7][d]), np_(lifetime_by_sv(t.tabs, T_sv, sv, mode)), rtol=1e-6)
