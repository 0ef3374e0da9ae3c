"""Kernel E's plain twin (nanokappa_torch/ops/raycast_large.py) against the
JAX package's large-mesh cast on the 96-sided cylinder (384 triangles):
  * the host tables bit-equal to the Pallas kernel's `_prep` (the facet row
    as int32 bits instead of float values);
  * the twin against `raycast_pallas(..., interpret=True)` on the 700 rays
    of tests/test_raycast_large.py (radial, axial and excluded rays): the
    same facet wherever the JAX hit lies more than 1e-3 (barycentric) from
    a triangle edge, t to rtol 1e-5 / atol 1e-5 ps — the JAX kernel sums its
    dot products inside a matrix product, the twin in a fixed order of three
    products, so t differs by float32 rounding;
  * the port's dispatch (`ops/raycast.py:raycast`) against the JAX package's
    dense scan `_raycast_broadcast` under that test's own rule.
"""

import numpy as np
import pytest
import torch

from torch_parity import np_


def _cyl_kw(n_side=96):
    return dict(
        geometry="cylinder",
        dimensions=(2e3, 400.0, n_side),
        subvolumes=("slice", 1, 2),  # one slice: no Monte Carlo volume split
        bound_pos=("relative", 0.5, 0.5, -0.1),
        bound_cond=("P", "R"),
        bound_values=(0.0,),
        connect_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
    )


@pytest.fixture(scope="module")
def geos():
    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.geometry.domain import build_domain as j_dom
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain

    jd = j_dom(**_cyl_kw())
    return jd, j_geo(jd), build_device_geometry(build_domain(**_cyl_kw()), device="cpu")


@pytest.fixture(scope="module")
def rays(geos):
    """tests/test_raycast_large.py's 700 rays (its domain has 4 slices;
    the subvolumes do not touch the cast)."""
    dom = geos[0]
    rng = np.random.default_rng(7)
    n = 700
    lo, hi = np.asarray(dom.mesh.bounds)
    pos = rng.uniform(lo + 1.0, hi - 1.0, (n, 3))
    r = np.linalg.norm(pos[:, :2] - dom.mesh.center_mass[:2], axis=1)
    pos[r > 350.0, :2] = dom.mesh.center_mass[:2]
    vel = rng.normal(0, 40.0, (n, 3))
    vel[:10, 2] = 0.0  # purely radial
    vel[10:20, :2] = 0.0  # purely axial
    excl = np.full(n, -1, np.int32)
    excl[30:60] = 1  # recast-style exclusions
    return pos.astype(np.float32), vel.astype(np.float32), excl


def test_prep_tables_bit_equal(geos):
    from nanokappa_tpu.ops.raycast_pallas import _prep
    from nanokappa_torch.ops.raycast_large import NC_MAX, large_eligible, prep

    _, jg, tg = geos
    jb, jt, jnc = _prep(jg)
    t = prep(tg)
    assert large_eligible(tg) and t.nc == jnc == 3 and jnc <= NC_MAX
    jb, jt = np.asarray(jb), np.asarray(jt)
    assert np.array_equal(np_(t.bbox).view(np.int32), jb.view(np.int32))
    tab = np_(t.tab)
    rows = [r for r in range(16) if r != 12]
    assert np.array_equal(tab[rows].view(np.int32), jt[rows].view(np.int32))
    assert np.array_equal(tab[12].view(np.int32), jt[12].astype(np.int32))
    # the Morton order: the facets of the sorted triangles
    assert np.array_equal(np_(tg.tri_facet)[t.order], jt[12, : len(t.order)].astype(np.int32))
    # every reach box holds its chunk's box
    reach = np_(t.reach)
    assert (reach[:3] <= jb[:3]).all() and (reach[3:] >= jb[3:6]).all()


@pytest.fixture(scope="module")
def pallas(geos, rays):
    """The JAX kernel in interpret mode on the 700 rays (one call: ~11 s)."""
    import jax.numpy as jnp

    from nanokappa_tpu.ops.raycast_pallas import raycast_pallas

    pos, vel, excl = rays
    t, f = raycast_pallas(geos[1], jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(excl), interpret=True)
    return np.asarray(t), np.asarray(f)


def test_twin_matches_pallas_kernel(geos, rays, pallas):
    from nanokappa_torch.ops.raycast_large import raycast_large

    _, jg, tg = geos
    pos, vel, excl = rays
    t_j, f_j = pallas
    t_p, f_p = raycast_large(tg, torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(excl))
    t_p, f_p = np_(t_p), np_(f_p)
    assert np.isfinite(t_p).all() and np.isfinite(t_j).all()

    # the barycentric distance of the JAX hit from the nearest edge of the
    # triangles of its facet: near an edge the two roundings may pick the
    # neighbour
    p_hit = pos.astype(np.float64) + t_j[:, None] * vel.astype(np.float64)
    tri = np.asarray(jg.tri_origin, np.float64)
    e1, e2 = np.asarray(jg.tri_e1, np.float64), np.asarray(jg.tri_e2, np.float64)
    tf = np.asarray(jg.tri_facet)
    edge = np.full(len(pos), np.inf)
    for k in range(len(tri)):
        m = f_j == tf[k]
        if not m.any():
            continue
        s = p_hit[m] - tri[k]
        g = np.array([[e1[k] @ e1[k], e1[k] @ e2[k]], [e1[k] @ e2[k], e2[k] @ e2[k]]])
        u, w = np.linalg.solve(g, np.stack([s @ e1[k], s @ e2[k]]))
        inside = (u >= -1e-3) & (w >= -1e-3) & (u + w <= 1 + 1e-3)
        dist = np.minimum(np.minimum(np.abs(u), np.abs(w)), np.abs(1 - u - w))
        edge[m] = np.where(inside, np.minimum(edge[m], dist), edge[m])
    far = edge > 1e-3
    assert far.mean() > 0.9, far.mean()
    np.testing.assert_array_equal(f_p[far], f_j[far])
    agree = f_p == f_j
    assert agree.mean() > 0.995
    np.testing.assert_allclose(t_p[agree], t_j[agree], rtol=1e-5, atol=1e-5)


def test_dispatch_matches_dense_scan(geos, rays):
    import jax.numpy as jnp

    from nanokappa_tpu.ops import raycast as jrc
    from nanokappa_torch.ops import raycast_large
    from nanokappa_torch.ops.raycast import raycast

    _, jg, tg = geos
    pos, vel, excl = rays
    t_ref, f_ref = jrc._raycast_broadcast(jg, jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(excl))
    t_ref, f_ref = np.asarray(t_ref), np.asarray(f_ref)
    n0 = raycast_large.launches
    t_p, f_p = raycast(tg, torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(excl))
    assert raycast_large.launches == n0  # CPU rays take the plain twin
    t_p, f_p = np_(t_p), np_(f_p)
    hit = np.isfinite(t_ref) | np.isfinite(t_p)
    agree = f_ref == f_p
    assert agree[hit].mean() > 0.995, (hit.sum(), (~agree & hit).sum())
    both = np.isfinite(t_ref) & np.isfinite(t_p) & agree
    np.testing.assert_allclose(t_p[both], t_ref[both], rtol=2e-4, atol=1e-4)


def test_tie_rules():
    """Two copies of one triangle give bit-equal t: within a chunk the
    smaller facet id wins whatever its place; across chunks (same frame) the
    earlier chunk keeps its hit, since a later one must be strictly closer."""
    from nanokappa_torch.ops.raycast_large import BF, LargeMeshTables, raycast_large_plain

    def tables(facets):  # facets[c][k]: facet of triangle k of chunk c (-1 pad)
        nc = len(facets)
        tab = np.zeros((16, nc * BF), np.float32)
        # the triangle (0,0,0), (10,0,0), (0,10,0) in the plane z = 0, frame
        # at the origin: n = +z, T1 = x / 10, T2 = y / 10, d = c1 = c2 = 0
        tab[2] = 0.0
        tab[0], tab[4], tab[8] = 0.1, 0.1, 1.0
        fac = np.full(nc * BF, -1, np.int32)
        for c, fs in enumerate(facets):
            for k, f in fs.items():
                fac[c * BF + k] = f
        tab[12] = fac.view(np.float32)
        bbox = np.zeros((16, nc), np.float32)
        return LargeMeshTables(
            order=np.arange(nc * BF), bbox=torch.as_tensor(bbox), tab=torch.as_tensor(tab),
            reach=torch.zeros((6, nc)),
        )

    pos = torch.tensor([[2.0, 3.0, 5.0]])
    vel = torch.tensor([[0.0, 0.0, -1.0]])
    ex = torch.tensor([-1], dtype=torch.int32)
    t, f = raycast_large_plain(tables([{3: 7, 90: 4}]), pos, vel, ex)
    assert float(t[0]) == 5.0 and int(f[0]) == 4  # smallest facet in a chunk
    t, f = raycast_large_plain(tables([{3: 7}, {0: 2}]), pos, vel, ex)
    assert int(f[0]) == 7  # the earlier chunk keeps a tie
    t, f = raycast_large_plain(tables([{3: 7}, {0: 2}]), pos, vel, torch.tensor([7], dtype=torch.int32))
    assert int(f[0]) == 2  # the excluded facet is skipped
