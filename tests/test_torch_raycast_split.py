"""Kernel E's split of a ray across threads (csrc/raycast_large.cu), proved
on the CPU with a torch emulation of what the kernel's threads compute:

  * each of G threads of a ray solves one subset of every chunk's 128
    triangles (the kernel's strided one, k = g, g + G, ..., or a random
    partition), skips a chunk whose reach box its ray cannot enter before
    the thread's own best hit, and keeps the minimum of the key
    (t, chunk, facet); the G partial minima combine by the kernel's xor
    butterfly. That equals `raycast_large_plain` bit for bit, on the
    96-sided cylinder and on crafted ties (equal t within a chunk and across
    chunks, vertex-aimed rays, an excluded facet, zero velocity components);
  * `launch_shape` / `launch_blocks` cover every ray exactly G times (once a
    thread of its group) at the main paths' widths, with no ray dropped at a
    ragged edge (one ray a thread: R rays a thread was measured slower on
    the card and is not kept);
  * the kernel's 16-float records are the twin's 13-row table, transposed;
  * the split against `raycast_pallas` in interpret mode on the 700 rays of
    tests/test_torch_raycast_large.py, under that file's rule.
"""

import numpy as np
import pytest
import torch

from torch_parity import np_

BIG = torch.iinfo(torch.int32).max


def _cyl_kw(n_side=96):
    return dict(
        geometry="cylinder",
        dimensions=(2e3, 400.0, n_side),
        subvolumes=("slice", 1, 2),
        bound_pos=("relative", 0.5, 0.5, -0.1),
        bound_cond=("P", "R"),
        bound_values=(0.0,),
        connect_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
    )


@pytest.fixture(scope="module")
def cyl():
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain

    return build_device_geometry(build_domain(**_cyl_kw()), device="cpu")


def _keymin(t, c, f):
    """Lexicographic minimum of (t, c, f) along dim 1 ((N, P) each)."""
    tm = t.min(dim=1).values
    at = t == tm[:, None]
    cm = torch.where(at, c, BIG).min(dim=1).values
    fm = torch.where(at & (c == cm[:, None]), f, BIG).min(dim=1).values
    return tm, cm, fm


def split_cast(tabs, pos, vel, ex, subsets):
    """What the kernel's G threads of each ray compute: subsets[g] the
    triangle slots (within a chunk) thread g solves. Returns (t, facet)."""
    from nanokappa_torch.ops import raycast_large as rl

    N, G = pos.shape[0], len(subsets)
    x = [pos[:, k] for k in range(3)]
    v = [vel[:, k] for k in range(3)]
    inv = [torch.ones_like(v[k]) / torch.where(v[k].abs() > 1e-30, v[k], 1e-30) for k in range(3)]
    frame = tabs.bbox[6:9]
    part = []
    for sub in subsets:
        sub = torch.as_tensor(sub, dtype=torch.long)
        bt = torch.full((N,), float("inf"))
        bc = torch.full((N,), BIG, dtype=torch.int32)
        bf = torch.full((N,), BIG, dtype=torch.int32)
        for c in range(tabs.nc):
            reach = rl._reach(tabs, c, x, inv, bt)  # the thread's own best
            t, fid = rl._pair_t(tabs.tab[: rl.TAB_ROWS, c * rl.BF:(c + 1) * rl.BF], frame[:, c], x, v, ex)
            t = torch.where(reach[:, None], t[:, sub], float("inf"))
            cc = torch.full(t.shape, c, dtype=torch.int32)
            t, cc, ff = (torch.cat([bt[:, None], t], 1), torch.cat([bc[:, None], cc], 1),
                         torch.cat([bf[:, None], fid[:, sub]], 1))
            bt, bc, bf = _keymin(t, cc, ff)
        part.append((bt, bc, bf))
    # the kernel's __shfl_xor_sync butterfly over the G threads
    off = G // 2
    while off:
        part = [
            _keymin(*(torch.stack([part[g][j], part[g ^ off][j]], 1) for j in range(3)))
            for g in range(G)
        ]
        off //= 2
    bt, _, bf = part[0]
    for g in range(1, G):  # every thread of the group ends with the same key
        assert torch.equal(part[g][0].view(torch.int32), bt.view(torch.int32))
    return bt, torch.where(torch.isfinite(bt), bf, -1)


def _strided(G):
    return [list(range(g, 128, G)) for g in range(G)]


def _random_parts(G, rng):
    perm = rng.permutation(128)
    return [sorted(perm[g::G].tolist()) for g in range(G)]


def _assert_bits(a, b):
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


def _cyl_rays(geo, n=1500, seed=3):
    """Rays inside the cylinder: random ones, some with zero velocity
    components or an excluded facet, and a third aimed at triangle vertices
    (equal t on the triangles that share the vertex)."""
    from nanokappa_torch.geometry.device import host

    rng = np.random.default_rng(seed)
    a, r = 2 * np.pi * rng.random(n), 380.0 * np.sqrt(rng.random(n))
    pos = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(10.0, 1990.0, n)], 1)
    lo = host(geo.bounds)[0]
    pos[:, :2] += (host(geo.bounds)[1, :2] + lo[:2]) / 2
    vel = rng.normal(0.0, 40.0, (n, 3))
    vel[0::9, 2] = 0.0
    vel[1::9, :2] = 0.0
    ex = np.full(n, -1, np.int32)
    ex[2::7] = rng.integers(0, int(host(geo.tri_facet).max()) + 1, len(ex[2::7]))
    o, e1, e2 = host(geo.tri_origin), host(geo.tri_e1), host(geo.tri_e2)
    verts = np.concatenate([o, o + e1, o + e2])
    aim = np.arange(0, n, 3)
    tgt = verts[rng.integers(0, len(verts), len(aim))]
    pos[aim, 2] = tgt[:, 2]
    vel[aim] = (tgt - pos[aim]) / 5.0
    ex[aim] = -1
    f = lambda z: torch.as_tensor(np.asarray(z, np.float32))  # noqa: E731
    return f(pos), f(vel), torch.as_tensor(ex)


def test_records_are_the_table(cyl):
    from nanokappa_torch.ops import raycast_large as rl

    tabs = rl.prep(cyl)
    assert tabs.rec.shape == (tabs.nc * rl.BF, rl.REC_W) and tabs.rec.is_contiguous()
    assert torch.equal(tabs.rec.view(torch.int32), tabs.tab.T.contiguous().view(torch.int32))
    # the twin read from the records gives today's result
    pos, vel, ex = _cyl_rays(cyl, 400)
    from_rec = rl.LargeMeshTables(order=tabs.order, bbox=tabs.bbox, tab=tabs.rec.T.contiguous(),
                                  reach=tabs.reach)
    _assert_bits(rl.raycast_large_plain(from_rec, pos, vel, ex), rl.raycast_large_plain(tabs, pos, vel, ex))


@pytest.mark.parametrize("G", [1, 4, 32])
def test_split_equals_twin_on_the_cylinder(cyl, G):
    """The split at G threads a ray, strided and randomly partitioned."""
    from nanokappa_torch.ops import raycast_large as rl

    tabs = rl.prep(cyl)
    assert tabs.nc == 3
    pos, vel, ex = _cyl_rays(cyl)
    twin = rl.raycast_large_plain(tabs, pos, vel, ex)
    assert float(torch.isfinite(twin[0]).float().mean()) > 0.95
    _assert_bits(split_cast(tabs, pos, vel, ex, _strided(G)), twin)
    _assert_bits(split_cast(tabs, pos, vel, ex, _random_parts(G, np.random.default_rng(G))), twin)
    if G == 32:
        # the vertex-aimed rays make ties: the same minimal t on two facets
        # within a chunk, and in two chunks
        x = [pos[:, k] for k in range(3)]
        v = [vel[:, k] for k in range(3)]
        ts = [rl._pair_t(tabs.tab[: rl.TAB_ROWS, c * rl.BF:(c + 1) * rl.BF], tabs.bbox[6:9, c], x, v, ex)
              for c in range(tabs.nc)]
        at = [t == twin[0][:, None] for t, _ in ts]
        in_chunk = [(torch.where(a, f, BIG).amin(1) != torch.where(a, f, -1).amax(1)) & a.any(1)
                    for a, (_, f) in zip(at, ts)]
        assert int(torch.stack(in_chunk).any(0).sum()) > 10
        assert int(torch.stack([a.any(1) for a in at]).sum(0).ge(2).sum()) > 0


def _crafted():
    """Copies of one triangle ((0,0,0), (10,0,0), (0,10,0) in z = 0, frame
    at the origin) in three chunks, with reach boxes around it: every ray
    that hits one copy hits all at the same t."""
    from nanokappa_torch.ops.raycast_large import BF, LargeMeshTables

    facets = [{3: 7, 90: 4, 91: 9}, {0: 2, 5: 4}, {127: 1, 64: 3}]
    nc = len(facets)
    tab = np.zeros((16, nc * BF), np.float32)
    tab[0], tab[4], tab[8] = 0.1, 0.1, 1.0
    fac = np.full(nc * BF, -1, np.int32)
    for c, fs in enumerate(facets):
        for k, f in fs.items():
            fac[c * BF + k] = f
    tab[12] = fac.view(np.float32)
    reach = np.concatenate([np.full((3, nc), -20.0), np.full((3, nc), 20.0)]).astype(np.float32)
    return LargeMeshTables(order=np.arange(nc * BF), bbox=torch.zeros((16, nc)),
                           tab=torch.as_tensor(tab), reach=torch.as_tensor(reach))


def test_split_equals_twin_on_crafted_ties():
    from nanokappa_torch.ops.raycast_large import raycast_large_plain

    tabs = _crafted()
    pos = torch.tensor([[2.0, 3.0, 5.0], [2.0, 3.0, 5.0], [2.0, 3.0, 5.0], [0.0, 0.0, 5.0],
                        [10.0, 0.0, 5.0], [4.0, 4.0, 1.0], [2.0, 3.0, 5.0], [3.0, 3.0, -2.0],
                        [1.0, 1.0, 5.0]])
    vel = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, -2.0],
                        [-1.0, 0.0, -1.0], [1.0, 1.0, -0.5], [1.0, 0.0, 0.0], [0.0, 0.0, 3.0],
                        [0.0, 0.0, 1.0]])
    ex = torch.tensor([-1, 4, 7, -1, -1, 9, -1, 2, -1], dtype=torch.int32)
    twin = raycast_large_plain(tabs, pos, vel, ex)
    # within a chunk the smallest facet; across chunks the first chunk
    assert twin[1].tolist()[:3] == [4, 7, 4]
    assert twin[1][6] == -1 and not torch.isfinite(twin[0][6])  # parallel to the plane
    assert twin[1][8] == -1  # moving away: behind the slack
    rng = np.random.default_rng(5)
    for G in (1, 2, 8, 32):
        _assert_bits(split_cast(tabs, pos, vel, ex, _strided(G)), twin)
        _assert_bits(split_cast(tabs, pos, vel, ex, _random_parts(G, rng)), twin)


@pytest.mark.parametrize("n", [1, 31, 3304, 5120, 52805, 1277952])
def test_launch_shapes_cover_every_ray(n):
    from nanokappa_torch.ops.raycast_large import THREADS, THREADS_PER_RAY, launch_blocks, launch_shape

    assert launch_shape(n) in THREADS_PER_RAY
    for G in THREADS_PER_RAY:
        nb = launch_blocks(n, G)
        tid = np.arange(THREADS)
        i = np.arange(nb)[:, None] * (THREADS // G) + (tid // G)[None, :]
        live = i < n
        held = np.bincount(i[live], minlength=n)
        assert (held == G).all()  # every ray, once a thread of its group
        lead = live & (tid % G == 0)[None, :]
        assert np.array_equal(np.sort(i[lead]), np.arange(n))  # one writer a ray
        assert i[-1].min() < n  # no block without a ray
    assert [launch_shape(m) for m in (3304, 5120, 52805, 1277952)] == [16, 8, 8, 1]


def test_split_matches_pallas_kernel():
    """The split (G = 32 and G = 4) on the 700 rays against the JAX kernel
    in interpret mode: the same facet wherever the JAX hit lies more than
    1e-3 (barycentric) from a triangle edge, t to rtol 1e-5 / atol 1e-5 ps
    (tests/test_torch_raycast_large.py's rule: the JAX kernel sums its dot
    products in a matrix product)."""
    import jax.numpy as jnp

    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.geometry.domain import build_domain as j_dom
    from nanokappa_tpu.ops.raycast_pallas import raycast_pallas
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.ops import raycast_large as rl

    jd = j_dom(**_cyl_kw())
    jg, tg = j_geo(jd), build_device_geometry(build_domain(**_cyl_kw()), device="cpu")
    rng = np.random.default_rng(7)
    n = 700
    lo, hi = np.asarray(jd.mesh.bounds)
    pos = rng.uniform(lo + 1.0, hi - 1.0, (n, 3))
    r = np.linalg.norm(pos[:, :2] - jd.mesh.center_mass[:2], axis=1)
    pos[r > 350.0, :2] = jd.mesh.center_mass[:2]
    vel = rng.normal(0, 40.0, (n, 3))
    vel[:10, 2] = 0.0
    vel[10:20, :2] = 0.0
    excl = np.full(n, -1, np.int32)
    excl[30:60] = 1
    pos, vel = pos.astype(np.float32), vel.astype(np.float32)
    t_j, f_j = raycast_pallas(jg, jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(excl), interpret=True)
    t_j, f_j = np.asarray(t_j), np.asarray(f_j)
    tabs = rl.prep(tg)
    args = (torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(excl))
    twin = rl.raycast_large_plain(tabs, *args)
    for G in (32, 4):
        t_s, f_s = split_cast(tabs, *args, _strided(G))
        _assert_bits((t_s, f_s), twin)
    t_s, f_s = np_(t_s), np_(f_s)
    p_hit = pos.astype(np.float64) + t_j[:, None] * vel.astype(np.float64)
    tri = np.asarray(jg.tri_origin, np.float64)
    e1, e2 = np.asarray(jg.tri_e1, np.float64), np.asarray(jg.tri_e2, np.float64)
    tf = np.asarray(jg.tri_facet)
    edge = np.full(n, np.inf)
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
    np.testing.assert_array_equal(f_s[far], f_j[far])
    agree = f_s == f_j
    assert agree.mean() > 0.995
    np.testing.assert_allclose(t_s[agree], t_j[agree], rtol=1e-5, atol=1e-5)
