"""Ray casts of the nanowire slice against the JAX package: the port's
`raycast` (box slab or dense Möller–Trumbore up to 256 triangles) and
kernel A's in-kernel triangle cast. t agrees to rtol 1e-5 plus 1e-5 ps
(float32 sums in another order); the hit facet is exact.
"""

import numpy as np
import pytest
import torch

from torch_parity import WIRE, np_


def _rays(dom, n, seed):
    rng = np.random.default_rng(seed)
    pos = dom.mesh.sample_volume(n, rng).astype(np.float32)
    d = rng.normal(size=(n, 3))
    vel = (d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(10, 80, (n, 1)))
    exclude = rng.integers(-1, dom.mesh.n_facets, n).astype(np.int32)
    return pos, vel.astype(np.float32), exclude


def _close_casts(t, f, jt, jf):
    jt, jf = np.asarray(jt), np.asarray(jf)
    np.testing.assert_array_equal(np_(f), jf)
    fin = np.isfinite(jt)
    np.testing.assert_array_equal(np.isfinite(np_(t)), fin)
    np.testing.assert_allclose(np_(t)[fin], jt[fin], rtol=1e-5, atol=1e-5)
    assert fin.mean() > 0.8  # rays from inside a closed mesh hit it (bar the excluded facet)


@pytest.mark.parametrize("sides", [8, 16], ids=["wire_32_triangles", "64_triangles"])
def test_raycast_matches_jax(sides):
    """The port's cast against JAX's `_raycast_unrolled` (<= 32 triangles,
    the wire) or single-chunk `_raycast_broadcast` (33-256), and kernel A's
    in-kernel cast (`tri_cast`) against the Pallas kernel's `_tri_raycast`."""
    import jax.numpy as jnp

    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.geometry.domain import build_domain as j_dom
    from nanokappa_tpu.ops.megastep import _tri_raycast
    from nanokappa_tpu.ops.raycast import UNROLL_MAX, _raycast_broadcast, _raycast_unrolled
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.ops.raycast import raycast, tri_cast, tri_table

    kw = dict(WIRE, dimensions=(4e3, 500.0, sides))
    jd, td = j_dom(**kw), build_domain(**kw)
    jg, tg = j_geo(jd), build_device_geometry(td, device="cpu")
    F = int(tg.tri_origin.shape[0])
    assert F == 4 * sides
    pos, vel, exclude = _rays(td, 4000, seed=sides)
    jcast = _raycast_unrolled if F <= UNROLL_MAX else _raycast_broadcast
    jt, jf = jcast(jg, jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(exclude))
    t, f = raycast(tg, torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(exclude))
    _close_casts(t, f, jt, jf)

    tables = dict(
        tri_o=np.asarray(jg.tri_origin), tri_e1=np.asarray(jg.tri_e1),
        tri_e2=np.asarray(jg.tri_e2), tri_f=np.asarray(jg.tri_facet),
    )
    split = [jnp.asarray(c) for c in pos.T], [jnp.asarray(c) for c in vel.T]
    kt, kf = _tri_raycast(*split, jnp.asarray(exclude), tables, jnp.ones(len(pos), bool))
    t, f = tri_cast(
        tri_table(tg), list(torch.as_tensor(pos.T)), list(torch.as_tensor(vel.T)),
        torch.as_tensor(exclude),
    )
    _close_casts(t, f, kt, kf)


def test_raycast_beyond_256_triangles_raises():
    """Beyond 256 triangles the dispatch takes kernel E; beyond its 512
    chunks (65,536 triangles) it took ROADMAP item 11's raise, and now
    takes the v1 step's chunked dense cast (no raise): the wire's 32
    triangles tiled to 65,568 give the wire's own hits (a tie across
    chunks keeps the earlier triangle)."""
    import dataclasses

    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.ops.raycast import raycast

    dom = build_domain(**WIRE)
    geo = build_device_geometry(dom, device="cpu")
    reps = 65568 // 32
    big = dataclasses.replace(geo, **{k: getattr(geo, k).repeat((reps,) + (1,) * (getattr(geo, k).dim() - 1))
                                      for k in ("tri_origin", "tri_e1", "tri_e2", "tri_facet")})
    pos, vel, exclude = (torch.as_tensor(x) for x in _rays(dom, 64, seed=5))
    t, f = raycast(big, pos, vel, exclude)
    want_t, want_f = raycast(geo, pos, vel, exclude)
    assert torch.equal(t, want_t) and torch.equal(f, want_f)
