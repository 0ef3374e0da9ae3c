"""The step's route (sim/fused.py build_route) on the configurations the
suite builds, every field against a literal:

  * the film: the slim layout on the z walls' mirror, kernel F's rounds;
  * the k film at eta = 0 (the k model on craft_kmirror's tables): the
    full layout with the degenerate split drawn at cache fill;
  * the wire: the plain layout with kernel A's in-kernel diffuse branch,
    the torch rounds (its triangles), the event window at its floor;
  * the large mesh (the 96-sided cylinder): kernel A's cast off, the
    kinetic event window over every boundary hit;
  * the plate on Voronoi centres: in-kernel diffuse, the torch rounds;
  * the star under radial temperatures: the v1 step, with the JAX
    package's reason, and its event compaction's width;
and init_state builds the pool of the layout the route names.
"""

import dataclasses

import pytest

from torch_parity import (
    FILM, PLATE_CENTERS, STAR, STAR_CENTERS, WIRE, craft_kmirror, patch_lloyd, perforated_plate, plate_kw,
)

CYL = dict(
    geometry="cylinder", dimensions=(2e3, 500.0, 96), subvolumes=("slice", 2, 2),
    bound_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
    bound_cond=("T", "T", "R"), bound_values=(302.0, 298.0, 0.0),
)

# (step, v1_reason, layout, flip_axis, kernel_cast, dkern, k_split, kernel_f, evt_cap)
ROUTES = {
    "film": ("v2", None, "slim", 2, True, False, False, True, 2048),
    "kfilm0": ("v2", None, "full", None, True, False, True, True, 2048),
    "wire": ("v2", None, "plain", None, True, True, False, False, 512),
    "bigmesh": ("v2", None, "plain", None, False, False, False, False, 1089),
    "plate": ("v2", None, "plain", None, True, True, False, False, 512),
    "star": ("v1", "temp_interp='radial' on voronoi subvolumes needs the XLA path",
             "plain", None, False, False, False, False, 2048),
}


def _config(name, monkeypatch, tmp_path):
    from nanokappa_torch.geometry import stl
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.state import SimParams, particle_count

    scat, interp, mesh = "velocity", "nearest", (4, 4, 4)
    if name in ("plate", "star"):
        patch_lloyd(monkeypatch, PLATE_CENTERS if name == "plate" else STAR_CENTERS, equal_volumes=True)
    if name == "plate":
        path = str(tmp_path / "plate.stl")
        stl.save_stl(perforated_plate(), path)
        kw = plate_kw(path)
    else:
        kw = {"film": FILM, "kfilm0": FILM, "wire": WIRE, "bigmesh": CYL, "star": STAR}[name]
    if name == "kfilm0":
        scat, mesh = "k", (6, 6, 6)
    if name == "star":
        interp = "radial"
    mat = synthetic_material(mesh=mesh)
    dom = build_domain(**kw)
    n_p, rho = particle_count(("total", 3000), mat, dom)
    params = SimParams(dt=1.0, n_cap=32768, inj_cap=512, temp_interp=interp, res_gen="pooled",
                       particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
                       scat_model=scat)
    geo = build_device_geometry(dom, device="cpu")
    btab = build_boundary_tables(mat, dom, scat, device="cpu")
    if name == "kfilm0":
        btab = craft_kmirror(btab, build_boundary_tables(mat, dom, device="cpu"))
    return mat, dom, geo, btab, params, n_p


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_of_each_configuration(name, monkeypatch, tmp_path):
    from nanokappa_torch.sim.fused import build_route
    from nanokappa_torch.sim.state import init_state

    mat, dom, geo, btab, params, n_p = _config(name, monkeypatch, tmp_path)
    route = build_route(geo, btab, params, mat.device_tables("cpu"))
    got = tuple(getattr(route, f.name) for f in dataclasses.fields(route))
    assert got == ROUTES[name], got
    assert route.mirror == (route.layout != "plain")
    # the host Material gives the same route, and init_state its layout
    assert build_route(geo, btab, params, mat) == route
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=3, host_only=True)
    assert state.layout == route.layout
