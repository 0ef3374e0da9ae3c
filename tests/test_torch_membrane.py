"""Two-sided internal membranes (tests/test_interfaces.py) in the port,
against the JAX package, module by module on the CPU:

  1. geometry/mesh.py and stl.py: membrane detection on the single and the
     doubled sheet and the STL round trip give the JAX package's faces,
     facets, normals, volume and containment;
  2. geometry/domain.py: an interior probe point picks the membrane facet
     and gives it its BC and eta, as in the JAX domain;
  3. sim/boundary_tables.py: every table of the membrane box is bit-equal
     to the JAX package's; the front row's diffuse support has v.n < 0 and
     the back row's v.n > 0;
  4. sim/fused.py dkern_facet_tables and kernel A's partner mask: the facet
     rows (front and back), `two_sided` and the mask words equal the JAX
     `_dkern_facet_tables` and `dkern_mode_rows`;
  5. kernel A's plain twin (the kernel's oracle on the card) on lanes that
     reach the membrane from both sides: with the membrane's eta zeroed a
     lane is flagged specular exactly where its mode has a partner at the
     row of the side it comes from (tests/torch_parity.py
     aim_at_rough_facets, `back=True` for the back side); at eta = 10 and
     eta = 2 no re-emitted mode crosses the wall, every new mode lies in
     its side's creation support, the re-emitted modes of each side follow
     that row's creation weights (total-variation distance within 3x its
     expectation, tests/test_diffuse_kernel.py:91-116) and the specular
     share the lanes' flux-weighted specularity (4 binomial sigma). The
     draws differ from the Pallas presample stream, so nothing is compared
     per draw;
  6. the watertight membrane (tests/test_interfaces.py:176): with every
     facet at eta = 10 and no reservoirs, each side's Np_sv is the same
     after 25 steps as after the first 5, on the port's v1 step (the JAX
     test's n_cap = 1.5 N, not a whole number of tiles) and on its v2
     step (round_pool_cap, the driver's pool); and the membrane STL
     through `python -m nanokappa_torch.cli` with the JAX CLI's flags.
The narrow rounds' back row and the transport step against the JAX
package are in tests/test_torch_membrane_steps.py. The material is the 6^3 synthetic table throughout. Step counts are the
JAX tests' own, save the CLI run's 50 steps.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_parity import membrane_box, membrane_kw, membrane_lanes, np_


TABLE_KEYS = (
    "row_back", "row_of_rough", "diffuse_cdf", "specularity", "corr",
    "spec2", "diff2", "diffuse_prob", "diffuse_alias",
)


@pytest.fixture(scope="module")
def stl_path(tmp_path_factory):
    from nanokappa_torch.geometry import stl

    path = str(tmp_path_factory.mktemp("membrane") / "membrane.stl")
    stl.save_stl(membrane_box(doubled=True), path)
    return path


@pytest.fixture(scope="module")
def mats():
    from nanokappa_tpu.material import synthetic_material as j_mat
    from nanokappa_torch.material import synthetic_material

    return j_mat(mesh=(6, 6, 6)), synthetic_material(mesh=(6, 6, 6))


def _domains(path, kind):
    from nanokappa_tpu.geometry.domain import build_domain as j_dom
    from nanokappa_torch.geometry.domain import build_domain

    kw = membrane_kw(path, kind)
    return j_dom(**kw), build_domain(**kw)


@pytest.fixture(scope="module")
def tables(stl_path, mats):
    """The membrane box of tests/test_interfaces.py:135 in both packages:
    (JAX domain, geometry, tables; the port's)."""
    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables

    jd, td = _domains(stl_path, "tables")
    return (jd, j_geo(jd), j_bt(mats[0], jd),
            td, build_device_geometry(td, device="cpu"), build_boundary_tables(mats[1], td, device="cpu"))


# ---- 1. the mesh and the STL ---------------------------------------------------


@pytest.mark.parametrize("doubled", [False, True])
def test_membrane_detection_matches_jax(doubled):
    from test_interfaces import membrane_box as j_membrane_box

    jm = j_membrane_box(doubled=doubled)
    m = membrane_box(doubled=doubled)
    assert np.array_equal(m.vertices, jm.vertices) and np.array_equal(m.faces, jm.faces)
    np.testing.assert_array_equal(m.face_is_interface, jm.face_is_interface)
    np.testing.assert_array_equal(m.facet_is_interface, jm.facet_is_interface)
    np.testing.assert_array_equal(m.interfacets, jm.interfacets)
    assert [list(f) for f in m.facets] == [list(f) for f in jm.facets]
    assert np.array_equal(m.facet_normals, jm.facet_normals)
    assert m.face_is_interface.sum() == (4 if doubled else 2) and len(m.interfacets) == 1
    assert m.n_facets == 7
    assert m.volume == jm.volume == pytest.approx(2e9, rel=1e-6)
    assert np.array_equal(m.center_mass, jm.center_mass)
    pts = np.array([[500.0, 500, 500], [1500.0, 500, 500], [2500.0, 500, 500], [1000.0, 500, 500]])
    np.testing.assert_array_equal(m.contains(pts), jm.contains(pts))
    assert m.contains(pts[:2]).all() and not m.contains(pts[2:3])[0]


def test_membrane_survives_stl_roundtrip(stl_path):
    from nanokappa_tpu.geometry import stl as j_stl
    from nanokappa_torch.geometry import stl

    m, jm = stl.load_stl(stl_path), j_stl.load_stl(stl_path)
    assert len(m.interfacets) == 1 and np.array_equal(m.interfacets, jm.interfacets)
    assert m.volume == pytest.approx(membrane_box(doubled=True).volume, rel=1e-6)
    assert np.array_equal(m.vertices, jm.vertices) and np.array_equal(m.faces, jm.faces)
    np.testing.assert_array_equal(m.face_is_interface, jm.face_is_interface)


# ---- 2. the domain: the interior probe picks the membrane ----------------------


@pytest.mark.parametrize("kind, eta", [("transport", 2.0), ("tables", 2.0), ("tight", 10.0)])
def test_membrane_probe_matches_jax(stl_path, kind, eta):
    from nanokappa_torch.geometry.domain import BC

    jd, td = _domains(stl_path, kind)
    np.testing.assert_array_equal(td.bound_cond, jd.bound_cond)
    np.testing.assert_array_equal(td.facet_values, jd.facet_values)
    np.testing.assert_array_equal(td.rough_facets, jd.rough_facets)
    np.testing.assert_array_equal(td.res_facets, jd.res_facets)
    mem = np.nonzero(td.mesh.facet_is_interface)[0]
    assert len(mem) == 1
    assert td.bound_cond[mem[0]] == BC.ROUGH and td.facet_values[mem[0]] == eta


# ---- 3. the boundary tables, bit for bit ------------------------------------------


@pytest.mark.parametrize("key", TABLE_KEYS)
def test_membrane_tables_bit_equal_jax(tables, key):
    _, _, jb, _, _, tb = tables
    a, b = np.ascontiguousarray(np.asarray(getattr(jb, key))), np.ascontiguousarray(np_(getattr(tb, key)))
    assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), key


def test_membrane_two_sided_tables(tables, mats):
    """tests/test_interfaces.py:135 on the port's tables: the membrane has
    its own back row, the boundary facets do not, and the front row's
    diffuse support points into the front region (v.n < 0), the back row's
    into the back region (v.n > 0)."""
    _, _, _, td, _, tb = tables
    mem = np.nonzero(td.mesh.facet_is_interface)[0][0]
    i_rough = int(np.nonzero(td.rough_facets == mem)[0][0])
    row_f, row_b = int(np_(tb.row_of_rough)[i_rough]), int(np_(tb.row_back)[i_rough])
    assert row_f != row_b and tb.n_rows == 8  # 6 walls at eta = 0, the membrane's 2
    for i, f in enumerate(td.rough_facets):
        if f != mem:
            assert np_(tb.row_back)[i] == np_(tb.row_of_rough)[i]
    vdn = mats[1].group_vel.reshape(-1, 3) @ td.mesh.facet_normals[mem]
    cdf = np_(tb.diffuse_cdf)
    for row, sign in ((row_f, -1.0), (row_b, +1.0)):
        support = np.diff(cdf[row], prepend=0.0) > 1e-12
        assert support.any() and np.all(sign * vdn[support] > 0.0)


# ---- 4. kernel A's facet rows and partner mask -------------------------------------


def test_facet_rows_and_mask_match_jax(tables, mats):
    from nanokappa_tpu.sim.fused import _dkern_facet_tables, dkern_mode_rows
    from nanokappa_torch.ops.megastep import FT_ROW, FT_ROWB, mega_config, partner_bitmask
    from nanokappa_torch.sim.fused import dkern_active, dkern_facet_tables, mirror_eligible
    from nanokappa_torch.sim.state import SimParams

    jd, jg, jb, td, tg, tb = tables
    jt, tt = _dkern_facet_tables(jg, jb), dkern_facet_tables(tg, tb)
    for k in ("facet_eta", "facet_row", "facet_row_back", "two_sided"):
        np.testing.assert_array_equal(np.asarray(jt[k]), np.asarray(tt[k]), err_msg=k)
    assert tt["two_sided"] is True
    mem = int(td.mesh.interfacets[0])
    assert tt["facet_row"][mem] != tt["facet_row_back"][mem]
    tabs = mats[1].device_tables("cpu")
    params = SimParams(dt=1.0, n_cap=4096, inj_cap=256, t_reference=300.0)
    assert dkern_active(tg, tb, params, tabs) and not mirror_eligible(tg, tb, params, tabs)
    cfg = mega_config(tg, tabs, tb, params, 1024)
    assert cfg.dkern and cfg.tris.shape[0] == 24 and cfg.cmask_w == 1
    ints = np_(cfg.facets).view(np.int32)
    np.testing.assert_array_equal(ints[:, FT_ROW], tt["facet_row"])
    np.testing.assert_array_equal(ints[:, FT_ROWB], tt["facet_row_back"])
    jmask = np.asarray(dkern_mode_rows(jb, mats[0].device_tables()))[:, 1].astype(np.int64)
    np.testing.assert_array_equal(partner_bitmask(tb)[:, 0].astype(np.int64), jmask)


# ---- 5. kernel A's twin on both sides of the membrane ------------------------------


def _tv_ok(creation_row, m):
    """The re-emitted modes' histogram within 3x the expected total-variation
    distance of the creation weights (tests/test_diffuse_kernel.py:91-116)."""
    M = creation_row.shape[0]
    nbins = 24
    edges = np.linspace(0, M, nbins + 1)
    h, _ = np.histogram(m, bins=edges)
    p_true = np.add.reduceat(creation_row / creation_row.sum(), edges[:-1].astype(int))
    tv = 0.5 * np.abs(h / h.sum() - p_true).sum()
    return tv < 3.0 * np.sqrt(nbins / (2 * np.pi * len(m))), tv


@pytest.mark.parametrize("kind, eta", [("tight", 10.0), ("tables", 2.0)])
def test_twin_two_sided_reemission(stl_path, mats, kind, eta):
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.ops.megastep import drift_megastep_plain, mega_config
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.fused import dkern_facet_tables
    from nanokappa_torch.sim.state import C_MODE, C_ONF, C_TCOLL, SimParams

    _, td = _domains(stl_path, kind)
    mat = mats[1]
    geo = build_device_geometry(td, device="cpu")
    btab = build_boundary_tables(mat, td, device="cpu")
    tabs = mat.device_tables("cpu")
    ft = dkern_facet_tables(geo, btab)
    per_side = 6000
    pool, side, mem, modes = membrane_lanes(td, tabs, per_side, seed=3)
    N = pool.shape[1]
    params = SimParams(dt=1.0, n_cap=N, inj_cap=256, t_reference=300.0)
    cfg = mega_config(geo, tabs, btab, params, ecap=N)
    assert cfg.facets[mem, 13] == eta
    rows, idx, counts, _, _ = drift_megastep_plain(pool, torch.full((2,), 300.0), False, cfg, seed=17)
    k = int(counts[2])
    flagged = np.zeros(N, bool)
    flagged[np_(idx[:k])] = True
    assert (np_(rows[C_TCOLL, :k]) == -2.0).all()
    assert (np_(rows[C_MODE, :k]).view(np.int32) == modes[np_(idx[:k])]).all()
    out = np_(pool)
    diffused = (out[C_ONF].view(np.int32) == mem) & ~flagged
    assert (flagged | diffused).all()  # one membrane event a lane
    assert int(counts[3]) == diffused.sum() and int(counts[4]) == flagged.sum()

    n = td.mesh.facet_normals[mem]
    row = np.where(side > 0, ft["facet_row"][mem], ft["facet_row_back"][mem])
    new_mode = out[C_MODE].view(np.int32)
    v_new = np_(tabs.omega_vel)[new_mode, 1:4].astype(np.float64) @ n
    # no re-emitted mode crosses the wall: it leaves on its own side
    assert np.all(side[diffused] * v_new[diffused] < 0.0)
    creation = btab._host["creation"]
    for r in (ft["facet_row"][mem], ft["facet_row_back"][mem]):
        m = new_mode[diffused & (row == r)]
        assert len(m) > 1000 and (creation[r, m] > 0).all()
        ok, tv = _tv_ok(creation[r], m)
        assert ok, (r, tv, len(m))
    # the specular share: the lanes' flux-weighted specularity at their row
    p = btab._host["specularity"][row, modes].astype(np.float64)
    sigma = np.sqrt((p * (1 - p)).sum()) / N
    assert abs(flagged.mean() - p.mean()) < 4 * sigma + 1e-12, (flagged.mean(), p.mean(), sigma)
    if eta == 2.0:
        assert flagged[side > 0].any() and flagged[side < 0].any()


def test_twin_reads_the_back_row(tables, mats):
    """The membrane's eta zeroed in kernel A's facet table: the Ziman
    probability is 1 wherever a partner exists, so a lane is flagged
    exactly where its mode has a partner at the row of the side it arrives
    from (front row from the front, back row from the back)."""
    from nanokappa_torch.ops.megastep import FT_ETA, drift_megastep_plain, mega_config
    from nanokappa_torch.sim.state import C_ALIVE, SimParams
    from torch_parity import aim_at_rough_facets

    _, _, _, td, tg, tb = tables
    tabs = mats[1].device_tables("cpu")
    mem = int(td.mesh.interfacets[0])
    pools, has_all = [], []
    for back in (False, True):
        pool = torch.zeros((16, 4096))
        pool[C_ALIVE] = 0.0
        N, modes, rows, has = aim_at_rough_facets(pool, td, tg, tb, per_facet=2048, seed=4 + back,
                                                  back=back, facets=[mem])
        pools.append(pool[:, :N])
        has_all.append(has)
    assert (has_all[0] != has_all[1]).any()  # the two rows' partners differ
    pool = torch.cat(pools, 1).contiguous()
    has = np.concatenate(has_all)
    params = SimParams(dt=1.0, n_cap=pool.shape[1], inj_cap=256, t_reference=300.0)
    cfg = mega_config(tg, tabs, tb, params, ecap=pool.shape[1])
    facets = cfg.facets.clone()
    facets[mem, FT_ETA] = 0.0
    cfg = dataclasses.replace(cfg, facets=facets)
    _, idx, counts, _, _ = drift_megastep_plain(pool, torch.full((2,), 300.0), False, cfg, seed=5)
    flagged = np.zeros(pool.shape[1], bool)
    flagged[np_(idx[: int(counts[2])])] = True
    assert has.any() and (~has).any()
    np.testing.assert_array_equal(flagged, has)


# ---- 6. the steps, the driver and the CLI --------------------------------------------


@pytest.mark.parametrize("step", ["v1", "v2"])
def test_membrane_watertight(stl_path, mats, step):
    """tests/test_interfaces.py:176 on the port's v1 and v2 steps."""
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.fused import build_route
    from nanokappa_torch.sim.reservoir import build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count, round_pool_cap
    from nanokappa_torch.sim.step import build_step

    _, td = _domains(stl_path, "tight")
    mat = mats[1]
    n_p, rho = particle_count(("total", 4000), mat, td)
    n_cap = int(n_p * 1.5) if step == "v1" else round_pool_cap(int(n_p * 1.25))
    params = SimParams(dt=1.0, n_cap=n_cap, inj_cap=1 << 8, evt_cap=1 << 12, particle_density=rho,
                       n_active_modes=mat.n_active_modes, t_reference=300.0)
    geo = build_device_geometry(td, device="cpu")
    btab = build_boundary_tables(mat, td, device="cpu")
    rtab = build_reservoir_tables(mat, td, params.dt, rho, device="cpu")
    assert build_route(geo, btab, params, mat.device_tables("cpu")).step == step
    state = init_state(mat, td, geo, params, n_p, btab, temp_dist="mean", seed=7)
    run = build_step(geo, mat.device_tables("cpu"), btab, rtab, params, n_inner=5)
    state, out0 = run(state)
    np0 = np_(out0.Np_sv).copy()
    for _ in range(4):
        state, out = run(state)
    assert int(out.frozen) == 0 and int(out.lost) == 0
    np.testing.assert_array_equal(np_(out.Np_sv), np0)
    assert np0.min() > 0 and np0.sum() == int(state.alive.sum())
    if step == "v2":
        assert int(state.kernel_events[0]) > 0  # kernel A re-emitted at the walls


def test_membrane_stl_through_the_cli(tmp_path, stl_path):
    """The membrane STL as --geometry through the port's CLI with the JAX
    CLI's flags (tests/test_interfaces.py:80's boundaries, 'constant'
    reservoirs): 50 steps, the result files written, the population kept,
    the slices' temperatures between the reservoirs and falling."""
    from nanokappa_torch.cli import main
    from nanokappa_torch.material import write_synthetic_hdf5

    mat_dir = str(tmp_path / "mat")
    write_synthetic_hdf5(mat_dir, mesh=(6, 6, 6))
    hdf = next(f for f in os.listdir(mat_dir) if f.endswith(".hdf5"))
    text = f"""--mat_folder {mat_dir}
--hdf_file {hdf}
--poscar_file POSCAR
--geometry {stl_path}
--subvolumes slice 4 0
--bound_pos relative -0.1 0.5 0.5 1.1 0.5 0.5 0.5 0.5 0.5
--bound_cond T T R R
--bound_values 305 295 2 0
--connect_pos relative
--temp_dist linear
--reservoir_gen constant
--particles total 4000
--timestep 1
--iterations 50
--n_mean 5
--results_folder {tmp_path / 'res'}
--output screen
--device cpu
"""
    pf = tmp_path / "membrane.txt"
    pf.write_text(text)
    main(["-ff", str(pf)])
    folders = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path) if f.startswith("res")]
    assert len(folders) == 1
    files = set(os.listdir(folders[0]))
    assert {"convergence.txt", "arguments.txt", "particle_data.txt"} <= files, files
    from nanokappa_torch.visual import read_convergence

    conv = read_convergence(os.path.join(folders[0], "convergence.txt"), 4, 2, "slice", 0)
    T = np.asarray(conv["T"])[-1]
    N = np.asarray(conv["N_p"])
    assert T.shape == (4,) and np.all((T > 295.0) & (T < 305.0)) and T[0] > T[-1], T
    assert abs(int(N[-1]) - int(N[0])) <= 0.05 * int(N[0])
