"""The port's host layer against the JAX package's: the NumPy-only builders
were copied with only their import prefix changed, so the same inputs must
give BIT-EQUAL arrays — material, domain, device geometry, boundary and
reservoir tables, the initial state — and the port must import without jax.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import FILM, FILM_FULL, assert_same, build_pair, jax_fields

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    return build_pair(FILM)


@pytest.mark.parametrize("mesh", [(4, 4, 4), (6, 6, 6)])
def test_material_bit_equal(mesh):
    from nanokappa_tpu.material import synthetic_material as j_mat
    from nanokappa_torch.material import synthetic_material

    a, b = j_mat(mesh=mesh), synthetic_material(mesh=mesh)
    assert_same(vars(a), vars(b), "Material")
    # device tables: same names, same float32 rounding
    ja, tb = a.device_tables(), b.device_tables("cpu")
    for f in dataclasses.fields(tb):
        assert_same(getattr(ja, f.name), getattr(tb, f.name), f"MaterialTables.{f.name}")


@pytest.mark.parametrize("kw", [FILM, FILM_FULL], ids=["film", "film_full"])
def test_domain_and_geometry_bit_equal(kw):
    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.geometry.domain import build_domain as j_dom
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain

    a, b = j_dom(**kw), build_domain(**kw)
    for f in dataclasses.fields(b):
        assert_same(getattr(a, f.name), getattr(b, f.name), f"Domain.{f.name}")
    ga, gb = j_geo(a), build_device_geometry(b, device="cpu")
    for f in dataclasses.fields(gb):
        assert_same(getattr(ga, f.name), getattr(gb, f.name), f"DeviceGeometry.{f.name}")


def test_boundary_tables_bit_equal(pair):
    from nanokappa_tpu.sim import boundary_tables as jbt
    from nanokappa_torch.sim import boundary_tables as tbt

    j, t = pair
    for f in dataclasses.fields(t.btab):
        assert_same(getattr(j.btab, f.name), getattr(t.btab, f.name), f"BoundaryTables.{f.name}")
    assert_same(j.btab._host, t.btab._host, "BoundaryTables._host")
    assert_same(
        jbt.combined_mirror_rows(j.btab, j.tabs), tbt.combined_mirror_rows(t.btab, t.tabs)
    )
    assert jbt.slim_mirror_axis(j.geo, j.btab, j.tabs) == tbt.slim_mirror_axis(t.geo, t.btab, t.tabs) == 2


def test_mirror_gate_matches(pair):
    from nanokappa_tpu.sim.fused import autosize_evt_cap as j_evt, mirror_eligible as j_me
    from nanokappa_torch.sim.fused import autosize_evt_cap, mirror_eligible

    j, t = pair
    assert j_me(j.geo, j.btab, j.params, j.tabs) and mirror_eligible(t.geo, t.btab, t.params, t.tabs)
    N = t.params.n_cap
    assert j_evt(j.geo, j.tabs, j.params, True, N, btab=j.btab) == autosize_evt_cap(
        t.geo, t.tabs, t.params, True, N, btab=t.btab
    )


def test_reservoir_tables_bit_equal(pair):
    from nanokappa_tpu.sim.reservoir import autosize_c_max as j_cm, autosize_inj_cap as j_ic
    from nanokappa_torch.sim.reservoir import autosize_c_max, autosize_inj_cap

    j, t = pair
    for f in dataclasses.fields(t.rtab):
        assert_same(getattr(j.rtab, f.name), getattr(t.rtab, f.name), f"ReservoirTables.{f.name}")
    assert j_ic(j.rtab) == autosize_inj_cap(t.rtab)
    assert j_cm(j.rtab) == autosize_c_max(t.rtab)


@pytest.mark.parametrize("n", [1000, 5000, 40000, 70000])
def test_round_pool_cap_matches(n):
    from nanokappa_tpu.sim.state import round_pool_cap as j_round
    from nanokappa_torch.sim.state import round_pool_cap

    assert j_round(n) == round_pool_cap(n)


def test_init_state_matches_jax(pair):
    """Same seed, same NumPy draws: the port's (18, N) pool is the JAX
    package's packed rows + slim mirror columns, bit for bit (the first ray
    cast included: the same float32 slab arithmetic)."""
    from nanokappa_torch.convert import state_from_jax, state_to_jax

    j, t = pair
    conv = state_from_jax(jax_fields(j.state), "slim", device="cpu")
    assert_same(conv.pool, t.state.pool, "pool")
    for name in ("T_sv", "Np_sv", "T_tau", "n_leaving", "lost", "frozen"):
        assert_same(getattr(conv, name), getattr(t.state, name), name)
    assert_same(conv.res_counter, t.state.res_counter, "res_counter")
    # and back: the full mirror cache is rebuilt exactly from the slim rows
    back = state_to_jax(t.state, flip_axis=2)
    alive = np.asarray(j.state.alive)
    assert_same(back["packed"], np.asarray(j.state.packed), "packed")
    assert_same(back["mirror"][alive], np.asarray(j.state.mirror)[alive], "mirror")


def test_tables_convert_from_jax(pair):
    from nanokappa_torch.convert import tables_from_jax
    from nanokappa_torch.geometry.device import DeviceGeometry
    from nanokappa_torch.material.tables import MaterialTables
    from nanokappa_torch.sim.boundary_tables import BoundaryTables
    from nanokappa_torch.sim.reservoir import ReservoirTables

    j, t = pair
    for cls, a, b in (
        (MaterialTables, j.tabs, t.tabs), (DeviceGeometry, j.geo, t.geo),
        (BoundaryTables, j.btab, t.btab), (ReservoirTables, j.rtab, t.rtab),
    ):
        c = tables_from_jax(cls, jax_fields(a), device="cpu")
        for f in dataclasses.fields(cls):
            assert_same(getattr(c, f.name), getattr(b, f.name), f"{cls.__name__}.{f.name}")


def test_port_imports_without_jax():
    """`import nanokappa_torch.sim.step`, the kernels, the driver and the
    CLI with jax blocked: the port never reaches jax or the JAX package."""
    code = (
        "import sys\n"
        "for k in [k for k in sys.modules if k == 'jax' or k.startswith('jax.')]:\n"
        "    del sys.modules[k]\n"
        "sys.modules['jax'] = None\n"
        "import nanokappa_torch.sim.step, nanokappa_torch.convert\n"
        "import nanokappa_torch.ops.megastep, nanokappa_torch.ops.compact_pool\n"
        "import nanokappa_torch.ops.compact, nanokappa_torch.material\n"
        "import nanokappa_torch.ops.raycast, nanokappa_torch.sim.reservoir\n"
        "import nanokappa_torch.sim.fused, nanokappa_torch.sim.cascade\n"
        "import nanokappa_torch.sim.state, nanokappa_torch.sim.scatter\n"
        "import nanokappa_torch.ops.raycast_large, nanokappa_torch.sim.repair\n"
        "import nanokappa_torch.driver, nanokappa_torch.cli, nanokappa_torch.io.trace\n"
        "bad = [k for k in sys.modules if k.startswith('nanokappa_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")},
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_no_jax_import_in_port_sources():
    pkg = os.path.join(ROOT, "nanokappa_torch")
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as fh:
                    for line in fh:
                        s = line.strip()
                        if s.startswith(("import jax", "from jax")) or "nanokappa_tpu import" in s \
                                or s.startswith("from nanokappa_tpu") or s.startswith("import nanokappa_tpu"):
                            offenders.append(f"{path}: {s}")
    assert not offenders, offenders
