"""Kernel F's Python side on the CPU: which configurations run the narrow
rounds through it, its tables, and the plain path it leaves on a CPU
tensor. The kernel itself runs on the card only
(tests/test_torch_gpu.py::test_cuda_event_round_matches_plain holds it bit
for bit against the torch rounds there)."""

import numpy as np
import pytest
import torch

from torch_parity import FILM, WIRE, narrow_case, narrow_rows, patch_lloyd, perforated_plate, plate_kw


def _step_kernel(domain_kw, monkeypatch, **params):
    """The `kernel` the film's v2 step hands to run_event_buffer, on the
    CPU, over one step (None: the torch rounds)."""
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops.compact_pool import compact_pool_plain
    from nanokappa_torch.sim import fused
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.reservoir import build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count

    mat = synthetic_material(mesh=(4, 4, 4))
    dom = build_domain(**domain_kw)
    n_p, rho = particle_count(("total", 1000), mat, dom)
    p = SimParams(dt=1.0, n_cap=2048, inj_cap=256, res_gen="constant", particle_density=rho,
                  n_active_modes=mat.n_active_modes, t_reference=300.0, **params)
    geo = build_device_geometry(dom, "cpu")
    btab = build_boundary_tables(mat, dom, device="cpu")
    rtab = build_reservoir_tables(mat, dom, p.dt, rho, device="cpu")
    state = init_state(mat, dom, geo, p, n_p, btab, temp_dist="linear", seed=3)
    state.pool, tail = compact_pool_plain(state.pool)  # the runner's entry compaction
    state.tail = int(tail)
    seen = []
    plain = fused.run_event_buffer

    def spy(*a, kernel=None, **k):
        seen.append(kernel)
        return plain(*a, kernel=kernel, **k)

    monkeypatch.setattr(fused, "run_event_buffer", spy)
    fused.make_step_v2(geo, mat.device_tables("cpu"), btab, rtab, p)(state)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("name", ["film", "film linear", "film grid", "wire", "plate"])
def test_path_choice(name, monkeypatch, tmp_path):
    """The film's box on slices (nearest or linear T) takes kernel F; the
    wire's and the plate's triangles and the film on grid centres take the
    torch rounds."""
    from nanokappa_torch.geometry import stl
    from nanokappa_torch.ops.event_round import RoundTables

    if name == "plate":
        patch_lloyd(monkeypatch, equal_volumes=True)
        path = str(tmp_path / "plate.stl")
        stl.save_stl(perforated_plate(), path)
        kw = plate_kw(path)
    else:
        kw = {"film": FILM, "film linear": FILM, "wire": WIRE,
              "film grid": dict(FILM, subvolumes=("grid", 2, 2, 2))}[name]
    kernel = _step_kernel(kw, monkeypatch, temp_interp="linear" if name == "film linear" else "nearest")
    if name in ("film", "film linear"):
        assert isinstance(kernel, RoundTables) and kernel.linear == (name == "film linear")
    else:
        assert kernel is None


def test_cpu_tensor_takes_the_plain_path():
    """On a CPU buffer the kernel's tables change nothing: the torch rounds
    run, bit for bit, the generator advances alike, no launch is counted."""
    from nanokappa_torch.ops import event_round
    from nanokappa_torch.sim.cascade import run_event_buffer

    case = narrow_case("cpu", dt=150.0)
    rows, vbuf = narrow_rows(case, n_live=400, seed=3)
    tabs = event_round.round_tables(case.geo, case.tabs, case.btab, case.params)
    args = (case.geo, case.tabs, case.btab, case.params)
    before = event_round.launches
    gk, gp = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    ok, lk, *ck = run_event_buffer(rows, vbuf, *args, gk, case.T_sv, 8, kernel=tabs)
    op, lp, *cp = run_event_buffer(rows, vbuf, *args, gp, case.T_sv, 8)
    assert event_round.launches == before
    assert torch.equal(ok.view(torch.int32), op.view(torch.int32))
    assert torch.equal(lk, lp) and [int(x) for x in ck] == [int(x) for x in cp]
    assert torch.equal(gk.get_state(), gp.get_state())
    assert int(cp[0]) > 0  # chains reached k_max: the quarantine ran


def test_round_tables_follow_the_geometry():
    """The facet table carries each facet's kind, reservoir, pair, value,
    normal, shift, slab plane and wall rows as the torch round reads them,
    and the slice constants give sim/binning.py subvol_id's ids."""
    from nanokappa_torch.geometry.domain import BC
    from nanokappa_torch.ops import event_round as ev
    from nanokappa_torch.sim.binning import subvol_id

    case = narrow_case("cpu")
    geo, btab = case.geo, case.btab
    t = ev.round_tables(geo, case.tabs, btab, case.params)
    tab = t.facets.numpy()
    ints = tab.view(np.int32)
    bc = geo.facet_bc.numpy()
    want = np.select([(bc == int(BC.TEMPERATURE)) | (bc == int(BC.FLUX)), bc == int(BC.PERIODIC),
                      bc == int(BC.ROUGH)], [1, 2, 3], 0)
    np.testing.assert_array_equal(ints[:, ev.RF_KIND], want)
    np.testing.assert_array_equal(ints[:, ev.RF_RES], geo.facet_res.numpy())
    np.testing.assert_array_equal(ints[:, ev.RF_PAIR], geo.periodic_pair.numpy())
    np.testing.assert_array_equal(ints[:, ev.RF_AXIS], geo.box_axis.numpy())
    for col, src in ((ev.RF_NORMAL, geo.facet_normal), (ev.RF_SHIFT, geo.periodic_shift)):
        np.testing.assert_array_equal(tab[:, col:col + 3], src.numpy())
    rough = np.nonzero(bc == int(BC.ROUGH))[0]
    fr = geo.facet_rough.numpy()[rough]
    np.testing.assert_array_equal(ints[rough, ev.RF_ROW], btab.row_of_rough.numpy()[fr])
    np.testing.assert_array_equal(ints[rough, ev.RF_ROWB], btab.row_back.numpy()[fr])
    # the kernel's slice id: floor((x - lo) / length) in float32, clamped
    lo, hi = geo.bounds.numpy()[:, t.slice_axis]
    x = np.concatenate([np.linspace(lo, hi, 4001, dtype=np.float32), [lo - 1.0, hi + 1.0]]).astype(np.float32)
    ids = np.clip(np.floor((x - np.float32(t.lo)) / np.float32(t.length)), 0, t.n_sv - 1)
    pos = torch.zeros((x.shape[0], 3))
    pos[:, t.slice_axis] = torch.as_tensor(x)
    np.testing.assert_array_equal(ids.astype(np.int32), subvol_id(geo, pos).numpy())
