"""Kernels A, B, C, D and E timed on the card at the main paths' shapes,
for one checkout of the port: the comparison of two versions in one call.

    python scripts/torch_kernel_bench.py [--root DIR] [--label NAME] [--only a,b,c,d,e]

Imports `nanokappa_torch` from DIR (default: this checkout; a `git archive`
of another commit unpacked into a git-ignored directory gives the other
version) and this checkout's chip_smoke.py helpers, builds the kernels
(printing ptxas's register and spill report), then on the 31^3 material at
10^6 particles:

  * kernel A on the film's pool (slim, slice/nearest), under linear T, on
    the 16 x 4 x 4 grid (256 centres), on the film's pool with a crafted
    24-row mirror cache (box/full/slice, the k film eta = 0's
    instantiation), on the wire's pool (triangle cast,
    in-kernel diffuse), on the wire's pool with a crafted 24-row mirror
    cache (triangle/full), on the k film's pool (box/plain/linear) and on
    the perforated plate's pool re-binned by a 2 x 2 x 2 grid
    (triangle/plain/centre 8; chip_smoke.py runs the Voronoi plate): each
    held against its plain twin (chip_smoke.check_megastep), two launches
    held bit for bit alike, and its pool's divergence shares: the lanes
    whose flight ends at a wall this step (t_coll <= remaining, or fresh)
    and the 32-lane warps that hold at least one;
  * kernel E on rays inside the bench's 96-sided cylinder (random, a third
    aimed at vertices, some with zero velocity components or an excluded
    facet) at the large mesh's four widths, against its twin, with the
    launch shape (G threads a ray) where the checkout has one;
  * kernel C at the main paths' four widths (the film's survivors 2,048 ->
    512, the wire's constant lattice 1,072,476 -> 5,120, the identity at
    inj_cap 5,120 -> 5,120 that the parent still runs, the star's v1
    events 1,277,952 -> 79,872), each mask at its typical True count;
  * kernel D at the star's event buffer (79,872 lanes, 48,176 ascending
    valid ones ~26 apart, 16 rows, a 1,277,952-lane bit-hazard pool),
    L2-warm (one target) and L2-cold (chip_smoke.device_timed_cold), with
    its sector floor (chip_smoke.sector_floor) beside its byte bound;
  * kernel B on a 16-row pool of 1,277,952 lanes, 78% alive;

each kernel timed by its device time per call (chip_smoke.device_timed: the
calls enqueued behind a spin kernel, so their kernels run back to back
between the events) and by the rate of calls issued back to back between
CUDA events (which includes the wrapper's host work where that is the
longer; for B, C and D the median of 5 runs of 20 calls); after every
timing, each call split by kernel name under torch.profiler, with its
kernel launches a call (last, as its hooks may outlive the session). `--only` picks kernels (A and E build the 31^3
material and their contexts, ~1 min; B, C and D need only their buffers).

Prints one `bench ` line per measurement and a JSON summary line. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E_WIDTHS = (3304, 5120, 52805, 1277952)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_megastep(cs, name, pool, T_sv, cfg, seed, ops, rows, splits):
    """chip_smoke.check_megastep: the twin, two launches alike, the time
    and the pool's divergence shares; its call queued for the split."""
    rec = cs.check_megastep(name, pool, T_sv, cfg, seed, ops)
    row = {k: rec[k] for k in ("ms", "event_ms", "bound_ms", "plain_ms", "lane_share", "warp_share",
                               "match") if k in rec}
    row["name"] = name
    print("bench " + json.dumps(row), flush=True)
    rows.append(row)
    splits.append((row, rec["split"]))


def cylinder_rays(geo, n, device, seed=3):
    import numpy as np
    import torch

    from nanokappa_torch.geometry.device import host

    rng = np.random.default_rng(seed)
    b = host(geo.bounds).astype(np.float64)
    mid = (b[0] + b[1]) / 2
    a, r = 2 * np.pi * rng.random(n), 240.0 * np.sqrt(rng.random(n))
    pos = np.stack([mid[0] + r * np.cos(a), mid[1] + r * np.sin(a), rng.uniform(b[0, 2] + 5, b[1, 2] - 5, n)], 1)
    vel = rng.normal(0.0, 40.0, (n, 3))
    vel[0::11, 2] = 0.0
    vel[1::11, :2] = 0.0
    ex = np.full(n, -1, np.int32)
    ex[2::7] = rng.integers(0, int(host(geo.tri_facet).max()) + 1, len(ex[2::7]))
    o, e1, e2 = host(geo.tri_origin), host(geo.tri_e1), host(geo.tri_e2)
    verts = np.concatenate([o, o + e1, o + e2])
    aim = np.arange(0, n, 3)
    tgt = verts[rng.integers(0, len(verts), len(aim))]
    pos[aim, 2] = tgt[:, 2]
    vel[aim] = (tgt - pos[aim]) / 5.0
    ex[aim] = -1
    f = lambda z: torch.as_tensor(np.asarray(z, np.float32), device=device)  # noqa: E731
    return f(pos), f(vel), torch.as_tensor(ex, device=device)


def bench_raycast(cs, geo, device, rows, splits):
    import torch

    from nanokappa_torch.ops import raycast_large as rl

    tabs = rl.prep(geo)
    pos, vel, ex = cylinder_rays(geo, max(E_WIDTHS), device)
    for n in E_WIDTHS:
        p, v, e = pos[:n], vel[:n], ex[:n]
        tk, fk = rl.raycast_large(geo, p, v, e)
        tp, fp = rl.raycast_large_plain(tabs, p, v, e)
        torch.cuda.synchronize()
        bad = int(((tk.view(torch.int32) != tp.view(torch.int32)) | (fk != fp)).sum())
        if bad:
            raise AssertionError(f"raycast_large at {n} rays: {bad} lanes differ from the twin")
        row = dict(name=f"raycast_large[{n}]", ms=cs.device_timed(lambda: rl.raycast_large(geo, p, v, e)),
                   event_ms=cs.timed(lambda r: rl.raycast_large(geo, *r), (p, v, e), 20), hits=int((fp >= 0).sum()))
        if hasattr(rl, "launch_shape"):
            row["g"] = rl.launch_shape(n)
        print("bench " + json.dumps(row), flush=True)
        rows.append(row)
        splits.append((row, lambda p=p, v=v, e=e: rl.raycast_large(geo, p, v, e)))


def calls_ms(cs, fn, x, n: int = 20, reps: int = 5) -> float:
    """The median over `reps` runs of chip_smoke.timed (n calls back to back
    between CUDA events): a host-bound call rate swings from run to run."""
    return statistics.median(cs.timed(fn, x, n) for _ in range(reps))


C_WIDTHS = (  # (name, lanes, True lanes, cap)
    ("survivors", 2048, 102, 512),
    ("lattice", 1_072_476, 3_840, 5120),
    ("inj_cap", 5120, 3_917, 5120),
    ("v1 events", 1_277_952, 48_176, 79_872),
)


def bench_compact(cs, device, rows, splits):
    """Kernel C at each width against its twin: device time, calls back to
    back, the bound; its launch split queued."""
    import numpy as np
    import torch

    from nanokappa_torch.ops import compact

    rng = np.random.default_rng(11)
    for name, n, k, cap in C_WIDTHS:
        m = np.zeros(n, bool)
        m[np.sort(rng.choice(n, k, replace=False)) if name != "inj_cap" else np.arange(k)] = True
        m = torch.as_tensor(m, device=device)
        ik, nk = compact.compact_indices(m, cap)
        ip, npl = compact.compact_indices_plain(m, cap)
        torch.cuda.synchronize()
        if not (torch.equal(ik, ip) and int(nk) == int(npl)):
            raise AssertionError(f"compact_indices[{name}] differs from its twin")
        row = dict(name=f"compact_indices[{name}]",
                   ms=cs.device_timed(lambda: compact.compact_indices(m, cap)),
                   event_ms=calls_ms(cs, lambda x: compact.compact_indices(x, cap), m),
                   bound_ms=cs.bound(n + 4 * cap + 4, 0)[0], n=n, true=k, cap=cap)
        print("bench " + json.dumps(row), flush=True)
        rows.append(row)
        splits.append((row, lambda m=m, cap=cap: compact.compact_indices(m, cap)))


def star_events(device, E=79_872, N=1_277_952, C=16, n=48_176, seed=6):
    """The star's event buffer: a (C, N) bit-hazard pool, (C, E) rows and n
    ascending unique lanes, then the sentinel N."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def hazard(width):
        x = rng.normal(size=(C, width)).astype(np.float32)
        x.view(np.int32)[[9, 10, 12, 15]] = rng.integers(-2, 300, (4, width))
        return torch.as_tensor(x, device=device)

    idx = np.full(E, N, np.int32)
    idx[:n] = np.sort(rng.choice(N, n, replace=False))
    return hazard(N), hazard(E), torch.as_tensor(idx, device=device), n


def bench_scatter(cs, device, rows, splits):
    """Kernel D at the star's event buffer against its twin: L2-warm and
    L2-cold device time, calls back to back, byte bound and sector floor."""
    import torch

    from nanokappa_torch.ops import scatter_rows as sr

    pool, upd, idx, n = star_events(device)
    C, N = pool.shape
    E = idx.shape[0]
    pk, pp = pool.clone(), pool.clone()
    sr.scatter_rows(pk, upd, idx)
    sr.scatter_rows_plain(pp, upd, idx)
    torch.cuda.synchronize()
    if not torch.equal(pk.view(torch.int32), pp.view(torch.int32)):
        raise AssertionError("scatter_rows differs from its twin")
    floor_ms, sectors = cs.sector_floor(idx, n, C, N)
    row = dict(name="scatter_rows[star events]", ms=cs.device_timed(lambda: sr.scatter_rows(pk, upd, idx)),
               cold_ms=cs.device_timed_cold(lambda: sr.scatter_rows(pk, upd, idx)),
               event_ms=calls_ms(cs, lambda p: sr.scatter_rows(p, upd, idx), pk),
               bound_ms=cs.bound(4 * E + 2 * n * C * 4, 0)[0], sector_floor_ms=floor_ms, sectors=sectors)
    print("bench " + json.dumps(row), flush=True)
    rows.append(row)
    splits.append((row, lambda: sr.scatter_rows(pk, upd, idx)))


def bench_pool(cs, device, rows, splits):
    """Kernel B on a 16-row, 1,277,952-lane pool against its twin."""
    import numpy as np
    import torch

    from nanokappa_torch.ops import compact_pool

    rng = np.random.default_rng(12)
    pool = rng.normal(size=(16, 1_277_952)).astype(np.float32)
    pool.view(np.int32)[[9, 10, 12, 15]] = rng.integers(-2, 300, (4, pool.shape[1]))
    pool[14] = (rng.random(pool.shape[1]) < 0.78).astype(np.float32)
    pool = torch.as_tensor(pool, device=device)
    out = torch.empty_like(pool)
    a, ta = compact_pool.compact_pool(pool, out)
    b, tb = compact_pool.compact_pool_plain(pool)
    torch.cuda.synchronize()
    if int(ta) != int(tb) or not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError("compact_pool differs from its twin")
    row = dict(name="compact_pool[16 rows]", ms=cs.device_timed(lambda: compact_pool.compact_pool(pool, out)),
               event_ms=calls_ms(cs, lambda p: compact_pool.compact_pool(p, out), pool),
               bound_ms=cs.bound(2 * 16 * pool.shape[1] * 4, 0)[0])
    print("bench " + json.dumps(row), flush=True)
    rows.append(row)
    splits.append((row, lambda: compact_pool.compact_pool(pool, out)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--only", default="a,b,c,d,e", help="kernels to time, comma-separated")
    args = ap.parse_args()
    only = set(args.only.lower().split(","))
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_bench: needs a CUDA card")
    cs = _chip_smoke()
    import nanokappa_torch
    from nanokappa_torch.ops import _cuda

    card = cs.card_line()
    print(f"{card}; package {os.path.dirname(nanokappa_torch.__file__)} ({args.label})", flush=True)
    t0 = time.perf_counter()
    _cuda.library(verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    device = torch.device("cuda:0")
    rows: list[dict] = []
    splits: list = []
    if "c" in only:
        bench_compact(cs, device, rows, splits)
    if "d" in only:
        bench_scatter(cs, device, rows, splits)
    if "b" in only:
        bench_pool(cs, device, rows, splits)
    if "a" in only:
        bench_kernel_a(cs, device, rows, splits)
    if "e" in only:
        from nanokappa_torch.geometry.device import build_device_geometry
        from nanokappa_torch.geometry.domain import build_domain

        b_geo = build_device_geometry(build_domain(**dict(cs.BIGMESH, subvolumes=("slice", 1, 2))), device)
        bench_raycast(cs, b_geo, device, rows, splits)
    for row, fn in splits:
        counts: dict[str, float] = {}
        row["split_us"] = cs.launch_split(fn, counts=counts)
        row["per_call"] = sum(counts.values())
        print(f"bench split {row['name']}: {row['split_us']}, kernel launches a call {row['per_call']:g}",
              flush=True)
    print(json.dumps({"label": args.label, "card": card, "rows": rows}), flush=True)


def bench_kernel_a(cs, device, rows, splits):
    """Kernel A's branches on the 31^3 material's pools (see the module
    docstring)."""
    import tempfile

    import torch

    from nanokappa_torch.geometry import stl
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops.megastep import mega_config
    from nanokappa_torch.sim.boundary_tables import slim_mirror_axis
    from nanokappa_torch.sim.fused import event_window
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, STALE, init_state
    from nanokappa_torch.sim.step import build_step

    mat = synthetic_material(mesh=(cs.MESH, cs.MESH, cs.MESH))
    tabs = mat.device_tables(device)

    def ctx(kw, res_gen, scat="velocity", **prm):
        dom, geo, btab = cs.build_ctx(mat, kw, device, scat)
        n_p, rtab, params = cs.run_params(mat, dom, cs.PARTICLES, res_gen, device)
        params = dataclasses.replace(params, **prm)
        st = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=cs.SEED + 1)
        build_step(geo, tabs, btab, rtab, params, n_inner=10)(st)
        return dom, geo, btab, params, st, event_window(geo, tabs, btab, params)

    def n_fresh(pool):
        return int(((pool[C_CF].view(torch.int32) == STALE) & (pool[C_ALIVE] > 0.5)).sum())

    f_dom, f_geo, f_btab, f_params, f_st, f_evt = ctx(cs.FILM, "pooled")
    f_pool = cs.with_fresh(f_st.pool, device)
    ax = slim_mirror_axis(f_geo, f_btab, tabs)
    bench_megastep(cs, "film", f_pool, f_st.T_sv, mega_config(f_geo, tabs, f_btab, f_params, f_evt, ax), 1, 0, rows, splits)
    fl = dataclasses.replace(f_params, temp_interp="linear")
    bench_megastep(cs, "film linear", f_pool, f_st.T_sv, mega_config(f_geo, tabs, f_btab, fl, f_evt, ax), 1, 0, rows, splits)
    g_dom, g_geo = cs.grid_film(f_dom, device)
    g_cx = g_geo.subvol_center[:, 0]
    g_T = (302.0 - 4.0 * (g_cx - g_cx.min()) / (g_cx.max() - g_cx.min())).contiguous()
    g_cfg = mega_config(g_geo, tabs, f_btab, f_params, f_evt, ax)
    bench_megastep(cs, "film centre 256", f_pool, g_T, g_cfg, 1, 0, rows, splits)
    ff = cs.crafted_full_pool(f_pool[:16].contiguous(), f_st.T_sv, tabs, 1)
    bench_megastep(cs, "film full (crafted)", ff, f_st.T_sv,
                   mega_config(f_geo, tabs, f_btab, f_params, f_evt, layout="full"), 1, 0, rows, splits)

    del f_st, f_pool, ff

    w_dom, w_geo, w_btab, w_params, w_st, w_evt = ctx(cs.WIRE, "constant")
    w_pool = cs.with_fresh(w_st.pool, device)
    w_cfg = mega_config(w_geo, tabs, w_btab, w_params, w_evt)
    ops = n_fresh(w_pool) * 45 * w_cfg.tris.shape[0]
    bench_megastep(cs, "wire", w_pool, w_st.T_sv, w_cfg, 2, ops, rows, splits)

    wf = cs.crafted_full_pool(w_pool, w_st.T_sv, tabs, 2)
    bench_megastep(cs, "wire full (crafted)", wf, w_st.T_sv,
                   mega_config(w_geo, tabs, w_btab, w_params, w_evt, layout="full"), 2, ops, rows, splits)
    del w_st, w_pool, wf

    k = ctx(cs.KFILM, "pooled", "k", temp_interp="linear", scat_model="k")
    k_pool = cs.with_fresh(k[4].pool, device)
    bench_megastep(cs, "k film linear", k_pool, k[4].T_sv, mega_config(k[1], tabs, k[2], k[3], k[5]), 4, 0, rows, splits)
    del k, k_pool

    stl_path = os.path.join(tempfile.mkdtemp(prefix="kernel_bench_plate_"), "plate.stl")
    stl.save_stl(cs.perforated_plate(), stl_path)
    p = ctx(dict(cs.PLATE, geometry=stl_path, subvolumes=("grid", 2, 2, 2)), "constant")
    p_pool = cs.with_fresh(p[4].pool, device)
    p_cfg = mega_config(p[1], tabs, p[2], p[3], p[5])
    ops = n_fresh(p_pool) * 45 * p_cfg.tris.shape[0]
    bench_megastep(cs, "plate grid 8", p_pool, p[4].T_sv, p_cfg, 5, ops, rows, splits)

    del p, p_pool
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
