#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`nanokappa_torch`).

    python3 chip_smoke.py            # the film at 1e6 particles, 31^3 table

Needs one CUDA card. In order it:
  1. prints the card's name and power limit (nvidia-smi),
  2. builds the three hand-written kernels from `nanokappa_torch/csrc`,
  3. holds each kernel against its plain torch twin ON THE CARD at the film's
     shapes (the 18-row pool at 1e6 particles, the 2048 -> 512 event
     compaction) and times both,
  4. checks the whole film step on the card against the plain path on the
     CPU on a small deterministic film (no reservoirs, specular walls),
  5. drives the film through the library entry (init_state -> build_step ->
     run) exactly as bench.py:run_config sizes it — synthetic 31^3 material,
     10^6 particles, pool = round_pool_cap(1.25 N), pooled reservoirs,
     n_inner = n_outer = 10, 2 warm-up and 3 timed runs — with every
     kernel's launch counter zeroed just before and read just after, and
     checks the physics: nothing lost, population within 5%, every T_sv
     inside (298, 302) K and falling from the hot to the cold end.
Any failed check raises (non-zero exit). The last lines are the card line,
one JSON line with the kernels' numbers, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# the film exactly as bench.py:run_config sizes it: synthetic 31^3 table,
# 10^6 particles, seeded weights and initial state
MESH = 31
PARTICLES = 1e6
SEED = 0


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def film_ctx(mesh: int, device):
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables

    mat = synthetic_material(mesh=(mesh, mesh, mesh))
    dom = build_domain(
        geometry="box",
        dimensions=(5e3, 1e3, 1e3),
        subvolumes=("slice", 10, 0),
        bound_pos=(
            "relative",
            -0.1, 0.5, 0.5, 1.1, 0.5, 0.5, 0.5, 0.5, -0.1, 0.5, 0.5, 1.1,
        ),
        bound_cond=("T", "T", "R", "R", "P"),
        bound_values=(302.0, 298.0, 0.0, 0.0),
        connect_pos=("relative", 0.5, -0.1, 0.5, 0.5, 1.1, 0.5),
    )
    return mat, dom, build_device_geometry(dom, device), build_boundary_tables(mat, dom, device=device)


def film_params(mat, dom, geo, n_particles: float, device):
    from nanokappa_torch.sim.reservoir import (
        autosize_c_max, autosize_inj_cap, build_reservoir_tables,
    )
    from nanokappa_torch.sim.state import SimParams, particle_count, round_pool_cap

    n_p, rho = particle_count(("total", n_particles), mat, dom)
    rtab = build_reservoir_tables(mat, dom, 1.0, rho, device=device)
    params = SimParams(
        dt=1.0,
        n_cap=round_pool_cap(int(n_p * 1.25)),
        inj_cap=autosize_inj_cap(rtab),
        c_max=autosize_c_max(rtab),
        temp_interp="nearest",
        res_gen="pooled",
        particle_density=rho,
        n_active_modes=mat.n_active_modes,
        t_reference=300.0,
    )
    return n_p, rtab, params


def timed(fn, x, n: int) -> float:
    """Mean milliseconds per call of fn(x) over n calls issued back to back
    between one pair of CUDA events, after one warm-up call: the card's
    queue stays full, so a kernel longer than its host-side enqueue is timed
    without the host's gaps (a shorter one is timed at its call rate)."""
    import torch

    fn(x)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn(x)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def float_err(a, b, int_rows) -> float:
    """Max |a - b| over the float rows (inf and NaN must sit at the same
    places); the int rows must be bit-equal."""
    import torch

    for r in int_rows:
        if not torch.equal(a[r].view(torch.int32), b[r].view(torch.int32)):
            n = int((a[r].view(torch.int32) != b[r].view(torch.int32)).sum())
            raise AssertionError(f"int row {r} differs in {n} lanes")
    fr = [r for r in range(a.shape[0]) if r not in int_rows]
    x, y = a[fr].double(), b[fr].double()
    same = (x == y) | (torch.isnan(x) & torch.isnan(y))
    if not bool((same | (torch.isfinite(x) & torch.isfinite(y))).all()):
        raise AssertionError("non-finite values at different places")
    d = torch.where(same, 0.0, (x - y).abs())
    if d.numel() == 0:
        return 0.0
    # rtol 2e-5 (the expf/expm1f ulps of the occupation math) of each value
    # plus 2e-5 of its row's largest finite magnitude (values near zero)
    fin = torch.where(torch.isfinite(y), y.abs(), 0.0)
    lim = 2e-5 * fin + 2e-5 * fin.max(dim=1, keepdim=True).values
    if not bool((d <= lim).all()):
        raise AssertionError(f"float rows differ by up to {float(d.max())}")
    return float(d.max())


def check_close(name, a, b, rtol, scale):
    """|a - b| <= rtol * |b| + rtol * scale, elementwise."""
    import torch

    d = (a.double() - b.double()).abs()
    lim = rtol * b.double().abs() + rtol * scale
    if not bool((d <= lim).all()):
        raise AssertionError(f"{name}: max |diff| {float(d.max())} over the limit")
    return float(d.max())


def abs_bins(pool, T_sv, cfg):
    """Per-subvolume sums of |e|, |e vx|, |e vy|, |e vz|, 1 over the lanes
    that stay in a drifted pool: the scale of the kernel's bins."""
    import torch

    from nanokappa_torch.constants import HBAR
    from nanokappa_torch.ops.kmath import occupation_delta_T_k
    from nanokappa_torch.sim.state import C_ALIVE, C_DEV, C_OMEGA, C_SV

    alive = pool[C_ALIVE] > 0.5
    sv = pool[C_SV].view(torch.int32).long()
    om = pool[C_OMEGA]
    e = HBAR * om * (pool[C_DEV] - occupation_delta_T_k(T_sv[sv], cfg.t_ref, om))
    e = torch.where(alive, e, 0.0).double()
    vals = torch.stack([e, e * pool[3], e * pool[4], e * pool[5], alive.double()], 1)
    out = torch.zeros((cfg.sv8 + 1, 5), dtype=torch.float64, device=pool.device)
    out.index_add_(0, torch.where(alive, sv, cfg.sv8), vals.abs())
    return out[: cfg.sv8]


def kernel_checks(pool0, T_sv, cfg, device):
    """Each kernel against its plain twin on the card, at the film's shapes.
    Returns the per-kernel records for the JSON line (launch counts are
    filled in by the caller from the main path's run)."""
    import torch

    from nanokappa_torch.ops import compact, compact_pool, megastep
    from nanokappa_torch.sim.state import (
        C_ALIVE, C_CF, C_MODE, C_ONF, C_SV, R_MMODE, STALE,
    )

    int_rows = [C_MODE, C_CF, C_ONF, C_SV, R_MMODE]
    recs = []

    # --- A: drift megastep on the compacted pool, with fresh (STALE) lanes --
    pool_c, tail = compact_pool.compact_pool_plain(pool0)
    g = torch.Generator(device=device).manual_seed(7)
    fresh = (torch.rand(pool_c.shape[1], generator=g, device=device) < 0.01) & (
        pool_c[C_ALIVE] > 0.5
    )
    pool_c[C_CF] = torch.where(
        fresh, torch.tensor(STALE, dtype=torch.int32, device=device).view(torch.float32),
        pool_c[C_CF],
    )
    err_a = 0.0
    for rta_on in (False, True):
        pk, pp = pool_c.clone(), pool_c.clone()
        ok_ = megastep.drift_megastep(pk, T_sv, rta_on, cfg)
        op_ = megastep.drift_megastep_plain(pp, T_sv, rta_on, cfg)
        torch.cuda.synchronize()
        # the drift itself rounds identically (nvcc --fmad=false, the same
        # operation order): positions and every int row match bit for bit
        err_a = max(err_a, float_err(pk, pp, int_rows + [C_ALIVE]))
        if not torch.equal(ok_[1], op_[1]):
            raise AssertionError(f"megastep counts {ok_[1].tolist()} != {op_[1].tolist()}")
        kept = int(op_[1][2])
        err_a = max(err_a, float_err(ok_[0][:, :kept], op_[0][:, :kept], int_rows + [C_ALIVE]))
        # sums: float32 sums in another order (the plain twin adds with
        # atomics) differ by up to ~sqrt(n) * eps * sum|x| — ~2e-5 of the
        # lanes' absolute sum at 1e5 lanes per subvolume; the energy column
        # is a signed sum with cancellation, so the bound is on sum|x|
        check_close("megastep ledger", ok_[2], op_[2], 1e-5,
                    op_[2].abs().sum(0, keepdim=True))
        check_close("megastep bins", ok_[3], op_[3], 1e-5,
                    2.0 * abs_bins(pp, T_sv, cfg))
    # timed as the main path calls it: successive drift steps on one pool
    ms = timed(lambda p: megastep.drift_megastep(p, T_sv, True, cfg), pool_c.clone(), 20)
    plain_ms = timed(lambda p: megastep.drift_megastep_plain(p, T_sv, True, cfg), pool_c.clone(), 3)
    recs.append(dict(
        name="drift_megastep", route="cuda", source="nanokappa_torch/csrc/megastep.cu",
        replaces="nanokappa_tpu/ops/megastep.py:1358", max_abs_err=err_a,
        ms=ms, plain_ms=plain_ms,
    ))

    # --- B: pool compaction of the pool with its holes -----------------------
    ok_b, tk = compact_pool.compact_pool(pool0)
    op_b, tp = compact_pool.compact_pool_plain(pool0)
    torch.cuda.synchronize()
    if int(tk) != int(tp) or not torch.equal(ok_b.view(torch.int32), op_b.view(torch.int32)):
        raise AssertionError("compact_pool differs from its plain twin")
    out = torch.empty_like(pool0)
    ms = timed(lambda p: compact_pool.compact_pool(p, out), pool0, 20)
    plain_ms = timed(lambda p: compact_pool.compact_pool_plain(p, out), pool0, 5)
    recs.append(dict(
        name="compact_pool", route="cuda", source="nanokappa_torch/csrc/compact_pool.cu",
        replaces="nanokappa_tpu/ops/compact_pool.py:186", max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms,
    ))

    # --- C: the event machinery's survivor compaction, 2048 -> 512 ----------
    E, cap = cfg.ecap, 512
    masks = [torch.rand(E, generator=g, device=device) < p for p in (0.05, 0.5)]
    for m in masks:  # count below and above the cap
        ik, nk = compact.compact_indices(m, cap)
        ip, npl = compact.compact_indices_plain(m, cap)
        torch.cuda.synchronize()
        if not (torch.equal(ik, ip) and int(nk) == int(npl)):
            raise AssertionError("compact_indices differs from its plain twin")
    ms = timed(lambda m: compact.compact_indices(m, cap), masks[0], 50)
    plain_ms = timed(lambda m: compact.compact_indices_plain(m, cap), masks[0], 50)
    recs.append(dict(
        name="compact_indices", route="cuda", source="nanokappa_torch/csrc/compact.cu",
        replaces="nanokappa_tpu/ops/compact.py:77", max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms,
    ))
    return recs


def small_film_check(device):
    """The whole step on the card vs the plain path on the CPU: the eta = 0
    film with no reservoirs (periodic x and z, specular y walls) from one
    initial state, 4 steps. Lanes without a mirror partner diffuse with
    per-lane draws, so T_sv agrees to rtol 1e-4 and Np_sv to 3 particles."""
    import numpy as np
    import torch

    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.reservoir import build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count
    from nanokappa_torch.sim.step import build_step

    mat = synthetic_material(mesh=(4, 4, 4))
    dom = build_domain(
        geometry="box", dimensions=(2e3, 1e3, 1e3), subvolumes=("slice", 5, 0),
        bound_pos=("relative", 0.5, -0.1, 0.5, 0.5, 1.1, 0.5),
        bound_cond=("R", "R"), bound_values=(0.0, 0.0),
        connect_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5,
                     0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
    )
    n_p, rho = particle_count(("total", 3000), mat, dom)
    params = SimParams(
        dt=1.0, n_cap=4096, inj_cap=128, temp_interp="nearest", res_gen="pooled",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
    )
    outs = []
    for d in (torch.device("cpu"), device):
        geo = build_device_geometry(dom, d)
        btab = build_boundary_tables(mat, dom, device=d)
        rtab = build_reservoir_tables(mat, dom, 1.0, rho, device=d)
        state = init_state(
            mat, dom, geo, params, n_p, btab, temp_dist="custom",
            subvol_temp=[299.0, 299.5, 300.0, 300.5, 301.0], seed=3,
        )
        run = build_step(geo, mat.device_tables(d), btab, rtab, params, n_inner=1, n_outer=4)
        _, out = run(state)
        outs.append((out.T_sv.cpu().numpy(), out.Np_sv.cpu().numpy(), int(out.lost[-1])))
    (T0, N0, l0), (T1, N1, l1) = outs
    np.testing.assert_allclose(T1, T0, rtol=1e-4)
    np.testing.assert_allclose(N1, N0, atol=3)
    if l0 or l1:
        raise AssertionError("small film lost particles")
    return float(np.abs(T1 - T0).max())


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card")
    from nanokappa_torch.geometry.device import host
    from nanokappa_torch.ops import _cuda, compact, compact_pool, megastep
    from nanokappa_torch.ops.megastep import mega_config
    from nanokappa_torch.sim.boundary_tables import slim_mirror_axis
    from nanokappa_torch.sim.fused import event_window
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    card = card_line()
    print(card, flush=True)

    device = torch.device("cuda:0")
    t0 = time.perf_counter()
    _cuda.library(verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_cuda.build_seconds and round(_cuda.build_seconds, 1)} s)", flush=True)

    t0 = time.perf_counter()
    mat, dom, geo, btab = film_ctx(MESH, device)
    n_p, rtab, params = film_params(mat, dom, geo, PARTICLES, device)
    tabs = mat.device_tables(device)
    print(f"film context: {mat.n_modes} modes, {n_p} particles, pool {params.n_cap}, "
          f"inj_cap {params.inj_cap}, evt_cap {event_window(params)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # a realistic pool for the kernel checks: one short run from another seed
    t0 = time.perf_counter()
    pre = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=SEED + 1)
    build_step(geo, tabs, btab, rtab, params, n_inner=10)(pre)
    tau_T = host(tabs.tau_T)
    cfg = mega_config(
        geo, params, slim_mirror_axis(geo, btab, tabs),
        (float(tau_T[0]), float(tau_T[-1])), event_window(params),
    )
    recs = kernel_checks(pre.pool, pre.T_sv, cfg, device)
    for r in recs:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"max_abs_err {r['max_abs_err']:.3g}", flush=True)
    dT = small_film_check(device)
    print(f"kernel checks + small film vs CPU passed (max |dT_sv| {dT:.3g} K) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the main path -------------------------------------------------------
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=SEED)
    n0 = int(state.alive.sum())
    run = build_step(geo, tabs, btab, rtab, params, n_inner=10, n_outer=10)
    mods = (megastep, compact_pool, compact)
    for m in mods:
        m.launches = 0
    for _ in range(2):  # warm up: reach the steady boundary-event mix
        state, out = run(state)
        torch.cuda.synchronize()
    n_runs = 3  # 300 timesteps
    t0 = time.perf_counter()
    for _ in range(n_runs):
        state, out = run(state)
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}

    T = out.T_sv[-1].cpu().numpy()
    n_alive = int(out.N_p[-1])
    lost = out.lost_split[-1].tolist()
    ups = n_runs * 100 * n_alive / elapsed
    print(f"film: T_sv {[round(float(t), 3) for t in T]}", flush=True)
    print(f"film: N_p {n_alive} (start {n0}), lost {lost}, frozen {int(out.frozen[-1])}, "
          f"launches {launches}", flush=True)
    print(f"film: {ups:.4g} updates/s ({elapsed / (n_runs * 100) * 1e3:.3f} ms/step) "
          f"on {card}", flush=True)
    checks = {
        "lost == 0": sum(lost) == 0,
        "population within 5%": abs(n_alive - n0) <= 0.05 * n0,
        "T_sv in (298, 302)": bool(((T > 298.0) & (T < 302.0)).all()),
        "T_sv hot end > cold end": bool(T[0] > T[-1]),
        "every kernel launched": all(v > 0 for v in launches.values()),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"chip_smoke: failed checks: {failed}")

    names = {"drift_megastep": "megastep", "compact_pool": "compact_pool",
             "compact_indices": "compact"}
    for r in recs:
        r["launches"] = launches[names[r["name"]]]
    print(card, flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
