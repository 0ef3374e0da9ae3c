"""Kernel A — the drift megastep: one pass over the particle pool.

Replaces the Pallas kernel `drift_megastep` / `_kernel` of
nanokappa_tpu/ops/megastep.py (:1067 / :298) on the film's branch: the
18-row slim-mirror pool, the box cast, slice subvolumes, nearest
temperatures, row export. Per lane, in order:
  1. deferred RTA with the slope-form lifetime tau = a + b*T_clamped
     (the previous step's scattering; lanes injected this step, C_CF ==
     STALE, skip it),
  2. the box ray cast for stale lanes,
  3. drift by min(t_coll, remaining),
  4. two rounds of in-kernel events: reservoir absorption into a
     per-reservoir ledger [e, e*v/(v.n) xyz, count], periodic translation,
     and specular reflection as the slim-mirror swap (flip one velocity
     component, swap mode <-> partner mode); translated and reflected
     lanes re-cast and drift on,
  5. export of the lanes still pending (3+-bounce chains, lanes without a
     mirror partner): their rows, in ascending lane order, up to `ecap`;
     exported lanes leave the pool (marked dead), clamped ones stay frozen,
  6. per-subvolume sums [e, e*vx, e*vy, e*vz, 1] over the lanes that stay,
     with e = hbar*omega*(dev - g(T_sv[sv])).
The occupation math uses expm1 (ops/kmath.py), not the JAX kernel's Taylor
twin: the two agree to ~2e-5 relative.

CUDA design (csrc/megastep.cu): one thread per lane over the SoA pool,
updated in place; the six facets' tables and the scalar configuration ride
in the kernel's parameter block. Sums are deterministic: each block reduces
its lanes in a fixed order through shared memory into per-block partials,
and a second launch adds the partials in block order. Export: the lanes'
pending flags are counted per block, scanned (kernel C's scan), and each
pending lane below `ecap` copies its 18 rows to its global rank, so rows
come out in ascending lane order with one global clamp. What bounds it on
the card: bytes — the pool is read and written once, 2 x 18 x 4 bytes per
lane (~180 MB at the film's 1.26e6 lanes, ~55 us at 3.35 TB/s); the per-lane
arithmetic is a few hundred flops, far below the card's rate. The TPU-only
mechanisms (the (C, NR, L) layout, 128-aligned segments, the per-tile
w_exp clamp, one-hot MXU sums) are not ported.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from nanokappa_torch.constants import HBAR, KB
from nanokappa_torch.geometry.domain import BC
from nanokappa_torch.ops.kmath import occupation_delta_T_k, signk
from nanokappa_torch.sim.state import (
    C_ALIVE, C_CF, C_DEV, C_MODE, C_OMEGA, C_ONF, C_REM, C_TAU,
    C_TCOLL, R_MMODE, R_TAUB, STALE, as_f32, as_i32,
)

launches = 0  # kernel launches (the CUDA path only)

_REMAIN_EPS = 1e-5
_T_BACK_DT = -1e-4  # ps
_ROUNDS = 2  # in-kernel event rounds on the mirror path
R8 = 8  # ledger rows: reservoirs, the last row collects nothing

_K_NONE, _K_ABSORB, _K_PERIODIC, _K_ROUGH = 0, 1, 2, 3


class _CCfg(ctypes.Structure):
    """Mirror of `struct MegaCfg` in csrc/megastep.cu (field for field)."""

    _fields_ = [
        ("n", ctypes.c_int), ("sv", ctypes.c_int), ("sv8", ctypes.c_int),
        ("rta_on", ctypes.c_int), ("flip_axis", ctypes.c_int),
        ("slice_axis", ctypes.c_int), ("ecap", ctypes.c_int),
        ("dt", ctypes.c_float), ("t_ref", ctypes.c_float),
        ("hbar", ctypes.c_float), ("kb", ctypes.c_float),
        ("x_ref", ctypes.c_float), ("lo_b", ctypes.c_float),
        ("inv_len", ctypes.c_float), ("tau_tmin", ctypes.c_float),
        ("tau_tmax", ctypes.c_float),
        ("kind", ctypes.c_int * 6), ("box_axis", ctypes.c_int * 6),
        ("box_sign", ctypes.c_float * 6), ("box_plane", ctypes.c_float * 6),
        ("value", ctypes.c_float * 6), ("res", ctypes.c_int * 6),
        ("normal", ctypes.c_float * 18), ("shift", ctypes.c_float * 18),
        ("pair", ctypes.c_int * 6),
    ]


@dataclass(frozen=True)
class MegaConfig:
    """Static configuration of the drift kernel for one geometry/run."""

    sv: int
    slice_axis: int
    lo_b: float
    inv_len: float
    flip_axis: int
    dt: float
    t_ref: float
    tau_tmin: float
    tau_tmax: float
    ecap: int
    kind: tuple  # per facet: _K_NONE/_K_ABSORB/_K_PERIODIC/_K_ROUGH
    box_axis: tuple
    box_sign: tuple
    box_plane: tuple
    value: tuple
    res: tuple
    normal: tuple  # 6 x (nx, ny, nz), components below 1e-12 zeroed
    shift: tuple  # 6 x (sx, sy, sz), components below 1e-12 zeroed
    pair: tuple

    @property
    def sv8(self) -> int:
        return max(8, -(-self.sv // 8) * 8)

    def c_struct(self, n: int, rta_on: bool) -> _CCfg:
        c = _CCfg()
        c.n, c.sv, c.sv8 = n, self.sv, self.sv8
        c.rta_on, c.flip_axis = int(bool(rta_on)), self.flip_axis
        c.slice_axis, c.ecap = self.slice_axis, self.ecap
        c.dt, c.t_ref, c.hbar, c.kb = self.dt, self.t_ref, HBAR, KB
        c.x_ref = HBAR / (self.t_ref * KB)
        c.lo_b, c.inv_len = self.lo_b, self.inv_len
        c.tau_tmin, c.tau_tmax = self.tau_tmin, self.tau_tmax
        for f in range(6):
            c.kind[f], c.box_axis[f], c.res[f] = self.kind[f], self.box_axis[f], self.res[f]
            c.box_sign[f], c.box_plane[f] = self.box_sign[f], self.box_plane[f]
            c.value[f], c.pair[f] = self.value[f], self.pair[f]
            for k in range(3):
                c.normal[3 * f + k] = self.normal[f][k]
                c.shift[3 * f + k] = self.shift[f][k]
        return c


def mega_config(geo, params, flip_axis: int, tau_bounds, ecap: int) -> MegaConfig:
    """Host tables of the box film for the drift kernel (built once)."""
    from nanokappa_torch.geometry.device import host

    assert geo.is_box and geo.n_facets == 6 and geo.subvol_type == "slice"
    bc = host(geo.facet_bc)
    kind = np.full(6, _K_NONE)
    kind[(bc == int(BC.TEMPERATURE)) | (bc == int(BC.FLUX))] = _K_ABSORB
    kind[bc == int(BC.PERIODIC)] = _K_PERIODIC
    kind[bc == int(BC.ROUGH)] = _K_ROUGH

    def tiny0(a):
        a = np.asarray(a, np.float32)
        return tuple(tuple(float(x) if abs(float(x)) > 1e-12 else 0.0 for x in r) for r in a)

    bounds = host(geo.bounds)
    ax = int(geo.slice_axis)
    SV = int(geo.n_subvols)
    return MegaConfig(
        sv=SV,
        slice_axis=ax,
        lo_b=float(bounds[0, ax]),
        inv_len=float(SV / (bounds[1, ax] - bounds[0, ax])),
        flip_axis=int(flip_axis),
        dt=float(params.dt),
        t_ref=float(params.t_reference),
        tau_tmin=float(tau_bounds[0]),
        tau_tmax=float(tau_bounds[1]),
        ecap=int(ecap),
        kind=tuple(int(k) for k in kind),
        box_axis=tuple(int(a) for a in host(geo.box_axis)),
        box_sign=tuple(float(s) for s in host(geo.box_sign)),
        box_plane=tuple(float(p) for p in host(geo.box_plane)),
        value=tuple(float(v) for v in np.nan_to_num(host(geo.facet_value))),
        res=tuple(int(r) for r in host(geo.facet_res)),
        normal=tiny0(host(geo.facet_normal)),
        shift=tiny0(host(geo.periodic_shift)),
        pair=tuple(int(p) for p in host(geo.periodic_pair)),
    )


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def _div(a: float, t: torch.Tensor) -> torch.Tensor:
    """a / t as a true division (torch's scalar / tensor goes through a
    reciprocal)."""
    return torch.full_like(t, a) / t


def _box_cast(cfg: MegaConfig, p, v, exclude):
    best_t = torch.full_like(p[0], float("inf"))
    best_f = torch.full_like(exclude, -1)
    for f in range(6):
        a = cfg.box_axis[f]
        va = v[a]
        toward = va * cfg.box_sign[f] > 0.0
        t_raw = (cfg.box_plane[f] - p[a]) / torch.where(va.abs() > 1e-30, va, 1e-30)
        t = torch.clamp(t_raw, min=0.0)
        ok = toward & (t_raw > _T_BACK_DT) & (t < best_t) & (exclude != f)
        best_t = torch.where(ok, t, best_t)
        best_f = torch.where(ok, f, best_f)
    return best_t, best_f


def _sv_of(cfg: MegaConfig, p):
    qa = p[cfg.slice_axis]
    return torch.clamp(((qa - cfg.lo_b) * cfg.inv_len).to(torch.int32), 0, cfg.sv - 1)


def _facet_table(cfg: MegaConfig, cf, values, fill):
    """Per-lane facet property by a select over the six facets."""
    out = torch.full_like(cf, fill) if isinstance(fill, int) else torch.full(
        cf.shape, fill, dtype=torch.float32, device=cf.device
    )
    for f in range(6):
        out = torch.where(cf == f, values[f], out)
    return out


def drift_megastep_plain(pool, T_sv, rta_on, cfg: MegaConfig):
    """The plain torch version; same contract as `drift_megastep`."""
    dt, t_ref = cfg.dt, cfg.t_ref
    dev_ = pool.device
    p = [pool[0].clone(), pool[1].clone(), pool[2].clone()]
    v = [pool[3].clone(), pool[4].clone(), pool[5].clone()]
    omega = pool[C_OMEGA]
    tau = pool[C_TAU]
    dev = pool[C_DEV]
    mode_b = pool[C_MODE]
    cf = as_i32(pool[C_CF])
    t_coll = pool[C_TCOLL]
    onf = as_i32(pool[C_ONF])
    alive = pool[C_ALIVE] > 0.5
    m_mode_b = pool[R_MMODE]
    tau_b = pool[R_TAUB]

    sv = _sv_of(cfg, p)
    rem = torch.where(pool[C_REM] > _REMAIN_EPS, pool[C_REM], torch.where(alive, 1.0, 0.0))

    # ---- 1. deferred RTA ------------------------------------------------------
    T_p = T_sv[sv.long()]
    g = occupation_delta_T_k(T_p, t_ref, omega)
    tau_ev = tau + tau_b * torch.clamp(T_p, cfg.tau_tmin, cfg.tau_tmax)
    decay = torch.where(
        tau_ev > 0, torch.exp(_div(-dt, torch.clamp(tau_ev, min=1e-12))), 0.0
    )
    fresh = cf == STALE
    do_rta = alive & ~fresh & bool(rta_on)
    dev = torch.where(do_rta, g + (dev - g) * decay, dev)

    # ---- 2. stale-lane ray cast -------------------------------------------------
    stale = alive & fresh
    t_b, f_b = _box_cast(cfg, p, v, onf)
    t_coll = torch.where(stale, t_b / dt, t_coll)
    cf = torch.where(stale, f_b, cf)

    # ---- 3. drift -----------------------------------------------------------------
    sf = torch.where(alive, torch.minimum(t_coll, rem), 0.0)
    sf = torch.where(sf < 1e30, sf, rem)
    p = [p[k] + v[k] * (dt * sf) for k in range(3)]
    t_coll = t_coll - sf
    rem = torch.where(alive, torch.clamp(rem - sf, min=0.0), 0.0)

    # ---- 4. in-kernel periodic / absorb / specular rounds ------------------------
    z = torch.zeros_like(omega)
    led = [z, z, z, z, z]  # e, fx, fy, fz, count
    led_seg = torch.full_like(cf, R8 - 1)
    for _ in range(_ROUNDS):
        pend = alive & (rem > _REMAIN_EPS) & (cf >= 0) & (t_coll <= 1e-9)
        kind = _facet_table(cfg, cf, cfg.kind, _K_NONE)
        is_abs = kind == _K_ABSORB
        T_res = _facet_table(cfg, cf, [cfg.value[f] if cfg.kind[f] == _K_ABSORB else 0.0 for f in range(6)], 0.0)
        res_id = _facet_table(cfg, cf, [cfg.res[f] if cfg.kind[f] == _K_ABSORB else 0 for f in range(6)], 0)
        n = [
            _facet_table(cfg, cf, [cfg.normal[f][k] if cfg.kind[f] == _K_ABSORB else 0.0 for f in range(6)], 0.0)
            for k in range(3)
        ]
        absorb = pend & is_abs
        dn_abs = dev - occupation_delta_T_k(T_res, t_ref, omega)
        e_abs = HBAR * omega * dn_abs
        vdn = v[0] * n[0] + v[1] * n[1] + v[2] * n[2]
        vmag = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
        vdn_safe = signk(vdn) * torch.maximum(vdn.abs(), 1e-3 * vmag)
        flux_w = torch.where(vdn_safe.abs() > 1e-30, e_abs / vdn_safe, 0.0)
        adds = [e_abs, flux_w * v[0], flux_w * v[1], flux_w * v[2], torch.ones_like(z)]
        led = [torch.where(absorb, led[k] + adds[k], led[k]) for k in range(5)]
        led_seg = torch.where(absorb, res_id, led_seg)
        alive = alive & ~absorb
        rem = torch.where(absorb, 0.0, rem)

        per = pend & (kind == _K_PERIODIC)
        p = [
            p[k] + torch.where(per, _facet_table(cfg, cf, [cfg.shift[f][k] if cfg.kind[f] == _K_PERIODIC else 0.0 for f in range(6)], 0.0), 0.0)
            for k in range(3)
        ]
        onf = torch.where(per, _facet_table(cfg, cf, cfg.pair, -1), onf)

        # specular reflection: the slim-mirror swap
        rfl = pend & (kind == _K_ROUGH) & (as_i32(m_mode_b) >= 0)
        fa = cfg.flip_axis
        v[fa] = torch.where(rfl, -v[fa], v[fa])
        mode_b, m_mode_b = (
            torch.where(rfl, m_mode_b, mode_b), torch.where(rfl, mode_b, m_mode_b)
        )
        onf = torch.where(rfl, cf, onf)

        mv = per | rfl
        t_b, f_b = _box_cast(cfg, p, v, onf)
        t_coll = torch.where(mv, t_b / dt, t_coll)
        cf = torch.where(mv, f_b, cf)
        sf = torch.where(mv & alive, torch.minimum(t_coll, rem), 0.0)
        sf = torch.where(sf < 1e30, sf, torch.where(mv, rem, 0.0))
        p = [p[k] + v[k] * (dt * sf) for k in range(3)]
        t_coll = t_coll - sf
        rem = torch.where(mv, torch.clamp(rem - sf, min=0.0), rem)

    # ---- 5. export of the still-pending lanes ------------------------------------
    pend = alive & (rem > _REMAIN_EPS) & (cf >= 0) & (t_coll <= 1e-9)
    rank = torch.cumsum(pend.to(torch.int64), 0) - 1
    exported = pend & (rank < cfg.ecap)
    counts = torch.stack(
        [pend.sum(), alive.sum(), torch.clamp(pend.sum(), max=cfg.ecap)]
    ).to(torch.int32)
    alive_out = alive & ~exported

    # ---- 6. subvolume sums over the lanes that stay -------------------------------
    sv = _sv_of(cfg, p)
    T_b = T_sv[sv.long()]
    e_b = torch.where(
        alive_out, HBAR * omega * (dev - occupation_delta_T_k(T_b, t_ref, omega)), 0.0
    )
    vals = torch.stack([e_b, e_b * v[0], e_b * v[1], e_b * v[2], alive_out.float()], 1)
    bins = torch.zeros((cfg.sv8 + 1, 5), dtype=torch.float32, device=dev_)
    bins.index_add_(0, torch.where(alive_out, sv, cfg.sv8).long(), vals)
    led_vals = torch.stack(led, 1)
    ledger = torch.zeros((R8, 5), dtype=torch.float32, device=dev_)
    ledger.index_add_(0, led_seg.long(), led_vals)

    new = torch.stack(
        p + v + [
            omega, tau, dev, mode_b, as_f32(cf), t_coll, as_f32(onf), rem,
            alive_out.float(), as_f32(sv), m_mode_b, tau_b,
        ]
    )
    rows = torch.zeros((pool.shape[0], cfg.ecap), dtype=torch.float32, device=dev_)
    src = torch.nonzero(exported).flatten()
    rows[:, : src.shape[0]] = new[:, src]
    pool.copy_(new)
    return rows, counts, ledger, bins[: cfg.sv8]


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------


def drift_megastep(pool: torch.Tensor, T_sv: torch.Tensor, rta_on: bool, cfg: MegaConfig):
    """One drift pass over the (18, N) pool, updated IN PLACE.

    Returns (rows (18, ecap) f32 — the exported lanes' rows in ascending
    lane order, valid in [0, kept), zero beyond, C_ALIVE reading 0;
    counts (3,) i32 [pending, alive, kept]; ledger (8, 5) f32 per-reservoir
    [e, fx, fy, fz, n]; bins (SV8, 5) f32 per-subvolume [e, e*vx, e*vy,
    e*vz, n] over the lanes that stay). A CPU pool takes the plain version,
    a CUDA pool launches kernel A."""
    global launches
    if pool.device.type != "cuda":
        return drift_megastep_plain(pool, T_sv, rta_on, cfg)
    from nanokappa_torch.ops import _cuda

    if pool.dim() != 2 or pool.shape[0] != 18 or pool.dtype != torch.float32 or not pool.is_contiguous():
        raise ValueError("drift_megastep: pool must be a contiguous (18, N) float32 tensor")
    if T_sv.dtype != torch.float32 or T_sv.shape[0] != cfg.sv or T_sv.device != pool.device:
        raise ValueError("drift_megastep: T_sv must be (SV,) float32 on the pool's device")
    if cfg.sv > 512:
        raise ValueError("drift_megastep: the kernel stages at most 512 subvolumes")
    lib = _cuda.library()
    N = pool.shape[1]
    d = pool.device
    T_sv = T_sv.contiguous()
    rows = torch.zeros((18, cfg.ecap), dtype=torch.float32, device=d)
    counts = torch.empty(3, dtype=torch.int32, device=d)
    ledger = torch.empty((R8, 5), dtype=torch.float32, device=d)
    bins = torch.empty((cfg.sv8, 5), dtype=torch.float32, device=d)
    nb = -(-N // 256)
    # per-block partial sums: staying lanes' bins, frozen lanes' bins, ledger
    scratch_f = torch.empty(nb * (2 * cfg.sv8 + R8) * 5, dtype=torch.float32, device=d)
    # pending and alive counts per block, pending offsets, scan carry
    scratch_i = torch.empty(3 * nb + 4, dtype=torch.int32, device=d)
    pend = torch.empty(N, dtype=torch.uint8, device=d)
    c = cfg.c_struct(N, rta_on)
    err = lib.nk_megastep(
        ctypes.c_void_p(ctypes.addressof(c)), _cuda.ptr(pool), _cuda.ptr(T_sv),
        _cuda.ptr(rows), _cuda.ptr(counts), _cuda.ptr(ledger), _cuda.ptr(bins),
        _cuda.ptr(scratch_f), _cuda.ptr(scratch_i), _cuda.ptr(pend),
        _cuda.stream(pool),
    )
    _cuda.check(err, "nk_megastep")
    launches += 1
    return rows, counts, ledger, bins
