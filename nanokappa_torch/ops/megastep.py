"""Kernel A — the drift megastep: one pass over the particle pool.

Replaces the Pallas kernel `drift_megastep` / `_kernel` of
nanokappa_tpu/ops/megastep.py (:1067 / :298) on its paths, told apart by
the pool's layout tag (sim/state.py):
  * "slim" (18 rows, the film): eta = 0 rough walls resolve in-kernel as
    the slim-mirror swap;
  * "full" (24 rows, e.g. the film under the k model): eta = 0 rough walls
    resolve in-kernel as the full mirror swap (:414-428, :689-707) — mode,
    omega, velocity and both slope-form lifetime pairs trade places with
    the cached partner, and the occupation is re-referenced to the
    partner's frequency;
  * "plain" (16 rows, e.g. the nanowire): rough eta > 0 walls diffuse
    in-kernel — the JAX kernel's "dkern" branch (:382-402, :709-845,
    :883-888) — with the draws made here rather than read from a
    presample pool.
The ray cast is the box slab cast or, for a mesh of at most 128 triangles,
the Möller–Trumbore cast of `_tri_raycast` (:244). Subvolumes are slices
(index arithmetic) or grid/voronoi centres (the first nearest centre by
|c|^2 - 2 q.c, `_sv_of` :436-481, up to 256 centres); the particle
temperature is T_sv of the subvolume or, on slices, the lerp between the
slice centres with extrapolation (`_T_interp` :496-528). Larger meshes run the
kernel_cast-off branch (:548-570, :862-864, :1183-1190) on the "plain"
pool: no cast and no in-kernel round — injections arrive pre-cast
(sim/fused.py, through kernel E) with t_enc = -t/dt - 1 in C_TCOLL and the
real facet in C_CF, and every lane whose flight ends in the step exports.
Per lane, in order:
  1. deferred RTA (the previous step's scattering) at the particle
     temperature, with the slope-form lifetime tau = a + b*T_clamped on
     "slim" and "full", the cached lifetime on "plain"; lanes injected
     this step (C_CF == STALE, or C_TCOLL < -0.5 with kernel_cast off)
     skip it,
  2. the ray cast for stale lanes (kernel_cast off: the pre-cast flight
     time decoded, t = -t_enc - 1),
  3. drift by min(t_coll, remaining),
  4. up to two rounds of in-kernel events: reservoir absorption into a
     per-reservoir ledger [e, e*v/(v.n) xyz, count], periodic translation,
     and at a rough wall either the slim-mirror swap ("slim": flip one
     velocity component, swap mode <-> partner mode), the full mirror swap
     ("full": dev += n0(T_ref, omega) - n0(T_ref, omega_partner), then
     mode, omega, velocity, intercept and slope swap with the cache; a
     lane without a partner stays pending and exports) or ("plain") a
     Bernoulli against the Ziman specularity p = exp(-4 eta^2 cos^2 |k|^2),
     zero for a mode without a specular partner at that wall row; a
     diffuse lane takes a new mode drawn by Walker alias from the wall
     row's creation weights (the boundary tables' `diff2`), the
     Bose-Einstein occupation and the lifetime at the wall temperature;
     a specular winner is flagged (C_TCOLL = -2 on the way out) for the
     narrow machinery, which takes the flag as its draw. Moved lanes
     re-cast and drift on,
  5. export of the lanes still pending: their rows and pool indices, in
     ascending lane order, up to `ecap`; exported lanes leave the pool
     (marked dead), clamped ones stay frozen (a flagged one re-enters the
     next step already decided),
  6. per-subvolume sums [e, e*vx, e*vy, e*vz, 1] over the lanes that stay,
     with e = hbar*omega*(dev - g(T_sv[sv])).
The occupation math uses expm1 (ops/kmath.py), not the JAX kernel's Taylor
twin: the two agree to ~2e-5 relative.

Random numbers: a counter-based hash of (pool lane, step seed, round, draw)
— two rounds of the lowbias32 finaliser (csrc/hash.cuh, mirrored by
`uniform24` here), 24-bit uniforms — so the kernel and its plain twin draw
the same numbers. The JAX kernel's presample pool (sim/diffuse_pool.py), its
8-lane sharing, block reuse and lane roll exist because the TPU cannot
gather per lane; the card can, and the tables fit in its L2.

CUDA design (csrc/megastep.cu): one thread per lane over the SoA pool,
updated in place; templates on box/triangle cast, plain/slim/full layout, the
cast-off branch and the subvolume/temperature mode (SV_SLICE, SV_LINEAR,
SV_CENTER). The centre table [x, y, z, |c|^2], padded to a multiple of eight
rows with never-nearest rows (`_pad_centers`), rides first in shared memory
in the centre mode; the nearest-centre loop runs twice a lane (before and
after the drift), eight centres a step, ~7 float32 operations per centre:
at 256 centres on the 1.28e6-lane pool ~4.6 GFLOP, 0.07 ms at 67 TFLOP/s,
above the pool's bytes (operations bound it there).
The per-facet table (kind, reservoir, value, normal, shift, pair, box plane,
eta, table rows) and the triangle table ride in shared memory; the diffuse
tables (diff2, omega_vel, |k|^2, the partner bitmask, the lifetime table)
are gathered from global memory at a rough hit. Triangle casts (fresh lanes
and lanes an event round moved) go through a block-local queue, solved
densely by up to 32 threads a ray whose partial hits combine on the key
(t, triangle): the serial cast's first-minimum rule, so the same bits.
Sums are deterministic: each block reduces its lanes in a fixed order into
per-block partials (a stable counting sort by subvolume, then each output
adds its run in thread order: the same additions in the same order as a
loop over the block's lanes) and one more launch adds the partials in block
order, one block an output. Export: per-block pending counts, a one-pass
scan, then each pending lane below `ecap` copies its rows to its global
rank. What bounds it on the card: bytes — the pool is read
and written once, 2 x C x 4 bytes per lane (C = 18 slim, 16 plain; ~184 MB
and ~164 MB at the 1.28e6-lane pool, 55 and 49 us at 3.35 TB/s; C = 24
full, ~245 MB, 73 us); the
per-lane arithmetic (a 32-triangle cast is ~1.3 kflop) stays far below the
card's rate. The TPU-only mechanisms (the (C, NR, L) layout, 128-aligned
segments, the per-tile w_exp clamp, one-hot MXU sums, the presample pool)
are not ported.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from nanokappa_torch.constants import HBAR, KB
from nanokappa_torch.geometry.domain import BC
from nanokappa_torch.ops.kmath import occupation_delta_T_k, occupation_delta_omega_k, signk
from nanokappa_torch.sim.binning import interp_T_linear, linear_axis, nearest_center
from nanokappa_torch.sim.state import (
    C_ALIVE, C_CF, C_DEV, C_MODE, C_OMEGA, C_ONF, C_REM, C_TAU, C_TCOLL,
    LAYOUT_ROWS, R_MMODE, R_XMTAUB, R_XOMEGA, R_XTAU, R_XVEL, STALE, TAUB_ROW,
    as_f32, as_i32,
)

launches = 0  # kernel launches (the CUDA path only)

_REMAIN_EPS = 1e-5
_T_BACK_DT = -1e-4  # ps
R8 = 8  # ledger rows: reservoirs, the last row collects nothing

_K_NONE, _K_ABSORB, _K_PERIODIC, _K_ROUGH = 0, 1, 2, 3
# subvolume and temperature modes (csrc/megastep.cu SV_*): slice/nearest,
# slice/linear, grid or voronoi centre/nearest
SV_SLICE, SV_LINEAR, SV_CENTER = 0, 1, 2
MAX_SLICES = 512  # slices the kernel stages (its shared T_sv)
MAX_CENTERS = 256  # grid/voronoi centres its nearest-centre loop walks
#   (the JAX package's cap, nanokappa_tpu/sim/fused.py:291-296)
# facet-table columns (csrc/megastep.cu FT_*); ints are stored as int32 bits
(FT_KIND, FT_RES, FT_PAIR, FT_VALUE, FT_NORMAL, FT_SHIFT, FT_AXIS, FT_SIGN,
 FT_PLANE, FT_ETA, FT_ROW, FT_ROWB) = 0, 1, 2, 3, 4, 7, 10, 11, 12, 13, 14, 15
FT_W = 16

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the counter-based hash (csrc/hash.cuh), in int64 arithmetic masked to 32 bits
# ---------------------------------------------------------------------------


def _mul32(x, c: int):
    """(x * c) mod 2^32 for 0 <= x < 2^32, with every intermediate < 2^49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def lowbias32(x):
    """The lowbias32 integer finaliser (a Python int or an int64 tensor)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform24(lane: torch.Tensor, seed: int, rnd: int, k: int) -> torch.Tensor:
    """Draw k of round `rnd` of each pool lane under the step seed: 24-bit
    uniforms in [0, 1), as csrc/hash.cuh nk::uniform24 computes them."""
    key = lowbias32((seed + _mul32(4 * rnd + k + 1, 0x9E3779B9)) & _M32)
    h = lowbias32(lowbias32(lane ^ key))
    return (h & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


class _CCfg(ctypes.Structure):
    """Mirror of `struct MegaCfg` in csrc/megastep.cu (field for field)."""

    _fields_ = [
        ("n", ctypes.c_int), ("n_rows", ctypes.c_int), ("tri", ctypes.c_int),
        ("sv", ctypes.c_int), ("sv8", ctypes.c_int), ("rta_on", ctypes.c_int),
        ("flip_axis", ctypes.c_int), ("slice_axis", ctypes.c_int),
        ("ecap", ctypes.c_int), ("n_facets", ctypes.c_int),
        ("n_tris", ctypes.c_int), ("rounds", ctypes.c_int),
        ("n_modes", ctypes.c_int), ("n_tau", ctypes.c_int),
        ("precast", ctypes.c_int), ("sv_mode", ctypes.c_int), ("cmask_w", ctypes.c_int),
        ("seed", ctypes.c_uint),
        ("dt", ctypes.c_float), ("t_ref", ctypes.c_float),
        ("hbar", ctypes.c_float), ("kb", ctypes.c_float),
        ("x_ref", ctypes.c_float), ("lo_b", ctypes.c_float),
        ("inv_len", ctypes.c_float), ("tau_tmin", ctypes.c_float),
        ("tau_tmax", ctypes.c_float), ("c0", ctypes.c_float), ("dc", ctypes.c_float),
        ("facets", ctypes.c_void_p), ("tris", ctypes.c_void_p),
        ("diff2", ctypes.c_void_p), ("omega_vel", ctypes.c_void_p),
        ("k2", ctypes.c_void_p), ("cmask", ctypes.c_void_p),
        ("tau", ctypes.c_void_p), ("tau_T", ctypes.c_void_p),
        ("centers", ctypes.c_void_p),
    ]


@dataclass(frozen=True)
class MegaConfig:
    """Static configuration and tables of the drift kernel for one run."""

    layout: str  # "slim" | "full" | "plain"
    sv: int
    sv_mode: int  # SV_SLICE | SV_LINEAR | SV_CENTER
    slice_axis: int
    lo_b: float
    inv_len: float
    c0: float  # linear: the first slice centre on the slice axis
    dc: float  # linear: the slice centres' spacing
    flip_axis: int  # the slim mirror's wall axis (-1 on the other layouts)
    dt: float
    t_ref: float
    tau_tmin: float
    tau_tmax: float
    ecap: int
    kernel_cast: bool  # False: large meshes, injections pre-cast, no rounds
    rounds: int  # in-kernel event rounds
    dkern: bool  # "plain" with rough walls: in-kernel diffuse reflection
    box: tuple | None  # host (axis, sign, plane) lists of a box's six walls
    facets: torch.Tensor  # (F, FT_W) f32 facet table, ints as int32 bits
    tris: torch.Tensor  # (T, 10) f32 [origin, e1, e2, facet bits]; T = 0 on a box
    # the diffuse tables ("plain" with rough walls; empty otherwise)
    diff2: torch.Tensor  # (NU, M, 2) f32 [alias prob, alias mode bits]
    omega_vel: torch.Tensor  # (M, 4) f32
    k2: torch.Tensor  # (M,) f32 |k|^2 of each mode
    cmask: torch.Tensor  # (M, cmask_w) i32: bit r & 31 of word r >> 5 is set where
    #   the mode has a specular partner at row r
    tau: torch.Tensor  # (nT, M) f32 lifetime table
    tau_T: torch.Tensor  # (nT,) f32
    centers: torch.Tensor  # (SV8, 4) f32 [x, y, z, |c|^2], padded (`_pad_centers`; centre mode; empty otherwise)

    @property
    def sv8(self) -> int:
        return max(8, -(-self.sv // 8) * 8)

    @property
    def n_rows(self) -> int:
        return LAYOUT_ROWS[self.layout]

    @property
    def cmask_w(self) -> int:
        """32-bit words of a mode's partner mask: ceil(table rows / 32)."""
        return self.cmask.shape[1] if self.cmask.dim() == 2 else 0

    def c_struct(self, n: int, rta_on: bool, seed: int) -> _CCfg:
        c = _CCfg()
        c.n, c.n_rows = n, self.n_rows
        c.tri, c.precast = int(self.box is None and self.kernel_cast), int(not self.kernel_cast)
        c.sv_mode, c.c0, c.dc = self.sv_mode, self.c0, self.dc
        c.cmask_w = self.cmask_w
        c.sv, c.sv8 = self.sv, self.sv8
        c.rta_on, c.flip_axis = int(bool(rta_on)), self.flip_axis
        c.slice_axis, c.ecap = self.slice_axis, self.ecap
        c.n_facets, c.n_tris, c.rounds = self.facets.shape[0], self.tris.shape[0], self.rounds
        c.n_modes, c.n_tau = self.omega_vel.shape[0], self.tau_T.shape[0]
        c.seed = int(seed) & _M32
        c.dt, c.t_ref, c.hbar, c.kb = self.dt, self.t_ref, HBAR, KB
        c.x_ref = HBAR / (self.t_ref * KB)
        c.lo_b, c.inv_len = self.lo_b, self.inv_len
        c.tau_tmin, c.tau_tmax = self.tau_tmin, self.tau_tmax
        for name in ("facets", "tris", "diff2", "omega_vel", "k2", "cmask", "tau", "tau_T", "centers"):
            t = getattr(self, name)
            setattr(c, name, t.data_ptr() if t.numel() else None)
        return c


def _facet_table(geo, btab) -> np.ndarray:
    """(F, FT_W) float32 host facet table, ints as int32 bits."""
    from nanokappa_torch.geometry.device import host
    from nanokappa_torch.sim.fused import dkern_facet_tables

    bc = host(geo.facet_bc)
    F = len(bc)
    kind = np.full(F, _K_NONE)
    kind[(bc == int(BC.TEMPERATURE)) | (bc == int(BC.FLUX))] = _K_ABSORB
    kind[bc == int(BC.PERIODIC)] = _K_PERIODIC
    kind[bc == int(BC.ROUGH)] = _K_ROUGH

    def tiny0(a):  # components below 1e-12 zeroed, as the JAX kernel bakes them
        a = np.asarray(a, np.float32).copy()
        a[np.abs(a) <= 1e-12] = 0.0
        return a

    tab = np.zeros((F, FT_W), np.float32)
    ints = tab.view(np.int32)
    ints[:, FT_KIND] = kind
    ints[:, FT_RES] = host(geo.facet_res)
    ints[:, FT_PAIR] = host(geo.periodic_pair)
    tab[:, FT_VALUE] = np.nan_to_num(host(geo.facet_value))
    tab[:, FT_NORMAL:FT_NORMAL + 3] = tiny0(host(geo.facet_normal))
    tab[:, FT_SHIFT:FT_SHIFT + 3] = tiny0(host(geo.periodic_shift))
    ints[:, FT_AXIS] = host(geo.box_axis)
    tab[:, FT_SIGN] = host(geo.box_sign)
    tab[:, FT_PLANE] = host(geo.box_plane)
    if btab is not None and int(btab.n_rough) > 0:
        d = dkern_facet_tables(geo, btab)
        tab[:, FT_ETA] = d["facet_eta"]
        ints[:, FT_ROW] = d["facet_row"]
        ints[:, FT_ROWB] = d["facet_row_back"]
    return tab


def partner_bitmask(btab) -> np.ndarray:
    """(M, W) int32 with W = ceil(NU / 32) words a mode: bit r & 31 of word
    r >> 5 is set where the mode has a specular partner at boundary-table
    row r (the JAX package's corr-existence bitmask,
    nanokappa_tpu/sim/fused.py dkern_mode_rows, widened past 32 rows)."""
    corr = btab._host["corr"]  # (NU, M)
    NU, M = corr.shape
    cm = np.zeros((M, max(1, -(-NU // 32))), np.uint32)
    for r in range(NU):
        cm[:, r >> 5] |= (corr[r] >= 0).astype(np.uint32) << np.uint32(r & 31)
    return cm.view(np.int32)


def _pad_centers(centers: torch.Tensor) -> torch.Tensor:
    """The (SV, 4) centre table padded to SV8 rows with [0, 0, 0, +inf]: a
    padding row's key |c|^2 - 2 q.c is +inf (or NaN), which never beats the
    running minimum, so the kernel walks whole steps of eight centres and
    still returns the first nearest real centre."""
    if centers.shape[0] == 0:
        return centers
    n8 = max(8, -(-centers.shape[0] // 8) * 8)
    pad = torch.zeros((n8 - centers.shape[0], 4), dtype=centers.dtype, device=centers.device)
    pad[:, 3] = float("inf")
    return torch.cat([centers, pad]).contiguous()


def mega_config(
    geo, mat, btab, params, ecap: int, flip_axis: int | None = None,
    kernel_cast: bool | None = None, layout: str | None = None,
) -> MegaConfig:
    """The drift kernel's tables for one geometry and run (built once) on
    the pool `layout` (sim/fused.py pool_layout): by default "slim" when
    `flip_axis` (the slim gate's wall axis) is given, else "plain" — with
    the diffuse tables when there are rough walls and the kernel casts,
    with no facet or triangle table when it cannot (kernel_cast off); the
    "full" mirror needs the kernel's cast. `kernel_cast` defaults to what the geometry
    allows (sim/fused.py kernel_cast_ok); False forces the cast-off branch.
    The subvolume/temperature mode follows the geometry's subvolume type
    and params.temp_interp (linear on slices only, sim/fused.py
    require_slice)."""
    from nanokappa_torch.geometry.device import host
    from nanokappa_torch.ops.raycast import box_tables, tri_table
    from nanokappa_torch.sim.fused import kernel_cast_ok

    d = geo.device
    if layout is None:
        layout = "plain" if flip_axis is None else "slim"
    if (layout == "slim") != (flip_axis is not None):
        raise ValueError("the slim layout, and only it, takes the slim gate's flip axis")
    mirror = layout != "plain"
    kcast = kernel_cast_ok(geo) if kernel_cast is None else bool(kernel_cast)
    if mirror and not kcast:
        raise ValueError("the mirror layouts need kernel A's in-kernel cast")
    dkern = kcast and not mirror and btab is not None and int(btab.n_rough) > 0
    bounds = host(geo.bounds)
    ax = int(geo.slice_axis)
    SV = int(geo.n_subvols)
    if geo.subvol_type != "slice":
        sv_mode = SV_CENTER
        centers = _pad_centers(torch.cat([geo.subvol_center, geo.subvol_c2[:, None]], 1))
    else:
        sv_mode = SV_LINEAR if params.temp_interp == "linear" else SV_SLICE
        centers = torch.zeros((0, 4), dtype=torch.float32, device=d)
    c0, dc = linear_axis(geo) if sv_mode == SV_LINEAR else (0.0, 1.0)
    tau_T = host(mat.tau_T)
    empty = torch.zeros(0, dtype=torch.float32, device=d)
    if dkern:
        diff2 = btab.diff2.contiguous()
        omega_vel = mat.omega_vel.contiguous()
        k2 = (mat.wavevector * mat.wavevector).sum(dim=1).contiguous()
        cmask = torch.as_tensor(partner_bitmask(btab), device=d)
        tau, tau_Tt = mat.tau.contiguous(), mat.tau_T.contiguous()
    else:
        diff2 = omega_vel = k2 = tau = tau_Tt = empty
        cmask = torch.zeros((0, 0), dtype=torch.int32, device=d)
    return MegaConfig(
        layout=layout,
        sv=SV,
        sv_mode=sv_mode,
        slice_axis=ax,
        lo_b=float(bounds[0, ax]),
        inv_len=float(SV / (bounds[1, ax] - bounds[0, ax])),
        c0=c0,
        dc=dc,
        flip_axis=int(flip_axis) if flip_axis is not None else -1,
        dt=float(params.dt),
        t_ref=float(params.t_reference),
        # the slope-form lifetime's clamp (slim and full)
        tau_tmin=float(tau_T[0]),
        tau_tmax=float(tau_T[-1]),
        ecap=int(ecap),
        kernel_cast=kcast,
        # a second round resolves 2-bounce chains in-kernel on the mirror
        # and in-kernel-diffuse paths; none runs without the in-kernel cast
        # (an event's resolution needs a re-cast) (nanokappa_tpu/ops/megastep.py:1185)
        rounds=(2 if (mirror or dkern) else 1) if kcast else 0,
        dkern=dkern,
        box=box_tables(geo) if (kcast and geo.is_box) else None,
        facets=torch.as_tensor(
            _facet_table(geo, btab) if kcast else np.zeros((0, FT_W), np.float32), device=d
        ),
        tris=tri_table(geo) if (kcast and not geo.is_box) else empty.reshape(0, 10),
        diff2=diff2,
        omega_vel=omega_vel,
        k2=k2,
        cmask=cmask,
        tau=tau,
        tau_T=tau_Tt,
        centers=centers,
    )


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def _div(a: float, t: torch.Tensor) -> torch.Tensor:
    """a / t as a true division (torch's scalar / tensor goes through a
    reciprocal)."""
    return torch.full_like(t, a) / t


def _box_cast(cfg: MegaConfig, p, v, exclude):
    axis, sign, plane = cfg.box
    best_t = torch.full_like(p[0], float("inf"))
    best_f = torch.full_like(exclude, -1)
    for f in range(6):
        a = axis[f]
        va = v[a]
        toward = va * sign[f] > 0.0
        t_raw = (plane[f] - p[a]) / torch.where(va.abs() > 1e-30, va, 1e-30)
        t = torch.clamp(t_raw, min=0.0)
        ok = toward & (t_raw > _T_BACK_DT) & (t < best_t) & (exclude != f)
        best_t = torch.where(ok, t, best_t)
        best_f = torch.where(ok, f, best_f)
    return best_t, best_f


def _cast(cfg: MegaConfig, p, v, exclude):
    if cfg.box is not None:
        return _box_cast(cfg, p, v, exclude)
    from nanokappa_torch.ops.raycast import tri_cast

    return tri_cast(cfg.tris, p, v, exclude)


def _sv_of(cfg: MegaConfig, p):
    if cfg.sv_mode == SV_CENTER:
        real = cfg.centers[: cfg.sv]
        return nearest_center(torch.stack(p, 1), real[:, :3], real[:, 3])
    qa = p[cfg.slice_axis]
    return torch.clamp(((qa - cfg.lo_b) * cfg.inv_len).to(torch.int32), 0, cfg.sv - 1)


def _T_of(cfg: MegaConfig, T_sv, p, sv):
    """The particle temperature: linear along the slices, else T_sv[sv]."""
    if cfg.sv_mode == SV_LINEAR:
        return interp_T_linear(T_sv, p[cfg.slice_axis], cfg.c0, cfg.dc)
    return T_sv[sv.long()]


def _tau_at(cfg: MegaConfig, T, mode):
    """The lifetime table's T-lerp at T (sim/scatter.py blend_tau_sv's
    arithmetic, per lane)."""
    nT = cfg.tau_T.shape[0]
    i = torch.clamp(torch.searchsorted(cfg.tau_T, T) - 1, 0, max(nT - 2, 0))
    hi = torch.clamp(i + 1, max=nT - 1)
    w = (T - cfg.tau_T[i]) / torch.clamp(cfg.tau_T[hi] - cfg.tau_T[i], min=1e-30)
    w = torch.clamp(w, 0.0, 1.0)
    m = mode.long()
    return cfg.tau[i, m] * (1.0 - w) + cfg.tau[hi, m] * w


def drift_megastep_plain(pool, T_sv, rta_on, cfg: MegaConfig, seed: int = 0):
    """The plain torch version; same contract as `drift_megastep`."""
    dt, t_ref = cfg.dt, cfg.t_ref
    slim = cfg.layout == "slim"
    full = cfg.layout == "full"
    slope = cfg.layout in TAUB_ROW  # slope-form lifetimes
    dev_ = pool.device
    N = pool.shape[1]
    F = cfg.facets.shape[0]
    p = [pool[0].clone(), pool[1].clone(), pool[2].clone()]
    v = [pool[3].clone(), pool[4].clone(), pool[5].clone()]
    omega = pool[C_OMEGA].clone()
    tau = pool[C_TAU].clone()
    dev = pool[C_DEV]
    mode = as_i32(pool[C_MODE])
    cf = as_i32(pool[C_CF])
    t_coll = pool[C_TCOLL]
    onf = as_i32(pool[C_ONF])
    alive = pool[C_ALIVE] > 0.5
    zf = torch.zeros_like(omega)
    if slope:
        m_mode = as_i32(pool[R_MMODE])
        tau_b = pool[TAUB_ROW[cfg.layout]]
    if full:
        m_omega = pool[R_XOMEGA]
        m_v = [pool[R_XVEL.start + k] for k in range(3)]
        m_tau = pool[R_XTAU]
        m_tau_b = pool[R_XMTAUB]
    # lanes that won their specular draw in an earlier step but were frozen
    # by the export clamp re-enter flagged and already decided
    sflag = alive & (t_coll < -1.5) if cfg.dkern else torch.zeros_like(alive)
    t_coll = torch.where(sflag, 0.0, t_coll)

    sv = _sv_of(cfg, p)
    rem = torch.where(pool[C_REM] > _REMAIN_EPS, pool[C_REM], torch.where(alive, 1.0, 0.0))

    # ---- 1. deferred RTA ------------------------------------------------------
    T_p = _T_of(cfg, T_sv, p, sv)
    g = occupation_delta_T_k(T_p, t_ref, omega)
    tau_ev = tau + tau_b * torch.clamp(T_p, cfg.tau_tmin, cfg.tau_tmax) if slope else tau
    decay = torch.where(
        tau_ev > 0, torch.exp(_div(-dt, torch.clamp(tau_ev, min=1e-12))), 0.0
    )
    fresh = (cf == STALE) if cfg.kernel_cast else (t_coll < -0.5)
    do_rta = alive & ~fresh & bool(rta_on)
    dev = torch.where(do_rta, g + (dev - g) * decay, dev)

    # ---- 2. stale-lane ray cast, or the pre-cast flight time decoded -----------
    if cfg.kernel_cast:
        stale = alive & fresh
        t_b, f_b = _cast(cfg, p, v, onf)
        t_coll = torch.where(stale, t_b / dt, t_coll)
        cf = torch.where(stale, f_b, cf)
    else:
        t_coll = torch.where(fresh, -t_coll - 1.0, t_coll)

    # ---- 3. drift -----------------------------------------------------------------
    sf = torch.where(alive, torch.minimum(t_coll, rem), 0.0)
    sf = torch.where(sf < 1e30, sf, rem)
    p = [p[k] + v[k] * (dt * sf) for k in range(3)]
    t_coll = t_coll - sf
    rem = torch.where(alive, torch.clamp(rem - sf, min=0.0), 0.0)

    # ---- 4. in-kernel event rounds --------------------------------------------------
    led = [zf, zf, zf, zf, zf]  # e, fx, fy, fz, count
    led_seg = torch.full_like(cf, R8 - 1)
    n_diff = torch.zeros_like(cf)
    lane = torch.arange(N, device=dev_, dtype=torch.int64)
    for rnd in range(cfg.rounds):
        pend = alive & (rem > _REMAIN_EPS) & (cf >= 0) & (t_coll <= 1e-9)
        fac = cfg.facets[torch.clamp(cf, 0, F - 1).long()]  # (N, FT_W)
        fint = as_i32(fac)
        kind = torch.where(pend, fint[:, FT_KIND], _K_NONE)
        n = [fac[:, FT_NORMAL + k] for k in range(3)]

        absorb = kind == _K_ABSORB
        dn_abs = dev - occupation_delta_T_k(fac[:, FT_VALUE], t_ref, omega)
        e_abs = HBAR * omega * dn_abs
        vdn = (v[0] * n[0] + v[1] * n[1]) + v[2] * n[2]
        vmag = torch.sqrt((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2])
        vdn_safe = signk(vdn) * torch.maximum(vdn.abs(), 1e-3 * vmag)
        flux_w = torch.where(vdn_safe.abs() > 1e-30, e_abs / vdn_safe, 0.0)
        adds = [e_abs, flux_w * v[0], flux_w * v[1], flux_w * v[2], torch.ones_like(zf)]
        led = [torch.where(absorb, led[k] + adds[k], led[k]) for k in range(5)]
        led_seg = torch.where(absorb, fint[:, FT_RES], led_seg)
        alive = alive & ~absorb
        rem = torch.where(absorb, 0.0, rem)

        per = kind == _K_PERIODIC
        p = [torch.where(per, p[k] + fac[:, FT_SHIFT + k], p[k]) for k in range(3)]
        onf = torch.where(per, fint[:, FT_PAIR], onf)

        rough = kind == _K_ROUGH
        if slim:
            # the slim-mirror swap: the partner is the exact crystal mirror
            rfl = rough & (m_mode >= 0)
            fa = cfg.flip_axis
            v[fa] = torch.where(rfl, -v[fa], v[fa])
            mode, m_mode = torch.where(rfl, m_mode, mode), torch.where(rfl, mode, m_mode)
            onf = torch.where(rfl, cf, onf)
        elif full:
            # the full mirror swap: the occupation is conserved while the
            # reference occupation moves to the partner's frequency, then
            # mode, omega, velocity, intercept and slope trade with the cache
            rfl = rough & (m_mode >= 0)
            dev = torch.where(rfl, dev + occupation_delta_omega_k(t_ref, omega, m_omega), dev)

            def sw(a, b):
                return torch.where(rfl, b, a), torch.where(rfl, a, b)

            omega, m_omega = sw(omega, m_omega)
            tau, m_tau = sw(tau, m_tau)
            tau_b, m_tau_b = sw(tau_b, m_tau_b)
            mode, m_mode = sw(mode, m_mode)
            for k in range(3):
                v[k], m_v[k] = sw(v[k], m_v[k])
            onf = torch.where(rfl, cf, onf)
        elif cfg.dkern:
            undecided = rough & ~sflag
            row = torch.where(vdn < 0.0, fint[:, FT_ROWB], fint[:, FT_ROW]).long()
            mode_c = mode.long()
            eta = fac[:, FT_ETA]
            v2 = (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]
            cos2 = (vdn * vdn) / torch.clamp(v2, min=1e-30)
            p_spec = torch.exp(-4.0 * eta * eta * cos2 * cfg.k2[torch.where(undecided, mode_c, 0)])
            word = cfg.cmask[torch.where(undecided, mode_c, 0), row >> 5]
            has = ((word >> (row & 31)) & 1) == 1
            p_spec = torch.where(has, p_spec, 0.0)
            u0 = uniform24(lane, seed, rnd, 0)
            rrf = undecided & (u0 >= p_spec)
            sflag = sflag | (undecided & (u0 < p_spec))
            # the diffuse mode: Walker alias over the wall row's creation
            # weights
            M = cfg.omega_vel.shape[0]
            j = torch.clamp((uniform24(lane, seed, rnd, 1) * M).to(torch.int32), max=M - 1)
            pa = cfg.diff2[torch.where(rrf, row, 0), torch.where(rrf, j, 0).long()]
            nm = torch.where(uniform24(lane, seed, rnd, 2) < pa[:, 0], j, as_i32(pa[:, 1]))
            nm = torch.where(rrf, nm, 0)
            ov = cfg.omega_vel[nm.long()]
            T_w = _T_of(cfg, T_sv, p, None if cfg.sv_mode == SV_LINEAR else _sv_of(cfg, p))
            dev = torch.where(rrf, occupation_delta_T_k(T_w, t_ref, ov[:, 0]), dev)
            tau = torch.where(rrf, _tau_at(cfg, T_w, nm), tau)
            mode = torch.where(rrf, nm, mode)
            omega = torch.where(rrf, ov[:, 0], omega)
            v = [torch.where(rrf, ov[:, 1 + k], v[k]) for k in range(3)]
            onf = torch.where(rrf, cf, onf)
            n_diff = n_diff + rrf.to(torch.int32)
            rfl = rrf
        else:
            rfl = torch.zeros_like(rough)

        mv = per | rfl
        t_b, f_b = _cast(cfg, p, v, onf)
        t_coll = torch.where(mv, t_b / dt, t_coll)
        cf = torch.where(mv, f_b, cf)
        sf = torch.where(mv & alive, torch.minimum(t_coll, rem), 0.0)
        sf = torch.where(sf < 1e30, sf, torch.where(mv, rem, 0.0))
        p = [p[k] + v[k] * (dt * sf) for k in range(3)]
        t_coll = t_coll - sf
        rem = torch.where(mv, torch.clamp(rem - sf, min=0.0), rem)

    # flagged specular winners carry the flag out
    t_coll = torch.where(sflag, -2.0, t_coll)

    # ---- 5. export of the still-pending lanes ------------------------------------
    pend = alive & (rem > _REMAIN_EPS) & (cf >= 0) & (t_coll <= 1e-9)
    rank = torch.cumsum(pend.to(torch.int64), 0) - 1
    exported = pend & (rank < cfg.ecap)
    counts = torch.stack([
        pend.sum(), alive.sum(), torch.clamp(pend.sum(), max=cfg.ecap),
        n_diff.sum(), (pend & sflag).sum(),
    ]).to(torch.int32)
    alive_out = alive & ~exported

    # ---- 6. subvolume sums over the lanes that stay -------------------------------
    sv = _sv_of(cfg, p)
    T_b = T_sv[sv.long()]
    e_b = torch.where(
        alive_out, HBAR * omega * (dev - occupation_delta_T_k(T_b, t_ref, omega)), 0.0
    )
    # the sums accumulate in float64 (the kernel's fixed-order float32 tree
    # is close to exact; a float32 running sum over 1e6 lanes is not)
    vals = torch.stack([e_b, e_b * v[0], e_b * v[1], e_b * v[2], alive_out.float()], 1)
    bins = torch.zeros((cfg.sv8 + 1, 5), dtype=torch.float64, device=dev_)
    bins.index_add_(0, torch.where(alive_out, sv, cfg.sv8).long(), vals.double())
    led_vals = torch.stack(led, 1)
    ledger = torch.zeros((R8, 5), dtype=torch.float64, device=dev_)
    ledger.index_add_(0, led_seg.long(), led_vals.double())
    bins, ledger = bins.float(), ledger.float()

    cols = p + v + [
        omega, tau, dev, as_f32(mode), as_f32(cf), t_coll, as_f32(onf), rem,
        alive_out.float(), as_f32(sv),
    ]
    if slim:
        cols += [as_f32(m_mode), tau_b]
    if full:
        cols += [as_f32(m_mode), m_omega, *m_v, m_tau, tau_b, m_tau_b]
    new = torch.stack(cols)
    rows = torch.zeros((pool.shape[0], cfg.ecap), dtype=torch.float32, device=dev_)
    idx = torch.full((cfg.ecap,), N, dtype=torch.int32, device=dev_)
    src = torch.nonzero(exported).flatten()
    rows[:, : src.shape[0]] = new[:, src]
    idx[: src.shape[0]] = src.to(torch.int32)
    pool.copy_(new)
    return rows, idx, counts, ledger, bins[: cfg.sv8]


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------


def drift_megastep(
    pool: torch.Tensor, T_sv: torch.Tensor, rta_on: bool, cfg: MegaConfig, seed: int = 0
):
    """One drift pass over the (C, N) pool of the config's layout (C = 18
    "slim", 24 "full", 16 "plain"), updated IN PLACE; `seed` is the step's
    seed of the in-kernel draws.

    Returns (rows (C, ecap) f32 — the exported lanes' rows in ascending
    lane order, valid in [0, kept), zero beyond, C_ALIVE reading 0;
    idx (ecap,) i32 — their pool lanes, N beyond kept;
    counts (5,) i32 [pending, alive, kept, in-kernel diffuse re-emissions,
    flagged pending lanes]; ledger (8, 5) f32 per-reservoir [e, fx, fy, fz,
    n]; bins (SV8, 5) f32 per-subvolume [e, e*vx, e*vy, e*vz, n] over the
    lanes that stay). A CPU pool takes the plain version, a CUDA pool
    launches kernel A."""
    global launches
    if pool.device.type != "cuda":
        return drift_megastep_plain(pool, T_sv, rta_on, cfg, seed)
    out = _launch(pool, T_sv, rta_on, cfg, seed)
    launches += 1
    return out


def _launch(pool, T_sv, rta_on, cfg: MegaConfig, seed: int):
    from nanokappa_torch.ops import _cuda

    C = cfg.n_rows
    if pool.dim() != 2 or pool.shape[0] != C or pool.dtype != torch.float32 or not pool.is_contiguous():
        raise ValueError(
            f"drift_megastep: the {cfg.layout!r} layout takes a contiguous ({C}, N) float32 pool"
        )
    if T_sv.dtype != torch.float32 or T_sv.shape[0] != cfg.sv or T_sv.device != pool.device:
        raise ValueError("drift_megastep: T_sv must be (SV,) float32 on the pool's device")
    if cfg.sv > MAX_SLICES or cfg.tris.shape[0] > 128 or cfg.facets.shape[0] > 128:
        raise ValueError(
            f"drift_megastep: the kernel stages <= {MAX_SLICES} subvolumes, 128 triangles, 128 facets"
        )
    if cfg.sv_mode == SV_CENTER and cfg.sv > MAX_CENTERS:
        raise ValueError(f"drift_megastep: the nearest-centre loop walks <= {MAX_CENTERS} centres")
    if cfg.facets.device != pool.device:
        raise ValueError("drift_megastep: the config's tables must be on the pool's device")
    lib = _cuda.library()
    N = pool.shape[1]
    d = pool.device
    T_sv = T_sv.contiguous()
    rows = torch.zeros((C, cfg.ecap), dtype=torch.float32, device=d)
    idx = torch.full((cfg.ecap,), N, dtype=torch.int32, device=d)
    counts = torch.empty(5, dtype=torch.int32, device=d)
    ledger = torch.empty((R8, 5), dtype=torch.float32, device=d)
    bins = torch.empty((cfg.sv8, 5), dtype=torch.float32, device=d)
    nb = -(-N // 256)
    # per-block partial sums: staying lanes' bins, frozen lanes' bins, ledger
    scratch_f = torch.empty(nb * (2 * cfg.sv8 + R8) * 5, dtype=torch.float32, device=d)
    # per-block pending/alive/diffused/flagged counts, pending offsets, carry
    scratch_i = torch.empty(5 * nb + 4, dtype=torch.int32, device=d)
    pend = torch.empty(N, dtype=torch.uint8, device=d)
    c = cfg.c_struct(N, rta_on, seed)
    err = lib.nk_megastep(
        ctypes.c_void_p(ctypes.addressof(c)), _cuda.ptr(pool), _cuda.ptr(T_sv),
        _cuda.ptr(rows), _cuda.ptr(idx), _cuda.ptr(counts), _cuda.ptr(ledger),
        _cuda.ptr(bins), _cuda.ptr(scratch_f), _cuda.ptr(scratch_i),
        _cuda.ptr(pend), _cuda.stream(pool),
    )
    _cuda.check(err, "nk_megastep")
    return rows, idx, counts, ledger, bins
