"""Kernel F — the narrow machinery's event rounds, one launch a round.

The v2 step hands kernel A's exported rows (a (16, E) buffer of which a few
lanes are live) to the narrow machinery (sim/cascade.py run_event_buffer):
round 1 at the buffer's width, the survivors compacted by kernel C into a
narrow buffer, rounds 2+ there until none is pending or k_max rounds have
run. Its plain version is the torch round (`_event_round`), some 340
elementwise launches a round plus the packing around it; this module runs
the same rounds as csrc/event_round.cu, which works on the packed rows
directly: round 1 from the input rows into a fresh output buffer, rounds 2+
in place on the output's surviving lanes (kernel C's index vector), no
unpack, gather or scatter. The uniforms stay the twin's, one
`torch.rand((width, 4), generator=gen)` a round at the same widths and in
the same order, so the generator's stream and every trajectory are the
twin's, and the one host read a round stays (the pending count the kernel
writes). It replaces no Pallas kernel (the JAX package runs these rounds
as XLA-fused jnp code, nanokappa_tpu/sim/cascade.py:283,482).

It covers what `covers` says: box geometries (the slab cast) with slice
subvolumes under nearest or linear temperatures, either scattering model.
Triangle meshes keep the torch round, whose re-cast is kernel E, and so do
centre subvolumes: other casts and another classifier. The route asks
`covers` once (sim/fused.py build_route, its `kernel_f`).

What bounds it on the card: launch latency (the rows read and written once
are 0.26 MB at the film's 2,048 lanes, 0.08 us at 3.35 TB/s).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from nanokappa_torch.constants import HBAR, KB
from nanokappa_torch.ops.megastep import _K_ABSORB, _K_NONE, _K_PERIODIC, _K_ROUGH

launches = 0  # kernel launches (the CUDA path only)

# facet-table columns (csrc/event_round.cu RF_*); ints as int32 bits
(RF_KIND, RF_RES, RF_PAIR, RF_VALUE, RF_NORMAL, RF_SHIFT, RF_AXIS, RF_SIGN,
 RF_PLANE, RF_ROW, RF_ROWB) = 0, 1, 2, 3, 4, 7, 10, 11, 12, 13, 14
RF_W = 16
_BLOCK = 256  # threads (= lanes) a block (csrc/scan.cuh NK_BLOCK)
_SCRATCH: dict[int, dict] = {}  # device index -> the kernel's scratch


def covers(geo, params) -> bool:
    """Does kernel F run this configuration's narrow rounds? The box's slab
    cast and slice subvolumes, under nearest or linear temperatures."""
    return bool(geo.is_box) and geo.subvol_type == "slice" and params.temp_interp in ("nearest", "linear")


class _RCfg(ctypes.Structure):
    """Mirror of `struct RoundCfg` in csrc/event_round.cu (field for field)."""

    _fields_ = [
        *[(n, ctypes.c_int) for n in (
            "e", "stride", "first", "finish", "n_facets", "n_sv", "linear", "slice_axis",
            "n_modes", "n_tau", "r8", "kmodel", "evt2",
        )],
        *[(n, ctypes.c_float) for n in (
            "dt", "inv_dt", "t_ref", "hbar", "kb", "lo", "length", "c0", "dc",
        )],
        *[(n, ctypes.c_void_p) for n in (
            "facets", "spec2", "diff2", "degen", "omega_vel", "tau", "tau_T",
        )],
    ]


@dataclass(frozen=True)
class RoundTables:
    """Kernel F's tables and constants for one run (built once)."""

    facets: torch.Tensor  # (F, RF_W) f32, ints as int32 bits
    spec2: torch.Tensor  # (NU, M, 2) f32
    diff2: torch.Tensor  # (NU, M, 2) f32
    degen: torch.Tensor  # (M,) i32
    omega_vel: torch.Tensor  # (M, 4) f32
    tau: torch.Tensor  # (nT, M) f32
    tau_T: torch.Tensor  # (nT,) f32
    n_sv: int
    linear: bool
    slice_axis: int
    kmodel: bool
    k_max: int
    dt: float
    t_ref: float
    lo: float  # the slices' lower bound on their axis (sim/binning.py subvol_id)
    length: float  # one slice's length, as subvol_id rounds it
    c0: float  # linear: the first slice centre on the slice axis
    dc: float  # linear: the slice centres' spacing

    def c_struct(self, stride: int, r8: int, evt2: int) -> _RCfg:
        """One narrow-machinery call's struct; each launch sets its `e`,
        `first` and `finish` (the launch copies the struct)."""
        c = _RCfg()
        c.stride = stride
        c.n_facets, c.n_sv, c.linear, c.slice_axis = (
            self.facets.shape[0], self.n_sv, int(self.linear), self.slice_axis,
        )
        c.n_modes, c.n_tau, c.r8 = self.omega_vel.shape[0], self.tau_T.shape[0], r8
        c.kmodel, c.evt2 = int(self.kmodel), evt2
        # torch divides a CUDA tensor by a Python float as a product with
        # the float32 reciprocal (t_ps / dt in the twin)
        c.dt, c.inv_dt = self.dt, float(np.float32(1.0) / np.float32(self.dt))
        c.t_ref, c.hbar, c.kb = self.t_ref, HBAR, KB
        c.lo, c.length, c.c0, c.dc = self.lo, self.length, self.c0, self.dc
        for name in ("facets", "spec2", "diff2", "degen", "omega_vel", "tau", "tau_T"):
            setattr(c, name, getattr(self, name).data_ptr())
        return c


def round_tables(geo, mat, btab, params) -> RoundTables:
    """Kernel F's tables for a configuration `covers` takes: per facet its
    kind, reservoir, periodic pair and shift, value, normal, slab plane and
    rough-wall table rows (front and back, as the twin clamps the rough
    index), with the geometry's own float32 values."""
    from nanokappa_torch.geometry.device import host
    from nanokappa_torch.geometry.domain import BC
    from nanokappa_torch.sim.binning import linear_axis
    from nanokappa_torch.sim.boundary_tables import K_MODELS

    if not covers(geo, params):
        raise ValueError("kernel F runs box geometries on slice subvolumes (nearest or linear T)")
    d = geo.device
    bc = host(geo.facet_bc)
    F = len(bc)
    kind = np.full(F, _K_NONE)
    kind[(bc == int(BC.TEMPERATURE)) | (bc == int(BC.FLUX))] = _K_ABSORB
    kind[bc == int(BC.PERIODIC)] = _K_PERIODIC
    kind[bc == int(BC.ROUGH)] = _K_ROUGH
    tab = np.zeros((F, RF_W), np.float32)
    ints = tab.view(np.int32)
    ints[:, RF_KIND] = kind
    ints[:, RF_RES] = host(geo.facet_res)
    ints[:, RF_PAIR] = host(geo.periodic_pair)
    tab[:, RF_VALUE] = host(geo.facet_value)
    tab[:, RF_NORMAL:RF_NORMAL + 3] = host(geo.facet_normal)
    tab[:, RF_SHIFT:RF_SHIFT + 3] = host(geo.periodic_shift)
    ints[:, RF_AXIS] = host(geo.box_axis)
    tab[:, RF_SIGN] = host(geo.box_sign)
    tab[:, RF_PLANE] = host(geo.box_plane)
    if btab.n_rough > 0:
        row_of, row_back = host(btab.row_of_rough), host(btab.row_back)
        i_rough = np.clip(host(geo.facet_rough), 0, row_of.shape[0] - 1)
        ints[:, RF_ROW] = row_of[i_rough]
        ints[:, RF_ROWB] = row_back[i_rough]
    M = int(btab.diffuse_prob.shape[1])
    if mat.omega_vel.shape[0] != M or mat.tau.shape[1] != M:
        raise ValueError("kernel F: the boundary and material tables disagree on the modes")
    ax = int(geo.slice_axis)
    # sim/binning.py subvol_id's own float32 arithmetic, read back once
    length = (geo.bounds[1, ax] - geo.bounds[0, ax]) / geo.n_subvols
    linear = params.temp_interp == "linear"
    c0, dc = linear_axis(geo) if linear else (0.0, 1.0)
    return RoundTables(
        facets=torch.as_tensor(tab, device=d),
        spec2=btab.spec2.contiguous(),
        diff2=btab.diff2.contiguous(),
        degen=btab.degen_partner.to(torch.int32).contiguous(),
        omega_vel=mat.omega_vel.contiguous(),
        tau=mat.tau.contiguous(),
        tau_T=mat.tau_T.contiguous(),
        n_sv=int(geo.n_subvols),
        linear=linear,
        slice_axis=ax,
        kmodel=params.scat_model in K_MODELS,
        k_max=int(params.k_max),
        dt=float(params.dt),
        t_ref=float(params.t_reference),
        lo=float(geo.bounds[0, ax]),
        length=float(length),
        c0=c0,
        dc=dc,
    )


def _scratch(device: torch.device, nb: int, r8: int) -> dict:
    """The kernel's scratch on one device: per-block ledger partials and
    counts, grown as needed, and the last-block ticket, zeroed once (every
    launch leaves it zeroed). Calls on one device run in one stream's
    order."""
    s = _SCRATCH.get(device.index)
    if s is None or s["nb"] < nb or s["r8"] < r8:
        nb = max(nb, s["nb"] if s else 0)
        r8 = max(r8, s["r8"] if s else 0)
        s = _SCRATCH[device.index] = dict(
            nb=nb, r8=r8,
            part=torch.empty(nb * r8 * 5, dtype=torch.float32, device=device),
            blk=torch.empty(4 * nb, dtype=torch.int32, device=device),
            ticket=torch.zeros(1, dtype=torch.int32, device=device),
        )
    return s


class RoundCall:
    """One narrow-machinery call's buffers on the card: the (16, E) output
    rows, the pending mask, the (R8, 5) ledger and the counts ([swaps
    (int64), then the int32 counts pending, defective, stuck, frozen]);
    `launch` runs one launch of kernel F on them."""

    def __init__(self, tabs: RoundTables, rows, vbuf, T_sv, R8: int, evt2: int):
        from nanokappa_torch.ops import _cuda

        if rows.dim() != 2 or rows.shape[0] != 16 or rows.dtype != torch.float32:
            raise ValueError("event_rounds: the rows are a (16, E) float32 buffer")
        self.tabs, self.R8, self.evt2 = tabs, R8, evt2
        self.rows, self.vbuf, self.T_sv = rows.contiguous(), vbuf.contiguous(), T_sv.contiguous()
        d = rows.device
        self.E = rows.shape[1]
        self.out = torch.empty_like(self.rows)
        self.pend = torch.empty(self.E, dtype=torch.bool, device=d)
        self.ledger = torch.empty((R8, 5), dtype=torch.float32, device=d)
        self.acc = torch.empty(3, dtype=torch.int64, device=d)
        self.cnt = self.acc[1:].view(torch.int32)
        self.scratch = _scratch(d, -(-max(self.E, evt2) // _BLOCK), R8)
        self.cfg = tabs.c_struct(self.E, R8, evt2)
        self.lib = _cuda.library()
        self.stream = _cuda.stream(rows)

    def launch(self, e: int, first: bool, finish: bool = False, idx=None, u4=None) -> None:
        """Round 1 (`first`: the input rows into the output), a round 2+ in
        place on the output's lanes `idx`, or the quarantine (`finish`)."""
        global launches
        from nanokappa_torch.ops._cuda import check, ptr

        c = self.cfg
        c.e, c.first, c.finish = e, int(first), int(finish)
        null = ctypes.c_void_p(None)
        scr = self.scratch
        err = self.lib.nk_event_round(
            ctypes.c_void_p(ctypes.addressof(c)), ptr(self.rows if first else self.out),
            ptr(self.out), ptr(self.vbuf), null if idx is None else ptr(idx),
            null if u4 is None else ptr(u4), ptr(self.T_sv), ptr(self.pend), ptr(self.ledger),
            ptr(self.acc), ptr(scr["part"]), ptr(scr["blk"]), ptr(scr["ticket"]), self.stream,
        )
        check(err, "nk_event_round")
        launches += 1


def event_rounds(tabs: RoundTables, rows, vbuf, gen, T_sv, R8: int, evt2: int):
    """The narrow machinery on the (16, E) CUDA rows through kernel F, with
    sim/cascade.py run_event_buffer's contract (`evt2` its rounds-2+ width):
    (rows_out (16, E), ledger (R8, 5), lost_stuck, lost_defective, frozen,
    swaps), the counts device scalars. `rows` is left as it was."""
    from nanokappa_torch.ops.compact import compact_indices

    call = RoundCall(tabs, rows, vbuf, T_sv, R8, evt2)
    E, d, cnt = call.E, rows.device, call.cnt
    # round 1 at the buffer's width; kernel A's flagged lanes take their
    # draw as decided
    call.launch(E, True, u4=torch.rand((E, 4), generator=gen, device=d))
    # rounds 2+ on kernel C's index vector of the survivors, in place; the
    # reference's `while np.any(calculated_ts < 1)`, one host read a round
    k_max = tabs.k_max
    stuck = k_max <= 1
    if stuck or int(cnt[0]) > 0:
        sidx2, _ = compact_indices(call.pend, evt2)
        rnd = 1
        while not stuck:
            call.launch(evt2, False, idx=sidx2, u4=torch.rand((evt2, 4), generator=gen, device=d))
            rnd += 1
            stuck = rnd >= k_max
            if not stuck and int(cnt[0]) == 0:
                break
        if stuck:
            # still pending after k_max rounds: quarantined
            call.launch(evt2, False, finish=True, idx=sidx2)
    return call.out, call.ledger, cnt[2], cnt[1], cnt[3], call.acc[0]
