"""The comparison that decides a run's `correct`.

The reference (reference/physics.py, reference/film.py) imports nothing of
the program and takes none of its tables: it derives the mode tables, the
mirror partners, the reservoirs' entry rates, the lifetimes and E(T) from
the configuration's words and the raw material. What it reads of the
program is its state and what the timed path produced, captured by the
harness at one whole step of the window's last batch (drawn from the
seed; its outputs are one of the driver's datapoints):

* the pool at the step's start, the step's T_sv and the reservoirs'
  accumulators, the pool after the injection (the injected rows: their
  modes, places and flight fractions are the step's draws), the lanes
  kernel A exported to the narrow rounds, the pool at the step's end with
  the narrow rounds' rows appended, and the step's outputs and ledgers;
* the driver's datapoint of that step and every datapoint of the window;
* the first pool compaction (kernel B) after that step, in and out.

It runs the whole step again in its own arithmetic (relaxation,
injection, the flight with its absorptions, periodic re-entries and
specular reflections, the slices' sums and T(E)) and compares each
particle's end state, the ledgers and the datapoint; it inverts every
datapoint's E and evaluates its kappa again; and it compacts the pool
again. The control (`control=True`) is the same reference computed in
bfloat16, put in the program's place.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from reference import layout as P
from reference.film import FilmStep
from reference.physics import A_IN_M, Box, Crystal, n0

LOWER = torch.bfloat16  # the precision below the configuration's float32
NUMBERS = (
    "inject_count_off", "inject_rows_off", "cast_gap_A", "step_lanes_off", "step_dev_gap", "narrow_lanes_off",
    "ledger_count_off", "ledger_energy_gap", "datapoint_Np_off", "datapoint_T_gap_K",
    "datapoint_phi_gap", "datapoint_TofE_gap_K", "datapoint_kappa_gap", "compact_lanes_off",
)
POS_TOL = 1e-2  # A: a particle's end position, float32 arithmetic over a 5000 A box
REL_TOL = 1e-6  # cached frequency and velocity against the mode's


class Reference:
    """The reference's tables for one configuration: its CLI words
    (`args`, name -> list of words), the raw material and the traffic's
    particle count."""

    def __init__(self, args: dict, raw, n_particles: int, device):
        self.crystal = Crystal(raw, device)
        self.box = Box(args)
        self.film = FilmStep(self.crystal, self.box, float(args["timestep"][0]), int(n_particles))
        if str(args.get("reservoir_gen", ["pooled"])[0]) != "pooled":
            raise ValueError("the reference injects by the pooled scheme only")
        if str(args.get("temp_interp", ["nearest"])[0]) != "nearest":
            raise ValueError("the reference takes the slice's temperature (nearest) only")
        self.device = self.crystal.device


# ---------------------------------------------------------------------------
# the injection
# ---------------------------------------------------------------------------


def _cached_off(ref: Reference, rows: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """Lanes whose cached frequency or velocity is not their mode's."""
    c = ref.crystal
    om = c.omega[mode]
    v = c.vel[mode]
    s_w = float(c.omega.abs().max())
    s_v = float(c.vel.abs().max())
    bad = (rows[P.OMEGA].double() - om).abs() > REL_TOL * s_w
    bad |= ((rows[P.VEL].double().T - v).abs() > REL_TOL * s_v).any(1)
    return bad


def injection(ref: Reference, st: dict, control: bool = False) -> tuple[dict, dict]:
    """inject_count_off, inject_rows_off, and each injected lane's
    reservoir and the reference's occupation for it."""
    f = ref.film
    box = ref.box
    d = ref.device
    counts = f.pooled_counts(st["counter"])
    n_valid = int(st["n_valid"])
    rows = st["pool_inj"].to(d)[:, :n_valid]
    mode = P.ints(rows[P.MODE]).long().clamp(0, ref.crystal.M - 1)
    k = torch.arange(n_valid, device=d)
    bounds = torch.as_tensor(np.cumsum(counts), device=d)
    res = torch.clamp(torch.searchsorted(bounds, k, right=True), max=max(f.R - 1, 0))
    dev_ref = f.injected_dev(res, mode)
    if control:  # the reference's rows in bfloat16 in the program's place
        rows = rows.clone()
        for r in (0, 1, 2, 3, 4, 5, P.OMEGA, P.DEV, P.REM):
            rows[r] = rows[r].to(LOWER).float()
        rows[P.DEV] = f.injected_dev(res, mode, LOWER).float()
    count_off = abs(n_valid + int(st["dropped"]) - int(counts.sum()))
    bad = _cached_off(ref, rows, mode)
    pos = rows[P.POS].double().T
    L = torch.as_tensor(box.L, device=d)
    for w in box.reservoirs:
        mine = res == w.reservoir
        plane = float(box.L[w.axis]) if w.side else 0.0
        on = (pos[:, w.axis] - plane).abs() <= 1e-3
        if int(st["dropped"]) == 0:
            count_off += abs(int((on & mine).sum()) - int(counts[w.reservoir]))
        bad |= mine & ~on
        rate = torch.as_tensor(f.rates[w.reservoir], device=d)[mode]
        bad |= mine & ~(rate > 0)
    bad |= ((pos < -1e-3) | (pos > L + 1e-3)).any(1)
    n0_ref = n0(torch.full_like(dev_ref, f.t_ref), ref.crystal.omega[mode])
    bad |= (rows[P.DEV].double() - dev_ref).abs() > 1e-5 * (dev_ref.abs() + n0_ref)
    rem = rows[P.REM].double()
    bad |= (rem < 0) | (rem > 1)
    bad |= rows[P.ALIVE] < 0.5
    if rows.shape[0] >= P.SLIM_ROWS:
        part = f.slim_partner(mode)
        cls = ref.crystal.mode_class
        got = P.ints(rows[P.PARTNER]).long()
        has = part >= 0
        bad |= has & ((got < 0) | (cls[got.clamp(0, ref.crystal.M - 1)] != cls[part.clamp(min=0)]))
    return (dict(inject_count_off=count_off, inject_rows_off=int(bad.sum())),
            dict(res=res, dev=dev_ref, mode=mode, rows=rows))


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------


def program_end(st: dict, d) -> torch.Tensor:
    """(C, n) end-of-step rows of the lanes [0, tail after the injection):
    a lane that kernel A exported is read at its row in the narrow
    rounds' window appended at the tail."""
    pool1 = st["pool1"].to(d)
    n = int(st["tail_inj"])
    src = torch.arange(n, device=d)
    kept = int(st["kept"])
    if kept:
        idx = st["idx"][:kept].to(d).long()
        win = int(st["tail1"]) - int(st["ecap"])
        src[idx] = win + torch.arange(kept, device=d)
    return pool1[:, src]


def whole_step(ref: Reference, st: dict, inj: dict, control: bool = False) -> tuple[dict, dict]:
    """The step's particle numbers, and the reference's end-of-step
    population with the ambiguous lanes set to the program's outcome."""
    d = ref.device
    c, f = ref.crystal, ref.film
    pool0 = st["pool0"].to(d)
    tail0 = int(st["tail0"])
    alive0 = pool0[P.ALIVE, :tail0] > 0.5
    lanes = torch.nonzero(alive0).flatten()
    r0 = pool0[:, lanes]
    rem0 = torch.where(r0[P.REM] > 1e-5, r0[P.REM], torch.ones_like(r0[P.REM]))
    rows_i = inj["rows"]
    rem_i = rows_i[P.REM]
    p_start = torch.cat([r0[P.POS].T, rows_i[P.POS].T]).double()
    mode_start = torch.cat([P.ints(r0[P.MODE]).long(), inj["mode"]]).clamp(0, c.M - 1)
    dev_start = torch.cat([r0[P.DEV].double(), inj["dev"]])
    rem = torch.cat([rem0, torch.where(rem_i > 1e-5, rem_i, torch.ones_like(rem_i))]).double()
    rta = torch.cat([torch.ones(lanes.numel(), dtype=torch.bool, device=d),
                     torch.zeros(rows_i.shape[1], dtype=torch.bool, device=d)])
    # the flight time left to the wall each particle was last cast at
    # (none for the injected: they are cast in this step)
    t0 = torch.where(P.ints(r0[P.NEXT_FACET]) >= 0, r0[P.T_NEXT].double(), torch.nan)
    t_cast = torch.cat([t0, torch.full((rows_i.shape[1],), torch.nan, dtype=torch.float64, device=d)])
    T_sv = st["T_sv"].to(d).double()
    ref_out = f.advance(p_start, mode_start, dev_start, rem, rta, T_sv, t_cast=t_cast)
    amb = ref_out["amb"]
    amb[lanes.numel():] |= rem_i <= 2e-5  # a flight fraction at the program's dust edge
    if control:
        got = f.advance(p_start, mode_start, dev_start, rem, rta, T_sv, dtype=LOWER, t_cast=t_cast)
        g_p, g_mode, g_dev, g_alive = got["p"].double(), got["mode"], got["dev"].double(), got["alive"]
        g_rows = None
        cast_gap = got["cast_gap"]
    else:
        cast_gap = ref_out["cast_gap"]
        end = program_end(st, d)
        pick = torch.cat([lanes, tail0 + torch.arange(rows_i.shape[1], device=d)])
        g_rows = end[:, pick]
        g_p = g_rows[P.POS].T.double()
        g_mode = P.ints(g_rows[P.MODE]).long().clamp(0, c.M - 1)
        g_dev = g_rows[P.DEV].double()
        g_alive = g_rows[P.ALIVE] > 0.5
    off = _lanes_off(ref, ref_out, g_p, g_mode, g_dev, g_alive, g_rows)
    both = ref_out["alive"] & g_alive & ~amb
    om = c.omega[ref_out["mode"]]
    scale = torch.maximum(ref_out["dev"].abs(), 1e-3 * n0(torch.full_like(om, f.t_ref), om))
    gap = torch.where(both & (om > 0), (g_dev - ref_out["dev"]).abs() / scale.clamp(min=1e-300), 0.0)
    nums = dict(step_lanes_off=int(off.sum()), step_dev_gap=float(gap.max()) if gap.numel() else 0.0,
                cast_gap_A=cast_gap)
    for i in ([] if control else torch.nonzero(off).flatten()[:4].tolist()):  # what a differing particle did
        src = pool0[:, lanes[i]] if i < lanes.numel() else rows_i[:, i - lanes.numel()]
        print(f"reference: particle {i} off: start {src.tolist()}; the reference ends at "
              f"{ref_out['p'][i].tolist()} mode {int(ref_out['mode'][i])} alive {bool(ref_out['alive'][i])}; "
              f"the program at {g_p[i].tolist()} mode {int(g_mode[i])} alive {bool(g_alive[i])}",
              file=sys.stderr)

    # the reference's population with the ambiguous lanes' outcome taken
    # from the program
    fin_p = torch.where(amb[:, None], g_p, ref_out["p"])
    fin_mode = torch.where(amb, g_mode, ref_out["mode"])
    fin_dev = torch.where(amb, g_dev, ref_out["dev"])
    fin_alive = torch.where(amb, g_alive, ref_out["alive"])
    fin_sv = ref.box.slice_of(fin_p)
    if g_rows is not None:  # an ambiguous particle near a slice edge: the program's slice
        fin_sv = torch.where(amb, P.ints(g_rows[P.SLICE]).long().clamp(0, ref.box.n_slices - 1), fin_sv)
    led = ref_out["led"].clone()
    flip = amb & (ref_out["alive"] != g_alive)
    if bool(flip.any()):
        led += _absorbed(ref, ref_out, flip & ~g_alive) - _absorbed(ref, ref_out, flip & ~ref_out["alive"])
    log = dict(ambiguous=int(amb.sum()), drawn=int(ref_out["drawn"].sum()), lanes=int(amb.numel()))
    return nums, dict(p=fin_p, mode=fin_mode, dev=fin_dev, alive=fin_alive, sv=fin_sv, led=led, log=log)


def _absorbed(ref: Reference, out: dict, lanes: torch.Tensor) -> torch.Tensor:
    """(R, 6) ledger entries of `lanes` absorbed at the reservoir wall
    nearest their end place, with their end occupation."""
    from reference.physics import HBAR

    f, c, box = ref.film, ref.crystal, ref.box
    led = torch.zeros((f.R, 6), dtype=torch.float64, device=ref.device)
    idx = torch.nonzero(lanes).flatten()
    for i in idx.tolist():
        p = out["p"][i].double()
        w = min(box.reservoirs, key=lambda w: abs(float(p[w.axis]) - (box.L[w.axis] if w.side else 0.0)))
        m = int(out["mode"][i])
        om = c.omega[m]
        T_w = torch.tensor(w.value, dtype=torch.float64, device=ref.device)
        T_r = torch.tensor(f.t_ref, dtype=torch.float64, device=ref.device)
        e = HBAR * om * (out["dev"][i].double() - (n0(T_w, om) - n0(T_r, om)))
        v = c.vel[m]
        vn = torch.maximum(v[w.axis] * (1.0 if w.side else -1.0), 1e-3 * torch.linalg.vector_norm(v))
        led[w.reservoir] += torch.stack([e, e / vn * v[0], e / vn * v[1], e / vn * v[2], torch.ones_like(e), e.abs()])
    return led


def narrow_numbers(ref: Reference, st: dict, control: bool = False) -> tuple[dict, dict]:
    """narrow_lanes_off: particles that kernel A handed to the narrow rounds
    at the steps of the captured batch (each sitting on the wall it hits,
    its relaxation done) whose end state is not the reference's
    continuation of their flight."""
    d = ref.device
    c, f = ref.crystal, ref.film
    calls = st.get("narrow") or []
    if not calls:
        return dict(narrow_lanes_off=0), dict(lanes=0, ambiguous=0)
    rows = torch.cat([r.to(d)[:, v.to(d)] for r, v, _ in calls], 1)
    outs = torch.cat([o.to(d)[:, v.to(d)] for _, v, o in calls], 1)
    n = rows.shape[1]
    if n == 0:
        return dict(narrow_lanes_off=0), dict(lanes=0, ambiguous=0)
    mode = P.ints(rows[P.MODE]).long().clamp(0, c.M - 1)
    at_wall = torch.zeros(n, dtype=torch.float64, device=d)  # each sits on the wall it hits
    want = f.advance(rows[P.POS].T.double(), mode, rows[P.DEV].double(), rows[P.REM].double(),
                     torch.zeros(n, dtype=torch.bool, device=d), st["T_sv"].to(d).double(), t_cast=at_wall)
    if control:
        got = f.advance(rows[P.POS].T.double(), mode, rows[P.DEV].double(), rows[P.REM].double(),
                        torch.zeros(n, dtype=torch.bool, device=d), st["T_sv"].to(d).double(), dtype=LOWER,
                        t_cast=at_wall)
        g_p, g_mode, g_dev, g_alive, g_rows = got["p"].double(), got["mode"], got["dev"].double(), got["alive"], None
    else:
        g_p, g_mode = outs[P.POS].T.double(), P.ints(outs[P.MODE]).long().clamp(0, c.M - 1)
        g_dev, g_alive, g_rows = outs[P.DEV].double(), outs[P.ALIVE] > 0.5, outs
    off = _lanes_off(ref, want, g_p, g_mode, g_dev, g_alive, g_rows)
    return dict(narrow_lanes_off=int(off.sum())), dict(lanes=n, ambiguous=int(want["amb"].sum()))


def _lanes_off(ref: Reference, want: dict, g_p, g_mode, g_dev, g_alive, g_rows) -> torch.Tensor:
    """Lanes (not ambiguous) whose end state differs from the reference's:
    alive or not, the place beyond POS_TOL, the mode's class, the cached
    frequency and velocity, or the occupation beyond 1e-2 of its scale
    (a particle moved to a wrong mode or temperature; the occupation's
    rounding is step_dev_gap's to judge)."""
    c = ref.crystal
    amb = want["amb"]
    both = want["alive"] & g_alive & ~amb
    off = (want["alive"] != g_alive) & ~amb
    off |= both & ((g_p - want["p"]).abs().amax(1) > POS_TOL)
    off |= both & (c.mode_class[g_mode] != c.mode_class[want["mode"]])
    if g_rows is not None:
        off |= both & _cached_off(ref, g_rows, g_mode)
    return off


# ---------------------------------------------------------------------------
# the ledgers and the datapoint
# ---------------------------------------------------------------------------


def ledger_numbers(ref: Reference, st: dict, pop: dict, control: bool) -> dict:
    want = pop["led"]
    scale = want[:, 5].clamp(min=1e-300)  # the sum of |e| of the absorbed
    if control:
        got_n = want[:, 4].to(LOWER).double()
        got_e = want[:, 0].to(LOWER).double()
    else:
        got_n = torch.as_tensor(np.asarray(st["out"]["n_leaving"], np.float64), device=ref.device)
        got_e = torch.as_tensor(np.asarray(st["eb0"], np.float64) - np.asarray(st["eb1"], np.float64),
                                device=ref.device)
    return dict(ledger_count_off=int((got_n - want[:, 4]).abs().sum()),
                ledger_energy_gap=float(((got_e - want[:, 0]).abs() / scale).max()))


def kappa_slice(T_sv, phi_sv, Np_sv, res_T, length, axis):
    """The Fourier-law kappa of slices (Nano-kappa classes/Population.py
    :749-788): per slice from its neighbours' temperatures, the reservoirs'
    at both ends, and over the whole length."""
    n_sv = len(T_sv)
    T = np.concatenate([[res_T[0]], np.asarray(T_sv, float), [res_T[-1]]])
    phi = np.asarray(phi_sv, float)[:, axis]
    dx = 2 * length * A_IN_M / n_sv
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        k_sv = -phi * dx / (T[2:] - T[:-2])
    k_sv[~np.isfinite(k_sv)] = 0.0
    DX = length * A_IN_M * (1 + n_sv) / n_sv
    N_p = max(np.asarray(Np_sv).sum(), 1)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        k_tot = -np.sum(phi * np.asarray(Np_sv)) * (DX / (T[-1] - T[0])) / N_p
    return k_sv, float(k_tot) if np.isfinite(k_tot) else 0.0


def datapoint_numbers(ref: Reference, st: dict, row: dict, pop: dict, rows: list, control: bool) -> dict:
    f, c, box = ref.film, ref.crystal, ref.box
    T_in = st["T_sv"].to(ref.device).double()
    want = f.bins(pop["p"], pop["mode"], pop["dev"], pop["alive"], T_in, sv=pop["sv"])
    if control:
        got = f.bins(pop["p"], pop["mode"], pop["dev"], pop["alive"], T_in, dtype=LOWER, sv=pop["sv"])
        got = dict(Np=got["N"].cpu().numpy(), T=got["T"].cpu().numpy(), phi=got["phi"].cpu().numpy())
    else:
        got = dict(Np=np.asarray(row["Np"]), T=np.asarray(row["T"], float), phi=np.asarray(row["phi"], float))
    nums = dict(
        datapoint_Np_off=int(np.abs(np.asarray(got["Np"], np.int64) - want["N"].cpu().numpy()).sum()),
        datapoint_T_gap_K=float(np.abs(got["T"] - want["T"].cpu().numpy()).max()),
        datapoint_phi_gap=float((np.abs(got["phi"] - want["phi"].cpu().numpy()).max(1)
                                 / np.maximum(want["phi_scale"].cpu().numpy(), 1e-300)).max()),
    )
    # every datapoint of the window: T from its E, kappa from its T, phi, N
    res_T = np.array([w.value for w in box.reservoirs] or [300.0, 300.0])
    length = float(box.L[box.slice_axis])
    E = torch.as_tensor(np.stack([np.asarray(r["E"], float) for r in rows]), device=ref.device)
    T_prog = np.stack([np.asarray(r["T"], float) for r in rows])
    if control:
        E = E.to(LOWER).double()
    T_ref = c.temperature(E.reshape(-1), torch.as_tensor(T_prog.reshape(-1), device=ref.device))
    k_gap = 0.0
    for r in rows:
        T_r, phi_r = np.asarray(r["T"], float), np.asarray(r["phi"], float)
        k_sv, k_tot = kappa_slice(T_r, phi_r, r["Np"], res_T, length, box.slice_axis)
        if control:
            low = torch.as_tensor(np.concatenate([T_r, phi_r.reshape(-1)])).to(LOWER).double().numpy()
            g_sv, g_tot = kappa_slice(low[: len(T_r)], low[len(T_r):].reshape(phi_r.shape), r["Np"],
                                      res_T, length, box.slice_axis)
        else:
            g_sv, g_tot = np.asarray(r["kappa_sv"], float), float(r["kappa_total"])
        scale = max(np.max(np.abs(k_sv)), 1e-30)
        k_gap = max(k_gap, float(np.max(np.abs(g_sv - k_sv))) / scale,
                    abs(g_tot - k_tot) / max(abs(k_tot), 1e-30))
    nums.update(datapoint_TofE_gap_K=float(np.max(np.abs(T_ref.cpu().numpy() - T_prog.reshape(-1)))),
                datapoint_kappa_gap=k_gap)
    return nums


# ---------------------------------------------------------------------------
# the compaction
# ---------------------------------------------------------------------------


def compaction_numbers(ref: Reference, cp: dict | None, control: bool) -> dict:
    """compact_lanes_off: lanes of kernel B's output that are not the
    alive lanes of its input in their order, bit for bit (a gap in the
    count counts every lane it moves)."""
    if cp is None:
        return dict(compact_lanes_off=float("inf"))
    d = ref.device
    pin = cp["pool_in"].to(d)
    want = pin[:, pin[P.ALIVE] > 0.5]
    n = want.shape[1]
    if control:
        got = want.clone()
        for r in range(got.shape[0]):
            if r not in P.INT_ROWS and r != P.MODE and r != P.PARTNER:
                got[r] = got[r].to(LOWER).float()
        tail = n
    else:
        got = cp["pool_out"].to(d)
        tail = int(cp["tail"])
    m = min(n, tail, got.shape[1])
    a = got[:, :m].contiguous().view(torch.int32)
    b = want[:, :m].contiguous().view(torch.int32)
    off = int((a != b).any(0).sum()) + abs(tail - n)
    if not control and got.shape[1] > tail:
        off += int((got[P.ALIVE, tail:] > 0.5).sum())
    return dict(compact_lanes_off=off)


# ---------------------------------------------------------------------------
# the whole comparison
# ---------------------------------------------------------------------------


def judge(ref: Reference, snaps: dict, control: bool = False, log=None) -> dict:
    """Every number of the cell for the program's outputs in `snaps`
    ("step": the captured step, "row": its datapoint, "rows": the window's
    datapoints, "compact": the compaction after it); with `control`, for
    the bfloat16 reference in the program's place."""
    st = snaps.get("step")
    nums = {k: float("inf") for k in NUMBERS}  # what a stage cannot read fails
    if st is None or snaps.get("row") is None:
        return nums
    say = log or (lambda m: None)
    try:
        got, inj = injection(ref, st, control)
        nums.update(got)
        step_nums, pop = whole_step(ref, st, inj, control)
        nums.update(step_nums)
        nums.update(ledger_numbers(ref, st, pop, control))
        nums.update(datapoint_numbers(ref, st, snaps["row"], pop, snaps["rows"], control))
        say(f"reference: {pop['log']['lanes']} particles followed, {pop['log']['ambiguous']} ambiguous, "
            f"{pop['log']['drawn']} diffuse draws, {int(st['kept'])} exported to the narrow rounds, "
            f"{int(st['n_valid'])} injected")
    except (RuntimeError, ValueError, IndexError, KeyError) as e:  # the program's outputs malformed
        say(f"reference: the step could not be followed: {e!r}")
    try:
        got, info = narrow_numbers(ref, st, control)
        nums.update(got)
        say(f"reference: {info['lanes']} particles of the narrow rounds followed, {info['ambiguous']} ambiguous")
    except (RuntimeError, ValueError, IndexError, KeyError) as e:
        say(f"reference: the narrow rounds could not be followed: {e!r}")
    nums.update(compaction_numbers(ref, snaps.get("compact"), control))
    return nums


def verdict(nums: dict, limits: dict) -> bool:
    """Every number at or below its limit (a missing number fails)."""
    return all(k in nums and nums[k] <= limits[k] for k in limits)
