"""One timestep of a box film in the reference's own arithmetic.

The semantics (Nano-kappa run_timestep, classes/Population.py, with the
scattering of a step applied at the start of the next one, which gives the
same state at every step's end):

1. every particle that was alive at the end of the previous step relaxes
   toward equilibrium at its slice's temperature, n - n0(T) -> (n -
   n0(T)) exp(-dt / tau(T)), T the slice's temperature at the step's start
   and tau the lifetime table's linear interpolation in T;
2. the reservoirs inject: a pooled fractional accumulator per reservoir
   (float32, its rate the sum over modes of the entry rates) fixes the
   count; each particle sits on its reservoir's wall with a mode that
   enters through it, the occupation n0(T_res) and a flight of a fraction
   of the step (its mode, place and fraction are draws, read from the
   program's rows);
3. every particle flies for the rest of its step, straight, from wall to
   wall: at a reservoir wall it is absorbed and its energy
   e = hbar omega (n - n0(T_res)) and e v / (v . n) (|v . n| at least
   1e-3 |v|) enter the reservoir's ledger; at a periodic wall it re-enters
   through the opposite one; at a smooth (eta = 0) wall it reflects
   specularly into its mirror mode, its occupation n kept;
4. the slices bin the particles that stay: N, sum of e = hbar omega (n -
   n0(T_slice)) and of e v; E = E(T) + the mean particle energy density
   (N_active / N of the slice), and T is E inverted.

A particle that has flown since its last wall carries the time left to
the next wall it was cast at (the program's state, in float32): its flight
in this step ends on that wall when that time runs out, at the place the
time takes it to, which rounding puts a little off the wall; the
reference checks that place against the geometry (cast_gap_A) and casts
every later flight itself.

Occupations are carried as the deviation n - n0(T_ref) of the program's
pool. A particle whose outcome hangs on a rounding (a wall reached within
1e-4 of a step of the step's end, or with less than 2e-5 of the step left,
two walls within 1e-4 of a step of each other, or a slice edge within
1e-2 A) is "ambiguous": both outcomes are right, and the check takes the
program's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.physics import COND_PERIODIC, COND_ROUGH, COND_TEMPERATURE, HBAR, Box, Crystal, n0

AMBIG_T = 1e-4  # of a step
REMAIN_EPS = 2e-5  # of a step
AMBIG_X = 1e-2  # A
MAX_BOUNCES = 64


class FilmStep:
    """The reference's step for one box configuration."""

    def __init__(self, crystal: Crystal, box: Box, dt: float, n_particles: int):
        self.c, self.box, self.dt = crystal, box, float(dt)
        self.t_ref = box.t_reference()
        self.R = len(box.reservoirs)
        self.rates = box.entry_rates(crystal, n_particles, self.dt)  # (R, M)
        self.lam32 = self.rates.sum(axis=1).astype(np.float32)
        self.partner = {
            (w.axis, w.side): crystal.mirror_partner(w.outward)
            for w in box.walls if w.cond == COND_ROUGH
        }
        for w in box.walls:
            if w.cond == COND_ROUGH and w.value != 0.0:
                raise ValueError("the reference reflects smooth (eta = 0) walls only")

    # -- the reservoirs ------------------------------------------------------

    def pooled_counts(self, counter: np.ndarray) -> np.ndarray:
        """(R,) particles each reservoir injects this step, from its
        accumulator before the step."""
        c = np.asarray(counter, np.float32)
        c = c[0, :, 0] if c.ndim == 3 else c.reshape(-1)[: self.R]  # (shards, R, M): the pooled scheme's
        acc = c + self.lam32
        return np.floor(acc).astype(np.int64)

    def injected_dev(self, res: torch.Tensor, mode: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        T = torch.as_tensor([w.value for w in self.box.reservoirs], dtype=dtype, device=self.c.device)[res]
        om = self.c.omega[mode.long()].to(dtype)
        return n0(T, om) - n0(torch.full_like(T, self.t_ref), om)

    def slim_partner(self, mode: torch.Tensor) -> torch.Tensor:
        """The partner a mode reflects into at the rough wall it moves
        toward (-1 where it moves toward none)."""
        out = torch.full_like(mode.long(), -1)
        for (a, s), p in self.partner.items():
            v = self.c.vel[mode.long(), a]
            toward = (v > 0) if s else (v < 0)
            out = torch.where(toward, p[mode.long()], out)
        return out

    # -- the flight ------------------------------------------------------------

    def advance(self, p, mode, dev, rem, rta, T_sv, dtype=torch.float64, t_cast=None) -> dict:
        """Relax (where `rta`) and fly each particle for `rem` of a step
        from position p (N, 3) in mode `mode` with deviation `dev`; where
        `t_cast` (steps) is finite, its first wall is met when that time
        runs out. Returns its end state, the ambiguous lanes, the (R, 6)
        ledger [e, e vx/(v.n), e vy/(v.n), e vz/(v.n), count, |e|] and the
        largest gap between a cast time's place and its wall, in A."""
        c, box, dt = self.c, self.box, self.dt
        N = p.shape[0]
        d = c.device
        L = torch.as_tensor(box.L, dtype=dtype, device=d)
        p = p.to(dtype).clone()
        mode = mode.long().clone()
        dev = dev.to(dtype).clone()
        om = c.omega[mode].to(dtype)
        T_ref = torch.full((N,), self.t_ref, dtype=dtype, device=d)
        amb = torch.zeros(N, dtype=torch.bool, device=d)
        drawn = torch.zeros(N, dtype=torch.bool, device=d)

        # 1. relaxation at the slice's temperature
        T_p = T_sv.to(dtype)[box.slice_of(p.double())]
        g = n0(T_p, om) - n0(T_ref, om)
        tau = c.lifetime(T_p, mode)
        decay = torch.where(tau > 0, torch.exp(-dt / torch.where(tau > 0, tau, torch.ones_like(tau))),
                            torch.zeros_like(tau))
        dev = torch.where(rta, g + (dev - g) * decay, dev)
        amb |= rta & (box.slice_edge_gap(p.double()) <= AMBIG_X)
        pd = p.double()
        amb |= ((pd < -AMBIG_X) | (pd > torch.as_tensor(box.L, device=d) + AMBIG_X)).any(1)

        # 2. the flight, wall to wall
        alive = torch.ones(N, dtype=torch.bool, device=d)
        t_left = rem.to(dtype) * dt
        led = torch.zeros((max(self.R, 1), 6), dtype=torch.float64, device=d)
        inf = torch.tensor(math.inf, dtype=dtype, device=d)
        cached = torch.zeros(N, dtype=torch.bool, device=d)
        if t_cast is not None:
            cached = torch.isfinite(t_cast) & (t_cast >= 0)
            t_c = torch.where(cached, t_cast, torch.zeros_like(t_cast)).to(dtype) * dt
        cast_gap = torch.zeros((), dtype=torch.float64, device=d)
        for k in range(MAX_BOUNCES):
            act = alive & (t_left > 0)
            if not bool(act.any()):
                break
            v = c.vel[mode].to(dtype)
            tw = torch.where(v > 0, (L[None] - p) / v, torch.where(v < 0, -p / v, inf))
            tw = torch.clamp(tw, min=0.0)
            ts, order = torch.sort(tw, dim=1)
            t_hit, ax = ts[:, 0], order[:, 0]
            snap = torch.ones(N, dtype=torch.bool, device=d)
            if k == 0 and bool(cached.any()):
                # the cast time decides the first wall: the wall whose
                # time it is nearest
                near = (tw - t_c[:, None]).abs()
                ax_c = near.argmin(1)
                t_g = tw.gather(1, ax_c[:, None])[:, 0]
                gap_t = (t_g - t_c).abs()
                other = torch.where(torch.arange(3, device=d)[None] == ax_c[:, None], inf, near).amin(1)
                amb |= act & cached & (other <= gap_t + AMBIG_T * dt)
                g = torch.where(act & cached, gap_t * v.gather(1, ax_c[:, None])[:, 0].abs(),
                                torch.zeros_like(gap_t))
                cast_gap = torch.maximum(cast_gap, g.double().max())
                t_hit = torch.where(cached, t_c, t_hit)
                ax = torch.where(cached, ax_c, ax)
                snap = ~cached
            hit = act & (t_hit < t_left)
            amb |= act & ((t_hit - t_left).abs() <= AMBIG_T * dt)
            amb |= hit & (t_left - t_hit <= REMAIN_EPS * dt)
            amb |= hit & snap & ((ts[:, 1] - t_hit).abs() <= AMBIG_T * dt)
            step = torch.where(act, torch.where(hit, t_hit, t_left), torch.zeros_like(t_left))
            p = p + v * step[:, None]
            t_left = torch.where(hit, t_left - t_hit, torch.zeros_like(t_left))
            side = (v.gather(1, ax[:, None])[:, 0] > 0).long()
            for w in box.walls:
                m = hit & (ax == w.axis) & (side == w.side)
                if not bool(m.any()):
                    continue
                plane = float(box.L[w.axis]) if w.side else 0.0
                p[:, w.axis] = torch.where(m & snap, torch.as_tensor(plane, dtype=dtype, device=d), p[:, w.axis])
                if w.cond == COND_TEMPERATURE:
                    T_w = torch.full_like(om, w.value)
                    e = HBAR * om * (dev - (n0(T_w, om) - n0(T_ref, om)))
                    vn = v[:, w.axis] * (1.0 if w.side else -1.0)
                    vmag = torch.linalg.vector_norm(v, dim=1)
                    vn = torch.maximum(vn, 1e-3 * vmag)
                    fw = e / vn
                    vals = torch.stack([e, fw * v[:, 0], fw * v[:, 1], fw * v[:, 2], torch.ones_like(e), e.abs()], 1)
                    led[w.reservoir] += torch.where(m[:, None], vals, torch.zeros_like(vals)).double().sum(0)
                    alive &= ~m
                    t_left = torch.where(m, torch.zeros_like(t_left), t_left)
                elif w.cond == COND_PERIODIC:
                    shift = -float(box.L[w.axis]) if w.side else float(box.L[w.axis])
                    p[:, w.axis] = torch.where(m, p[:, w.axis] + shift, p[:, w.axis])
                else:  # smooth wall: the mirror mode, n kept
                    part = self.partner[(w.axis, w.side)][mode]
                    ok = m & (part >= 0)
                    drawn |= m & (part < 0)  # no mirror mode: a diffuse draw
                    new = torch.where(ok, part, mode)
                    om_new = c.omega[new].to(dtype)
                    dev = torch.where(ok, dev + n0(T_ref, om) - n0(T_ref, om_new), dev)
                    mode, om = new, om_new
        amb |= alive & (t_left > 0)  # out of bounces
        amb |= alive & (box.slice_edge_gap(p.double()) <= AMBIG_X)
        amb |= drawn
        return dict(p=p, mode=mode, dev=dev, alive=alive, amb=amb, drawn=drawn,
                    led=led[: self.R], cast_gap=float(cast_gap))

    # -- the slices ---------------------------------------------------------------

    def bins(self, p, mode, dev, alive, T_in, dtype=torch.float64, sv=None) -> dict:
        """The slices' N, E, T and heat flux of a population at its step's
        end (its slices `sv`, by default those of p), T_in the slices'
        temperatures at the step's start."""
        c, box = self.c, self.box
        from reference.physics import EVPSA2_IN_WM2

        sv = box.slice_of(p.double()) if sv is None else sv
        om = c.omega[mode.long()].to(dtype)
        T_l = T_in.to(dtype)[sv]
        e = HBAR * om * (dev.to(dtype) - (n0(T_l, om) - n0(torch.full_like(T_l, self.t_ref), om)))
        e = torch.where(alive, e, torch.zeros_like(e))
        v = c.vel[mode.long()].to(dtype)
        vals = torch.cat([e[:, None], e[:, None] * v, alive.to(dtype)[:, None], e.abs()[:, None] * v.abs()], 1)
        S = box.n_slices
        sums = torch.zeros((S + 1, 8), dtype=torch.float64, device=c.device)
        sums.index_add_(0, torch.where(alive, sv, S), vals.double())
        sums = sums[:S].to(dtype).double()
        n = sums[:, 4].round()
        norm = torch.where(n > 0, c.n_active / n.clamp(min=1.0), 0.0)
        E = (sums[:, 0] * norm * c.dens).to(dtype).double() + c.energy(T_in)
        T = c.temperature(E.to(dtype).double(), T_in)
        phi = sums[:, 1:4] * (norm * c.dens)[:, None] * EVPSA2_IN_WM2
        scale = sums[:, 5:8].amax(1) * norm * c.dens * EVPSA2_IN_WM2
        return dict(N=n.long(), E=E, T=T, phi=phi, phi_scale=scale)
