"""Particle-escape self-healing (reference contains_check,
classes/Population.py:1712-1722; the JAX package's nanokappa_tpu/sim/repair.py).

Numerical round-off occasionally pushes a particle through a wall. Every 100
timesteps the driver moves the alive particles found outside the bounding
box (beyond a tolerance) to a point drawn from a pool of interior points
(sampled once on the host) and re-casts them at once — kernel E on a large
mesh; mode and occupation are untouched, as in the reference.
"""

from __future__ import annotations

import torch

from nanokappa_torch.geometry.device import DeviceGeometry
from nanokappa_torch.sim.state import C_CF, C_POS, C_TCOLL, C_VEL, SimState, as_f32

_TOL = 1e-2  # angstrom; bounding-box escape tolerance (reference uses 1e-10
#              in f64; f32 positions at 2e4 A scale carry ~1e-3 A of noise)


def make_contains_check(geo: DeviceGeometry, interior_pool: torch.Tensor, dt: float = 1.0):
    """Returns check(state, gen) -> (state, n_escaped () int32 tensor); the
    state is repaired in place, `gen` (a torch.Generator on the state's
    device) draws the replacement points."""
    from nanokappa_torch.ops.raycast import raycast

    lo, hi = geo.bounds[0], geo.bounds[1]

    def check(state: SimState, gen: torch.Generator):
        pool = state.pool
        pos = pool[C_POS].T
        out = state.alive & (
            (pos < lo[None] - _TOL).any(dim=1) | (pos > hi[None] + _TOL).any(dim=1)
        )
        idx = torch.randint(
            0, interior_pool.shape[0], (pos.shape[0],), generator=gen, device=pos.device
        )
        new_pos = torch.where(out[:, None], interior_pool[idx], pos)
        # re-cast the repaired particles at once (the step re-casts nothing
        # that is not stale)
        t, f = raycast(
            geo, new_pos, pool[C_VEL].T,
            torch.full((pos.shape[0],), -1, dtype=torch.int32, device=pos.device),
        )
        pool[C_TCOLL] = torch.where(out, t / dt, pool[C_TCOLL])
        pool[C_CF] = torch.where(out, as_f32(f), pool[C_CF])
        pool[C_POS] = new_pos.T
        return state, out.sum(dtype=torch.int32)

    return check
