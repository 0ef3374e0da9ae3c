"""k_max-stuck lanes on the large mesh, the port against the JAX package.

Lanes still bouncing after k_max narrow rounds are quarantined (the second
entry of `lost`). This counts them on the bench ladder's 96-sided cylinder
(bench.py:build_bigmesh_ctx, its geometry and boundaries) at a small
material and population, on the CPU, for one of three steps started from
the port's initial state of one seed:

  port        the port's step (kernel twins; kernel E's twin in the narrow
              rounds)
  jax_v2      the JAX v2 fused step with kernel_cast off and its narrow
              rounds cast through the Pallas large-mesh kernel
              (ops/raycast_pallas.py, in interpret mode) — the reference's
              own path for this mesh on its accelerator
  jax_v1      the JAX v1 step (XLA; Moller-Trumbore cast, 1e-5 tolerance)

    JAX_PLATFORMS=cpu python tests/torch_stuck_lanes.py port 8 5e4 20 0 1 2

(arguments: step, material mesh, particles, steps, seeds). Prints one line
per seed: lost [drops, stuck, defective], the population, and the stuck
lanes per particle-step.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BIGMESH = dict(
    geometry="cylinder", dimensions=(4e3, 500.0, 96), subvolumes=("slice", 5, 2),
    bound_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1, 1.1, 0.5, 0.5),
    bound_cond=("T", "T", "R", "R"), bound_values=(305.0, 295.0, 2.0, 2.0),
    connect_pos=("relative",),
)


def pallas_narrow_cast(jgeo):
    """Route the JAX package's large-mesh casts through the Pallas kernel in
    interpret mode (on the CPU its dispatch takes the XLA scan instead)."""
    import nanokappa_tpu.ops.raycast as jr
    import nanokappa_tpu.ops.raycast_pallas as rp
    import nanokappa_tpu.sim.cascade as jc

    tables = rp._prep(jgeo)  # concrete tables, built outside any trace
    rp._prep = lambda geo: tables
    scan = jr.raycast

    def cast(geo, pos, vel, exclude):
        if not geo.is_box and geo.tri_origin.shape[0] > jr._CHUNK_F:
            return rp.raycast_pallas(geo, pos, vel, exclude, interpret=True)
        return scan(geo, pos, vel, exclude)

    jr.raycast = cast
    jc.raycast = cast


def main(which: str, mesh: int, particles: float, steps: int, seeds: list[int]) -> None:
    import torch

    from nanokappa_torch.convert import state_to_jax
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.reservoir import (
        autosize_c_max, autosize_inj_cap, build_reservoir_tables,
    )
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count, round_pool_cap
    from nanokappa_torch.sim.step import build_step

    torch.set_num_threads(4)
    dom = build_domain(**BIGMESH)
    mat = synthetic_material(mesh=(mesh,) * 3)
    n_p, rho = particle_count(("total", particles), mat, dom)
    rtab = build_reservoir_tables(mat, dom, 1.0, rho, device="cpu")
    common = dict(
        dt=1.0, n_cap=round_pool_cap(int(n_p * 1.25)), inj_cap=autosize_inj_cap(rtab),
        c_max=autosize_c_max(rtab), temp_interp="nearest", res_gen="constant",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
    )
    geo = build_device_geometry(dom, "cpu")
    btab = build_boundary_tables(mat, dom, device="cpu")
    params = SimParams(**common)
    if which == "port":
        run = build_step(geo, mat.device_tables("cpu"), btab, rtab, params, n_inner=1, n_outer=steps)
    else:
        import jax

        from nanokappa_tpu.geometry import domain as jdom_mod
        from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
        from nanokappa_tpu.material import synthetic_material as j_mat
        from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
        from nanokappa_tpu.sim.reservoir import build_reservoir_tables as j_rt
        from nanokappa_tpu.sim.state import SimParams as JParams, SimState as JState
        from nanokappa_tpu.sim.step import make_step

        jdom_mod._mc_subvol_volume = lambda *a, **k: dom.subvol_volume.copy()
        jdom = jdom_mod.build_domain(**BIGMESH)
        jmat = j_mat(mesh=(mesh,) * 3)
        jgeo = j_geo(jdom)
        if which == "jax_v2":
            pallas_narrow_cast(jgeo)
        step = jax.jit(make_step(
            jgeo, jmat.device_tables(), j_bt(jmat, jdom), j_rt(jmat, jdom, 1.0, rho),
            JParams(step_impl=which[-2:], **common),
        ))
    for seed in seeds:
        state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=seed)
        t0 = time.time()
        if which == "port":
            _, out = run(state)
            lost, n_alive = out.lost_split[-1].tolist(), int(out.N_p[-1])
        else:
            d = state_to_jax(state)
            if which == "jax_v1":
                dead = np.nonzero(d["packed"][:, 14] < 0.5)[0].astype(np.int32)
                d["free_list"][: len(dead)] = dead  # the v1 step injects into free slots
                d["free_count"] = np.array([len(dead)], np.int32)
            js = JState(**{k: jax.numpy.asarray(v) for k, v in d.items()},
                        key=jax.random.PRNGKey(seed))
            for _ in range(steps):
                js, jo = step(js)
            lost, n_alive = np.asarray(js.lost).tolist(), int(jo.N_p)
        rate = lost[1] / (n_p * steps)
        print(f"{which} mesh {mesh} particles {n_p} steps {steps} seed {seed}: lost {lost} "
              f"N_p {n_alive} stuck/particle-step {rate:.3e} ({time.time() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], int(a[1]), float(a[2]), int(a[3]), [int(s) for s in a[4:]] or [0])
