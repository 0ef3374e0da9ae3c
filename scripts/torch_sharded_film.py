"""The bench film in several ranks through the library, on one card.

    python scripts/torch_sharded_film.py [PARTICLES] [RANKS] [BLOCKS]    # default: 1e8 2 3

Starts RANKS gloo ranks, all on cuda:0 (parallel/launch.py; NCCL takes one
rank a card). Each builds the global initial state of chip_smoke.py's FILM
(31^3 synthetic Si table, 'pooled' reservoirs, pool margin 1.25) on the
host from the seed (init_state host_only; the ranks one after the other,
to bound the host memory), keeps its segment (shard_state),
and runs BLOCKS blocks of 10 x 10 steps (build_sharded_step, n_inner =
n_outer = 10): the first a warm-up, the rest timed. Prints, per rank, the
set-up time (its tables, its host init and its segment's move to the card;
each rank builds the 31^3 material first, not counted), the
ms/step of the timed blocks, the host time of its all-reduce a step, its
pool and the card's memory peak, then rank 0's T_sv and population, beside
the card's name and power limit. The ranks time-slice one card: ms/step is
a record, not a speed. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rank_main(comm, out_dir: str, particles: float, blocks: int):
    import torch
    import torch.distributed as dist

    from chip_smoke import FILM, MESH, SEED, build_ctx, run_params
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.parallel import build_sharded_step, shard_state
    from nanokappa_torch.sim.reservoir import autosize_inj_cap
    from nanokappa_torch.sim.state import init_state, round_pool_cap

    dev = comm.device
    mat = synthetic_material(mesh=(MESH, MESH, MESH))
    t0 = time.perf_counter()
    tabs = mat.device_tables(dev)
    dom, geo, btab = build_ctx(mat, FILM, dev)
    n_p, rtab, params = run_params(mat, dom, particles, "pooled", dev)
    S = comm.size
    params = replace(params, n_cap=round_pool_cap(int(n_p * 1.25), S),
                     inj_cap=autosize_inj_cap(rtab, S), n_shards=S)
    t_tables = time.perf_counter() - t0
    # the ranks build their global host states one after the other: at
    # 1e8 particles one takes ~40 GB of host memory at its peak
    for r in range(S):
        if r == comm.rank:
            t1 = time.perf_counter()
            host = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=SEED,
                              host_only=True)
            t_host = time.perf_counter() - t1
            state = shard_state(host, comm, geo, params.dt)
            del host
            torch.cuda.synchronize(dev)
            t_setup = t_tables + time.perf_counter() - t1
        dist.barrier()
    run = build_sharded_step(geo, tabs, btab, rtab, params, comm, n_inner=10, n_outer=10)
    state, out = run(state)  # warm-up
    torch.cuda.synchronize(dev)
    c0, s0 = comm.calls, comm.seconds
    t1 = time.perf_counter()
    for _ in range(blocks - 1):
        state, out = run(state)
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t1
    steps = (blocks - 1) * 100
    rec = dict(
        rank=comm.rank, n_p=n_p, n_cap=params.n_cap, pool=int(state.pool.shape[1]),
        pool_gb=state.pool.numel() * 4 / 1e9, tables_s=t_tables, host_init_s=t_host,
        setup_s=t_setup, ms=dt / max(steps, 1) * 1e3,
        allreduce_ms=(comm.seconds - s0) / max(comm.calls - c0, 1) * 1e3,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        T=out.T_sv[-1].cpu().numpy().tolist(), N_p=int(out.N_p[-1]),
        lost=out.lost_split[-1].cpu().numpy().tolist(), steps=steps,
    )
    with open(os.path.join(out_dir, f"rank{comm.rank}.json"), "w") as f:
        json.dump(rec, f)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_sharded_film: needs a CUDA card")
    from chip_smoke import card_line
    from nanokappa_torch.parallel.launch import launch

    particles = float(sys.argv[1]) if len(sys.argv) > 1 else 1e8
    ranks = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    blocks = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    card = card_line()
    print(card, flush=True)
    td = tempfile.mkdtemp(prefix="sharded_film_")
    t0 = time.perf_counter()
    launch(rank_main, ranks, td, "gloo", "cuda:0", td, particles, blocks)
    wall = time.perf_counter() - t0
    recs = []
    for r in range(ranks):
        with open(os.path.join(td, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    for r in recs:
        print(f"rank {r['rank']}: tables {r['tables_s']:.1f} s, host init {r['host_init_s']:.1f} s, "
              f"set-up {r['setup_s']:.1f} s; {r['ms']:.3f} ms/step over {r['steps']} steps; all-reduce "
              f"{r['allreduce_ms']:.4f} ms of host time a step; pool {r['pool']} lanes "
              f"({r['pool_gb']:.2f} GB), peak {r['peak_gb']:.2f} GB on {card}", flush=True)
    r0 = recs[0]
    print(f"{r0['n_p']} particles in {ranks} ranks on cuda:0 (pool {r0['n_cap']}): T_sv "
          f"{[round(t, 3) for t in r0['T']]}, N_p {r0['N_p']}, lost {r0['lost']}; wall {wall:.1f} s "
          f"on {card}", flush=True)
    print(json.dumps({"sharded_film": recs, "card": card, "wall_s": wall}), flush=True)


if __name__ == "__main__":
    main()
