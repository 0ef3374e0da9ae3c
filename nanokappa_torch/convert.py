"""Conversion between the JAX package's data and the port's objects.

The JAX package's dataclasses arrive as dicts of NumPy arrays keyed by their
field names (`{f.name: np.asarray(getattr(obj, f.name))}`); this module
imports neither jax nor the JAX package.

  * `state_from_jax` / `state_to_jax`: SimState. The JAX package carries a
    packed (N, 16) row matrix and an (N, 8) specular-mirror cache; the port
    carries one pool in the layout its tag names (sim/state.py): "slim" is
    (18, N), the 16 columns as rows, then the mirror's partner mode and
    lifetime slope; "full" is (24, N), the 16 columns then the whole
    mirror cache's 8; "plain" is the 16 rows alone (a JAX
    in-kernel-diffuse pool's derived rows 16-17, |k|^2 and the partner
    bitmask, are dropped: the port's kernel gathers them per mode). Back to
    JAX, the slim layout rebuilds the full mirror cache (exact under the
    slim gate), the full layout gives its rows 16-23 back, and the plain
    layout gives an unfilled cache (X_MODE = -1). The JAX v2 step keeps its
    pool's tail in free_count[0], the JAX v1 step a free list of dead lanes
    (ascending, its depth in free_count[0]); `v1=True` converts that one:
    to the port, the tail is past the last alive lane; back to JAX, the
    free list holds every dead lane.
  * `shards_from_jax`: the port's per-rank states of a JAX state built with
    n_shards = S (global arrays, free_count (S,), res_counter (S, R, M)),
    as parallel/sharding.py shard_state splits the port's: rank s keeps
    lane segment s, free_count[s] and its segment of the free list (the
    JAX init's local free lists), res_counter[s], the replicated arrays.
  * `tables_from_jax`: MaterialTables, DeviceGeometry (the triangle tables
    and the grid/voronoi centres included; the centres' |c|^2 are derived
    from them), BoundaryTables (diff2 included) and ReservoirTables, field
    for field; kernel A's per-facet tables are built from these by
    ops/megastep.py mega_config.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nanokappa_torch.geometry.device import resolve_device
from nanokappa_torch.sim.state import (
    C_ALIVE, M_COLS, X_MODE, X_TAUB, SimState, make_generator,
)


def state_from_jax(d: dict, layout: str, device=None, seed: int = 0, v1: bool = False) -> SimState:
    """The port's SimState, in `layout` ("slim" | "full" | "plain"), from a JAX
    SimState's arrays (on `device`, the card unless named); `v1` for a JAX
    v1 state (a free list, not a tail). The port's random stream is a torch
    Generator seeded with `seed` (threefry keys do not carry over)."""
    device = resolve_device(device)
    packed = np.asarray(d["packed"], np.float32)[:, :16]
    if layout == "slim":
        mirror = np.asarray(d["mirror"], np.float32)
        pool = np.concatenate([packed.T, mirror[:, [X_MODE, X_TAUB]].T], axis=0)
    elif layout == "full":
        pool = np.concatenate([packed.T, np.asarray(d["mirror"], np.float32).T], axis=0)
    elif layout == "plain":
        pool = packed.T
    else:
        raise ValueError(f"unknown pool layout {layout!r}")

    def t(name, dtype):
        return torch.as_tensor(np.array(d[name], dtype), device=device)

    return SimState(
        pool=torch.as_tensor(np.ascontiguousarray(pool), device=device),
        layout=layout,
        T_sv=t("T_sv", np.float32),
        Np_sv=t("Np_sv", np.int32),
        T_tau=t("T_tau", np.float32),
        tail=_last_alive(packed) + 1 if v1 else int(np.asarray(d["free_count"])[0]),
        res_counter=np.array(d["res_counter"], np.float32),
        n_leaving=t("n_leaving", np.int32),
        res_energy_balance=t("res_energy_balance", np.float32),
        res_heat_flux=t("res_heat_flux", np.float32),
        lost=t("lost", np.int32),
        frozen=t("frozen", np.int32),
        kernel_events=torch.zeros(4, dtype=torch.int64, device=device),
        gen=make_generator(seed, device),
        step=int(np.asarray(d["step"])),
    )


def shards_from_jax(d: dict, layout: str, device=None, seed: int = 0, v1: bool = False) -> list[SimState]:
    """The port's S per-rank SimStates of a JAX SimState built with
    n_shards = S (S = len(d["free_count"])), each as state_from_jax reads
    it: with `v1` (a fresh JAX init's local free lists) the tail past the
    segment's last alive lane, else free_count[s]. Rank s draws from
    parallel/sharding.py shard_seed(seed, s)."""
    from nanokappa_torch.parallel.sharding import shard_seed

    S = len(np.asarray(d["free_count"]))
    N = np.asarray(d["packed"]).shape[0]
    n = N // S
    out = []
    for s in range(S):
        seg = dict(d)
        for k, v in d.items():
            v = np.asarray(v)
            if v.ndim >= 1 and v.shape[0] == N:
                seg[k] = v[s * n:(s + 1) * n]
        seg["free_count"] = np.asarray(d["free_count"])[s:s + 1]
        seg["res_counter"] = np.asarray(d["res_counter"])[s:s + 1]
        out.append(state_from_jax(seg, layout, device, shard_seed(seed, s), v1))
    return out


def _last_alive(packed: np.ndarray) -> int:
    alive = np.nonzero(packed[:, C_ALIVE] > 0.5)[0]
    return int(alive[-1]) if len(alive) else -1


def state_to_jax(state: SimState, flip_axis: int | None = None, v1: bool = False) -> dict:
    """A JAX SimState's arrays (without its PRNG key) from the port's state;
    `flip_axis` is the slim gate's wall axis (sim/boundary_tables.py
    slim_mirror_axis), needed on the slim layout only; `v1` for the JAX v1
    step, which injects into a free list of the dead lanes."""
    from nanokappa_torch.sim.fused import expand_slim_mirror

    pool = state.pool
    n = pool.shape[1]

    def a(t):
        return t.detach().cpu().numpy()

    if state.layout == "slim":
        mirror = a(expand_slim_mirror(pool, flip_axis))
    elif state.layout == "full":
        mirror = np.ascontiguousarray(a(pool[16:]).T)
    else:
        mirror = np.zeros((n, M_COLS), np.float32)
        mirror[:, X_MODE] = np.full(n, -1, np.int32).view(np.float32)
    packed = np.ascontiguousarray(a(pool[:16]).T)
    free_list = np.zeros(n, np.int32)
    free_count = np.array([state.tail], np.int32)
    if v1:
        dead = np.nonzero(packed[:, C_ALIVE] < 0.5)[0].astype(np.int32)
        free_list[: len(dead)] = dead
        free_count[0] = len(dead)
    return dict(
        packed=packed,
        mirror=mirror,
        sv_id=a(state.sv_col),
        T_sv=a(state.T_sv),
        Np_sv=a(state.Np_sv),
        T_tau=a(state.T_tau),
        free_list=free_list,
        free_count=free_count,
        res_counter=state.res_counter.copy(),
        n_leaving=a(state.n_leaving),
        res_energy_balance=a(state.res_energy_balance),
        res_heat_flux=a(state.res_heat_flux),
        lost=a(state.lost),
        frozen=a(state.frozen),
        step=np.int32(state.step),
    )


_STATIC = {"int": int, "float": float, "str": str, "bool": bool}


def tables_from_jax(cls, d: dict, device=None):
    """An instance of the port's table dataclass `cls` (MaterialTables,
    DeviceGeometry, BoundaryTables, ReservoirTables) from the JAX object's
    field arrays: torch fields become tensors on `device` (the card unless
    named), NumPy fields stay NumPy, static fields become Python scalars."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        kind = str(f.type)
        if "Tensor" in kind:
            kw[f.name] = torch.as_tensor(np.array(v), device=device)
        elif "ndarray" in kind:
            kw[f.name] = np.asarray(v)
        else:
            kw[f.name] = _STATIC[kind](np.asarray(v).item())
    return cls(**kw)
