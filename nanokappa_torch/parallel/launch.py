"""Start the ranks of a sharded run.

    launch(fn, n_ranks, rdv_dir, backend, devices, *args)

runs fn(comm, *args) in n_ranks processes started with the `spawn` method
(CUDA cannot run in a forked child), each with its process group set up
through a `file://` rendezvous in `rdv_dir` (no port to pick, so runs side
by side never compete for one) and `comm` its ShardComm over all ranks.
The backend and each rank's device are the caller's choice:
  * the CLI on cards: "nccl", rank r on cuda:r (one rank a card);
  * the CLI and the tests on the CPU: "gloo", every rank on "cpu";
  * several ranks on ONE card (NCCL refuses two ranks on one GPU): "gloo",
    whose all-reduce and broadcast take CUDA tensors.
A rank that raises makes the launch raise (the spawn join stops the other
ranks and re-raises it); nothing retries, and nothing switches backend.
`fn` and `args` must pickle: a module-level function and plain data.
"""

from __future__ import annotations

import os
import uuid
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nanokappa_torch.parallel.sharding import make_particle_group

TIMEOUT = timedelta(minutes=10)  # a collective that waits longer fails


def launch(fn, n_ranks: int, rdv_dir: str, backend: str, devices, *args) -> None:
    """Run fn(comm, *args) on n_ranks spawned ranks; `devices` names each
    rank's device (a list of n_ranks, or one device for every rank)."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n_ranks
    devices = [str(d) for d in devices]
    if len(devices) != n_ranks:
        raise ValueError(f"{len(devices)} devices for {n_ranks} ranks")
    os.makedirs(rdv_dir, exist_ok=True)
    # a fresh file a launch: a file store left by another run would not
    # rendezvous
    store = os.path.join(os.path.abspath(rdv_dir), f"rdv-{uuid.uuid4().hex}")
    try:
        mp.spawn(_rank_main, args=(fn, n_ranks, store, backend, devices, args),
                 nprocs=n_ranks, join=True)
    finally:
        if os.path.exists(store):
            os.remove(store)


def _rank_main(rank: int, fn, n_ranks: int, store: str, backend: str, devices, args):
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # ranks on the CPU share its cores
        torch.set_num_threads(min(torch.get_num_threads(), max(1, (os.cpu_count() or 1) // n_ranks)))
    dist.init_process_group(
        backend, init_method=f"file://{store}", world_size=n_ranks, rank=rank,
        timeout=TIMEOUT,
    )
    try:
        fn(make_particle_group(n_ranks, device), *args)
    finally:
        dist.destroy_process_group()


def shard_count(n_shards: int, device: str) -> int:
    """The ranks of `--n_shards n_shards --device device`: 0 is one rank,
    as the JAX driver runs it (nanokappa_tpu/driver.py:149, `n_shards or
    1`), on the card and on the CPU. More shards than visible cards raise,
    as a JAX mesh over too few devices does."""
    n = n_shards or 1
    if torch.device(device).type != "cuda":
        return n
    avail = torch.cuda.device_count()
    if n > 1 and n > avail:
        raise SystemExit(
            f"ERROR: --n_shards {n} needs {n} CUDA cards, one a rank; "
            f"this machine shows {avail}"
        )
    return n


def rank_devices(n_ranks: int, device: str) -> tuple[str, list[str]]:
    """(backend, devices) of the CLI's ranks: NCCL with rank r on cuda:r on
    cards, gloo on the CPU."""
    if torch.device(device).type == "cuda":
        return "nccl", [f"cuda:{r}" for r in range(n_ranks)]
    return "gloo", [str(device)] * n_ranks
