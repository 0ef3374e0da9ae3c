"""Particle-axis sharding over torch.distributed (sharding.py) and the
launch of its ranks (launch.py)."""

from nanokappa_torch.parallel.sharding import (
    ShardComm, build_ensemble_step, build_sharded_step, make_ensemble_groups,
    make_particle_group, shard_seed, shard_state, stack_ensemble_state,
)

__all__ = [
    "ShardComm", "build_ensemble_step", "build_sharded_step", "make_ensemble_groups",
    "make_particle_group", "shard_seed", "shard_state", "stack_ensemble_state",
]
