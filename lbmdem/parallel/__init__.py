"""Multi-device distribution layer (SURVEY.md SS5.7/5.8): lattice sharding
over a device mesh via shard_map, halo exchange, particle-force psum, and
multi-process launch."""

from lbmdem.parallel.launch import init_distributed, process_info
from lbmdem.parallel.sharding import (
    make_mesh,
    make_sharded_step,
    shard_state,
    state_specs,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "make_sharded_step",
    "process_info",
    "shard_state",
    "state_specs",
]
