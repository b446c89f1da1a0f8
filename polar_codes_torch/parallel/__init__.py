"""Data parallelism of the Monte-Carlo simulator over torch.distributed:
one process per device, each running its own batch from its own
generator, the error counters summed by an all-reduce."""

from .mesh import (
    default_mesh,
    distribute_keys,
    init_distributed,
    sharded_counter_step,
)

__all__ = [
    "default_mesh",
    "distribute_keys",
    "init_distributed",
    "sharded_counter_step",
]
