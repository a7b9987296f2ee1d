"""Scaling past one world on one device (port of ``avbd3d_tpu/parallel``).

- ``batched``: many independent worlds as one batch (``torch.func.vmap``
  over the portable step), optionally split over devices.
- ``sharded``: ONE world body-sharded over ``torch.distributed`` ranks
  (the portable step with an all-gather ``gather`` and a ``DistComm``).
"""

from .batched import batched_step, make_mesh, replicate_world, shard_batch, world_at
from .sharded import make_world_mesh, shard_world, sharded_run, sharded_step, world_specs

__all__ = [
    "batched_step",
    "make_mesh",
    "replicate_world",
    "shard_batch",
    "world_at",
    "make_world_mesh",
    "shard_world",
    "sharded_run",
    "sharded_step",
    "world_specs",
]
