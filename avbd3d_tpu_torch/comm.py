"""Collective seam for one world body-sharded across processes.

Port of ``avbd3d_tpu/comm.py`` (the reference).  The solver core reads
partner state only through an injected ``gather(table, idx)`` and takes its
world-wide reductions and table exchanges through ``comm``:

- ``LocalComm`` / ``LOCAL_COMM``: the identity, ``n_shards = 1``.  Every
  call returns its argument, so the single-device paths are unchanged.
- ``DistComm``: the same calls over a ``torch.distributed`` process group
  (the reference's ``MeshComm`` inside ``shard_map``).  ``psum`` / ``pmax``
  / ``pmin`` are ``all_reduce`` with SUM / MAX / MIN; ``all_gather_g``
  gathers every rank's (G_loc, ...) rows along the group axis in rank order
  (rank r owns groups [r * G_loc, (r + 1) * G_loc), so the result is the
  global table, as ``lax.all_gather(tiled=True)``); ``row0`` is the global
  index of this rank's first body.

Deterministic collectives give every rank the same value, so every gate
taken on the host from an all-reduced value takes the same branch on every
rank, and every rank issues the same collectives in the same order.
"""

from __future__ import annotations

import torch


class LocalComm:
    """Identity comm: one process holds the whole world."""

    n_shards = 1

    def psum(self, x):
        return x

    def pmax(self, x):
        return x

    def pmin(self, x):
        return x

    def all_gather_g(self, x):
        """(G, ...) table -> the global (G, ...) table (identity here)."""
        return x

    def row0(self, n_local: int):
        """Global body index of this shard's row 0."""
        return 0


LOCAL_COMM = LocalComm()


class DistComm:
    """Collectives over a ``torch.distributed`` process group (gloo on the
    CPU, NCCL on CUDA); ``group`` None is the default group."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.n_shards = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _reduce(self, x, op):
        y = torch.as_tensor(x).clone().contiguous()
        self._dist.all_reduce(y, op=op, group=self.group)
        return y

    def psum(self, x):
        return self._reduce(x, self._dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._reduce(x, self._dist.ReduceOp.MAX)

    def pmin(self, x):
        return self._reduce(x, self._dist.ReduceOp.MIN)

    def all_gather_g(self, x):
        is_bool = x.dtype == torch.bool
        src = (x.to(torch.uint8) if is_bool else x).contiguous()
        out = torch.empty((self.n_shards * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        gather_into = getattr(self._dist, "all_gather_single", None) \
            or self._dist.all_gather_into_tensor
        gather_into(out, src, group=self.group)
        return out.to(torch.bool) if is_bool else out

    def row0(self, n_local: int):
        return self.rank * n_local
