"""ONE world body-sharded across ``torch.distributed`` ranks.

Port of ``avbd3d_tpu/parallel/sharded.py`` (the reference, ``shard_map``
over ``solver._step_impl``).  Every (..., G, 128) leaf of the World is split
along its group axis; rank r holds groups [r * G / n, (r + 1) * G / n) and
advances only its own body rows:

- partner reads go through ``gather = broadphase.gather(comm.all_gather_g(
  table), idx)``: the (G / n, 128) table all-gathered to the global one,
  then indexed;
- the broadphase's row blocks are this rank's rows against all-gathered
  columns, with the reference's global keys, so the candidate selection is
  the unsharded one (keys are unique);
- every step-level gate comes from all-reduced values (``DistComm``), so
  each rank takes the same branches from its own host read;
- contact state needs no exchange: both replicas of a pair compute the
  same rows from the same gathered operands.

No ballistic path, as in the reference.  ``make_world_mesh`` starts the
process group (gloo on the CPU, NCCL on CUDA) and returns its ``DistComm``.
"""

from __future__ import annotations

from ..comm import DistComm
from ..config import Capacity, SolverParams
from ..ops import broadphase
from ..solver import _step_impl, freeze_fallen
from ..state import World
from .batched import with_tensors, world_tensors


def _split(x, g: int) -> bool:
    return x.dim() >= 2 and x.shape[-1] == 128 and x.shape[-2] == g


def world_specs(world: World) -> dict:
    """For every tensor leaf (by dotted name): True where it is split along
    the group axis, False where every rank holds all of it (scalars, the
    dense joint and spring tables, the diagnostics)."""
    g = world.bodies.g
    return {k: _split(v, g) for k, v in world_tensors(world).items()}


def shard_world(world: World, rank: int, n_shards: int) -> World:
    """Rank ``rank``'s (..., G / n_shards, 128) slice of ``world``."""
    g = world.bodies.g
    if g % n_shards:
        raise ValueError(f"group count {g} not divisible by mesh axis 'world' size {n_shards}")
    gl = g // n_shards
    lo = rank * gl
    return with_tensors(world, {k: v[..., lo:lo + gl, :].clone() if _split(v, g) else v
                                for k, v in world_tensors(world).items()})


def sharded_run(world: World, params: SolverParams, cap: Capacity, comm: DistComm,
                n_steps: int = 1) -> World:
    """Advance this rank's shard ``world`` (from ``shard_world``) ``n_steps``
    steps: the per-row fall-freeze, then the portable step with the
    all-gather ``gather`` and ``comm``.  Every rank of ``comm`` must call
    it with the same arguments but its own shard."""
    cap = cap.replace(backend="xla")

    def gather(table, idx):
        return broadphase.gather(comm.all_gather_g(table), idx)

    for _ in range(n_steps):
        if params.fall_freeze_y > -1.0e8:
            world = freeze_fallen(world, params)
        world = _step_impl(world, params, cap, gather=gather, comm=comm)
    return world


def sharded_step(world: World, params: SolverParams, cap: Capacity, comm: DistComm) -> World:
    """One sharded step (see ``sharded_run``)."""
    return sharded_run(world, params, cap, comm, n_steps=1)


def make_world_mesh(rank: int, n_ranks: int, init_method: str, device: str = "cuda") -> DistComm:
    """Join a process group of ``n_ranks`` ranks at ``init_method`` (for
    example ``tcp://localhost:<port>``): gloo for ``device="cpu"``, NCCL
    (one card per rank, ``cuda:<rank>``) otherwise.  Returns its comm."""
    import torch
    import torch.distributed as dist

    if device != "cpu":
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if device == "cpu" else "nccl", init_method=init_method,
                            world_size=n_ranks, rank=rank)
    return DistComm()
