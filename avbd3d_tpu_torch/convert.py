"""World <-> numpy arrays, by plain copy.

``world_from_arrays`` takes the reference World's leaves as nested dicts of
numpy arrays (field names as in ``avbd3d_tpu.state``; ``joints``/``springs``
may be None for their empty containers) and puts them on ``device``;
``world_to_arrays`` is its inverse.  This is how state crosses between the
two packages: the tests flatten a JAX world with ``jax.device_get`` and
hand the arrays over unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.broadphase import BroadphaseCache
from .state import (
    Bodies,
    Contacts,
    Diagnostics,
    Joints,
    Springs,
    World,
    empty_joints,
    empty_springs,
)


def resolve_device(device) -> torch.device:
    """An explicit torch device; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def _t(a, dev):
    arr = np.asarray(a)
    if arr.dtype == np.float64:
        raise TypeError("float64 leaf: the world is float32/int32 only")
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def _build(cls, tree, dev):
    return cls(**{f.name: _t(tree[f.name], dev) for f in dataclasses.fields(cls)})


def world_from_arrays(tree, device) -> World:
    dev = resolve_device(device)
    bodies = _build(Bodies, tree["bodies"], dev)
    n = bodies.n
    joints = (empty_joints(n, dev) if tree.get("joints") is None
              else _build(Joints, tree["joints"], dev))
    springs = (empty_springs(n, dev) if tree.get("springs") is None
               else _build(Springs, tree["springs"], dev))
    return World(
        bodies=bodies,
        contacts=_build(Contacts, tree["contacts"], dev),
        joints=joints,
        springs=springs,
        exclusions=_t(tree["exclusions"], dev),
        bp=_build(BroadphaseCache, tree["bp"], dev),
        step_index=int(np.asarray(tree["step_index"])),
        diagnostics=Diagnostics(vec=_t(tree["diagnostics"]["vec"], dev)),
    )


def _arrays(obj):
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)}


def world_to_arrays(world: World) -> dict:
    return {
        "bodies": _arrays(world.bodies),
        "contacts": _arrays(world.contacts),
        "joints": _arrays(world.joints),
        "springs": _arrays(world.springs),
        "exclusions": world.exclusions.detach().cpu().numpy(),
        "bp": _arrays(world.bp),
        "step_index": np.int32(world.step_index),
        "diagnostics": {"vec": world.diagnostics.vec.detach().cpu().numpy()},
    }
