"""Checkpoint save/load: the whole simulation in one ``.npz`` file.

Port of ``avbd3d_tpu/utils/checkpoint.py`` (the reference), with its file
format: one array per World leaf under the key ``world.<container>.<field>``
(``world.bodies.pos``, ``world.bp.nb``, ``world.exclusions``,
``world.step_index``, ``world.diagnostics.vec``, ...) in the leaf's own
dtype, plus ``__meta__``, the UTF-8 JSON of ``{"params": ..., "cap": ...,
"version": 1}`` as uint8.  A checkpoint written by either package loads in
the other, and a run resumed from one continues bit-exactly (same device,
same path).

The port's World has the reference's containers and fields leaf for leaf.
The only difference in representation: ``World.step_index`` is a Python int
here and is stored as the reference's int32 scalar.  The joint and spring
slot widths (``Joints.dj``, ``Springs.ds``) are the shapes of the stored
slot leaves, and the colour count is ``cap.joint_colors`` in ``__meta__``,
so nothing else needs carrying.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..config import Capacity, SolverParams
from ..convert import world_from_arrays, world_to_arrays
from ..state import World


def _flatten(prefix: str, tree, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(f"{prefix}{k}.", v, out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


def save_checkpoint(path: str, world: World, params: SolverParams, cap: Capacity) -> None:
    """Write ``world`` (one device-to-host copy per leaf), ``params`` and
    ``cap`` to ``path`` (numpy appends ``.npz`` when the name lacks it)."""
    data: dict = {}
    _flatten("world.", world_to_arrays(world), data)
    meta = {
        "params": dataclasses.asdict(params),
        "cap": dataclasses.asdict(cap),
        "version": 1,
    }
    np.savez_compressed(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **data)


def load_checkpoint(path: str, device):
    """Returns (world on ``device``, params, cap)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        tree: dict = {}
        for key in z.files:
            if key == "__meta__":
                continue
            parts = key.split(".")
            if parts[0] != "world":
                raise ValueError(f"{path}: unexpected key {key!r}")
            node = tree
            for part in parts[1:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[key]
    params_kw = dict(meta["params"])
    params_kw["gravity"] = tuple(params_kw["gravity"])
    params = SolverParams(**params_kw)
    cap = Capacity(**meta["cap"])
    return world_from_arrays(tree, device), params, cap
