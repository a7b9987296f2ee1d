"""Many independent worlds stepped as one batch.

Port of ``avbd3d_tpu/parallel/batched.py`` (the reference).  A batch is one
World whose tensor leaves carry a leading batch axis B (``step_index`` stays
one Python int: the worlds step together).  ``batched_step`` is the
portable step (``backend="xla"``, as the reference forces) under
``torch.func.vmap``, so a batch is one set of launches with no Python loop
over worlds.

The reference gets per-world branches from ``vmap`` over ``lax.cond``, which
computes both sides and selects per world.  Here the step's gates come from
one (B, 18) host read: a branch that any world needs runs for the whole
batch and ``torch.where`` over the batch axis keeps each world's own side;
a sweep-plan entry on which every running world agrees stays a Python value
(nothing extra computed), one on which they differ becomes a per-world
tensor; the iteration loop runs to the batch's largest iteration count,
each world's carry frozen after its own.  The control lanes are taken after
the vmapped step, for the whole batch in one launch of K2 (its world axis).
Each world therefore gets what ``solver.step(world_i, params,
cap.replace(backend="xla"))`` gives it.

With ``cap.bp_window`` > 0 the refreshing worlds' lists come from the swept
broadphase (``broadphase.sweep_lists``, vmapped), whose per-world guards are
read in one more host copy; when any refreshing world's guard fires, the
matrix runs for the batch and ``torch.where`` keeps each world's own side,
as the reference's ``vmap`` over ``lax.cond`` does.  On the card the
matrix's lists of the whole batch come from one call of the refresh kernels
(``broadphase.candidate_lists``, their world axis); on the CPU its plain
version runs vmapped.

``make_mesh`` / ``shard_batch`` split a batch over devices: a list of
per-device chunks, which ``batched_step`` also accepts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import solver
from ..config import Capacity, SolverParams
from ..ops.broadphase import (build_bp_cache, cache_from_lists, candidate_lists_swept,
                              refresh_due, sweep_lists)
from ..state import Bodies, World

_PARTS = ("bodies", "contacts", "joints", "springs", "bp", "diagnostics")


def world_tensors(world: World) -> dict:
    """Every tensor leaf of ``world`` by dotted name."""
    out = {"exclusions": world.exclusions}
    for part in _PARTS:
        obj = getattr(world, part)
        out.update({f"{part}.{f.name}": getattr(obj, f.name) for f in dataclasses.fields(obj)})
    return out


def with_tensors(world: World, leaves: dict) -> World:
    """``world`` with its tensor leaves replaced from ``leaves``."""
    parts = {}
    for part in _PARTS:
        obj = getattr(world, part)
        parts[part] = obj.replace(**{f.name: leaves[f"{part}.{f.name}"]
                                     for f in dataclasses.fields(obj)})
    return world.replace(exclusions=leaves["exclusions"], **parts)


def replicate_world(world: World, batch: int) -> World:
    """A batch of ``batch`` copies of ``world`` (leading axis)."""
    return with_tensors(world, {k: v.unsqueeze(0).repeat((batch,) + (1,) * v.dim())
                                for k, v in world_tensors(world).items()})


def world_at(worlds: World, i: int) -> World:
    """World ``i`` of a batch."""
    return with_tensors(worlds, {k: v[i] for k, v in world_tensors(worlds).items()})


def batch_size(worlds: World) -> int:
    return worlds.bodies.mass.shape[0]


def make_mesh(n_devices: int | None = None, device_type: str = "cuda") -> list:
    """The devices a batch is split over: the first ``n_devices`` CUDA
    devices (all by default), or ``[cpu]`` with ``device_type="cpu"``."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu'")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n_devices or count)]


def shard_batch(worlds: World, devices: list) -> list:
    """The batch split into contiguous per-device chunks (as
    ``np.array_split`` divides it), each on its device."""
    chunks = np.array_split(np.arange(batch_size(worlds)), len(devices))
    leaves = world_tensors(worlds)
    return [with_tensors(worlds, {k: v[int(c[0]):int(c[-1]) + 1].to(dev)
                                  for k, v in leaves.items()})
            for c, dev in zip(chunks, devices) if len(c)]


def _entry(values, active):
    """A plan entry: the Python value every running world agrees on, or
    None (the per-world tensor is read inside the vmapped step)."""
    run = [v for v, a in zip(values, active) if a]
    return run[0] if all(v == run[0] for v in run) else None


def _tree_where(c, a, b):
    """Per-world select of two leaf dicts; ``c`` a Python bool or a
    per-world bool tensor."""
    if c is True or c is False:
        return a if c else b
    return {k: torch.where(c, a[k], b[k]) for k in a}


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _fresh_caches(worlds: World, params: SolverParams, cap: Capacity, refresh) -> dict:
    """Every world's fresh broadphase cache (leaves with the batch axis), on
    its poses after the fall-freeze: the matrix, or with ``cap.bp_window``
    > 0 the sweep, whose guards (one host read) send the batch through the
    matrix too when a refreshing world needs the fallback.  The swept
    broadphase's counters count the refreshing worlds."""
    one = world_at(worlds, 0)
    leaves = world_tensors(worlds)

    def frozen(lv):
        w = with_tensors(one, lv)
        return solver.freeze_fallen(w, params) if params.fall_freeze_y > -1.0e8 else w

    def matrix(lv):
        w = frozen(lv)
        return _fields(build_bp_cache(w.bodies, w.exclusions, cap.max_degree, params.bp_margin))

    def matrices(lv):
        # On the card the batch's lists come from one call of the refresh
        # kernels (their world axis), which vmap cannot enter.
        if lv["bodies.pos"].device.type == "cpu":
            return torch.func.vmap(matrix)(lv)
        b = Bodies(**torch.func.vmap(lambda x: _fields(frozen(x).bodies))(lv))
        return _fields(build_bp_cache(b, lv["exclusions"], cap.max_degree, params.bp_margin))

    if cap.bp_window <= 0:
        return matrices(leaves)

    def swept(lv):
        w = frozen(lv)
        b = w.bodies
        lists, info = sweep_lists(b.pos, b.quat, tuple(b.size[k] * 0.5 for k in range(3)),
                                  b.radius, b.dynamic, w.exclusions, cap.max_degree,
                                  params.bp_margin, cap.bp_window)
        return _fields(cache_from_lists(b, lists)), info["need_fallback"]

    fresh, need = torch.func.vmap(swept)(leaves)
    batched_step.host_reads += 1
    fallback = [bool(x) and r for x, r in zip(need.cpu(), refresh)]
    candidate_lists_swept.fallbacks += sum(fallback)
    candidate_lists_swept.swept += sum(refresh) - sum(fallback)
    if not any(fallback):
        return fresh
    c = torch.tensor(fallback, device=need.device)
    return torch.func.vmap(_tree_where)(c, matrices(leaves), fresh)


def _read_gates(worlds: World, params: SolverParams) -> dict:
    """The batch's one (B, 18) host read and every world's gates from it,
    exactly as ``solver.step`` takes them."""
    n_b = batch_size(worlds)
    ctrl = torch.cat([worlds.diagnostics.vec,
                      worlds.bp.slack.reshape(n_b, 1).to(torch.float32),
                      worlds.bp.dropped.reshape(n_b, 1).to(torch.float32)], dim=1)
    batched_step.host_reads += 1
    ctrl = ctrl.cpu().numpy()
    one = world_at(worlds, 0)
    refresh = [refresh_due(dv, params.bp_margin) for dv in ctrl]
    ballistic = [solver.ballistic_ok(params, one, dv, r) for dv, r in zip(ctrl, refresh)]
    plans = [[] if bal else solver.plan_for(params, dv, r)
             for dv, r, bal in zip(ctrl, refresh, ballistic)]
    return {"refresh": refresh, "ballistic": ballistic, "plans": plans}


def _launch(worlds: World, params: SolverParams, cap: Capacity, gates: dict) -> World:
    """One step of every world of the batch from its gates: the vmapped
    step without its control lanes, then K2 once for the whole batch."""
    refresh, ballistic, plans = gates["refresh"], gates["ballistic"], gates["plans"]
    n_b = batch_size(worlds)
    n_it = max(len(p) for p in plans)
    # (B, iterations, 5): alpha, do_dual, rebuild, ramp, active; zeros past
    # a world's end.
    table = np.zeros((n_b, n_it, 5), np.float32)
    for i, p in enumerate(plans):
        for it, e in enumerate(p):
            table[i, it] = e
    uniform = []
    for it in range(n_it):
        active = [bool(table[i, it, 4]) for i in range(n_b)]
        row = []
        for f in range(4):
            vals = [float(table[i, it, f]) if f == 0 else bool(table[i, it, f])
                    for i in range(n_b)]
            row.append(_entry(vals, active))
        row.append(True if all(active) else None)
        uniform.append(row)
    any_refresh, any_ballistic = any(refresh), any(ballistic)
    any_full = not all(ballistic)
    dev = worlds.bodies.pos.device
    per_world = {"refresh": torch.tensor(refresh, device=dev),
                 "ballistic": torch.tensor(ballistic, device=dev),
                 "table": torch.from_numpy(table).to(dev)}
    if any_refresh:
        per_world["fresh"] = _fresh_caches(worlds, params, cap, refresh)
    one = world_at(worlds, 0)

    def one_world(leaves, flags):
        w = with_tensors(one, leaves)
        if params.fall_freeze_y > -1.0e8:
            w = solver.freeze_fallen(w, params)
        if any_refresh:
            c = True if all(refresh) else flags["refresh"]
            w = w.replace(bp=w.bp.replace(**_tree_where(c, flags["fresh"], _fields(w.bp))))
        outs = {}
        if any_ballistic:
            outs["ballistic"] = world_tensors(solver._ballistic_body(w, params))
        if any_full:
            tab = flags["table"]
            plan = []
            for it, row in enumerate(uniform):
                e = [tab[it, f] if v is None else v for f, v in enumerate(row[:4])]
                e[1:4] = [x > 0.5 if isinstance(x, torch.Tensor) else x for x in e[1:4]]
                active = tab[it, 4] > 0.5 if row[4] is None else True
                plan.append((*e, active))
            outs["full"] = world_tensors(solver._step_body(w, params, cap, plan))
        if len(outs) == 1:
            return next(iter(outs.values()))
        return _tree_where(flags["ballistic"], outs["ballistic"], outs["full"])

    leaves = torch.func.vmap(one_world)(world_tensors(worlds), per_world)
    out = with_tensors(worlds, leaves).replace(step_index=worlds.step_index + 1)
    return solver.attach_control(out, params)


def batched_step(worlds, params: SolverParams, cap: Capacity):
    """One step of every world of the batch on the portable path, or of
    every chunk of a ``shard_batch`` list: every chunk's host read first,
    then every chunk's launches, so the devices run their chunks at once.
    ``batched_step.host_reads`` counts the host reads (one per batch, and
    one more for the sweep's guards on a refresh with ``cap.bp_window`` >
    0); ``batched_step.last_gates`` holds each chunk's gates of the last
    call (per world: ``refresh``, ``ballistic``, ``plans``)."""
    cap = cap.replace(backend="xla")
    chunks = list(worlds) if isinstance(worlds, (list, tuple)) else [worlds]
    gates = batched_step.last_gates = [_read_gates(w, params) for w in chunks]
    out = [_launch(w, params, cap, g) for w, g in zip(chunks, gates)]
    return out if isinstance(worlds, (list, tuple)) else out[0]


batched_step.host_reads = 0
batched_step.last_gates = []
