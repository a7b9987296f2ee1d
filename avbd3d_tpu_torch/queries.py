"""Spatial queries: OBB raycast picking.

Port of ``avbd3d_tpu/queries.py`` (the reference; ``Solver::pick``,
solver.cpp:145-228): a slab test in every dynamic body's local frame,
vectorized over all bodies, the closest hit selected by ``argmin`` (the
first minimum, as the reference's), plus the body-local hit point.  Runs on
the device the bodies live on and reads nothing back.
"""

from __future__ import annotations

import torch

from .maths import quat_conj, quat_rotate

_EPS = 1.0e-6
_BIG = 3.0e38


def pick(bodies, origin, direction):
    """Ray-cast against all dynamic OBBs.

    Returns (body_index () int64, t_hit () f32, local_point (3,) f32) as
    tensors on the bodies' device: ``body_index`` is -1 and ``t_hit`` -1.0 on
    a miss; ``local_point`` is in the hit body's local frame
    (solver.cpp:218-227).  Static bodies are never hit."""
    dev = bodies.pos.device
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    direction = torch.as_tensor(direction, dtype=torch.float32, device=dev)
    dir_sq = torch.sum(direction * direction)
    ray_dir = direction / torch.sqrt(torch.where(dir_sq < _EPS, 1.0, dir_sq))

    pos = bodies.pos_n3
    half = bodies.size.reshape(3, -1).T * 0.5
    inv_q = quat_conj(bodies.quat_n4)
    local_o = quat_rotate(inv_q, origin[None, :] - pos)
    local_d = quat_rotate(inv_q, ray_dir.expand(pos.shape))

    # Slab test per axis (solver.cpp:175-204).
    parallel = torch.abs(local_d) < _EPS
    inside = torch.abs(local_o) <= half
    safe_d = torch.where(parallel, 1.0, local_d)
    t0 = (-half - local_o) / safe_d
    t1 = (half - local_o) / safe_d
    t_lo = torch.where(parallel, -_BIG, torch.minimum(t0, t1))
    t_hi = torch.where(parallel, _BIG, torch.maximum(t0, t1))

    t_enter = torch.clamp(torch.max(t_lo, dim=-1).values, min=0.0)
    t_exit = torch.min(t_hi, dim=-1).values
    ok_parallel = torch.all(~parallel | inside, dim=-1)
    hit = (t_enter <= t_exit) & ok_parallel & bodies.dynamic.reshape(bodies.n)
    t_hit = torch.where(t_enter >= 0.0, t_enter, t_exit)
    hit = hit & (t_hit >= 0.0) & (dir_sq >= _EPS)

    score = torch.where(hit, t_hit, _BIG)
    best = torch.argmin(score)          # the first of equal minima
    found = score[best] < _BIG
    body_index = torch.where(found, best, -1)
    local_point = local_o[best] + local_d[best] * t_hit[best]
    return body_index, torch.where(found, t_hit[best], -1.0), local_point
