"""Distance spring rows: one soft row C = |pA - pB| - rest per spring.

Port of ``avbd3d_tpu/ops/springs.py`` (the reference; ``source/spring.cpp``)
on the replicated (DS, G, 128) slot layout of ``state.Springs`` (the scheme
of ops/joints.py: slot math in the spring's own A/B frame, sums over the DS
axis in slot order).  Springs are always soft: penalty clamped to the
stiffness each step, lambda out of the primal force and never updated, so
the steady force is penalty * C.
"""

from __future__ import annotations

import torch

from .. import cm
from ..state import Springs
from .broadphase import gather
from .replicated import gather_comps


def spring_decay(springs: Springs, params) -> Springs:
    """Penalty decay and soft clamp before prediction (solver.cpp:281-293)."""
    if springs.ds == 0:
        return springs
    pen = torch.clamp(springs.penalty * params.gamma, params.penalty_min, params.penalty_max)
    return springs.replace(penalty=torch.minimum(pen, springs.rstiff))


def spring_geometry(s: Springs, pose, gather=gather):
    """computeConstraint and the Jacobian direction (spring.cpp:33-90) per
    slot, at the poses ``pose`` ('pos' 3 comps, 'quat' 4 comps, (G, 128))."""
    valid = s.other >= 0
    idx = torch.where(valid, s.other, 0)
    is_a = s.side > 0
    is_world = s.world > 0

    own_pos = tuple(c[None] for c in pose["pos"])
    own_quat = tuple(c[None] for c in pose["quat"])
    oth_pos = gather_comps(pose["pos"], idx, gather)
    oth_quat = gather_comps(pose["quat"], idx, gather)

    anchor_a = tuple(s.anchor_a[k] for k in range(3))
    anchor_b = tuple(s.anchor_b[k] for k in range(3))

    pa_body = cm.vwhere(is_a, own_pos, oth_pos)
    qa_body = cm.vwhere(is_a, own_quat, oth_quat)
    zero = torch.zeros_like(qa_body[0])
    ident = (zero,) * 3 + (torch.ones_like(qa_body[0]),)
    qa = cm.vwhere(is_world, ident, qa_body)
    rw_a = cm.vwhere(is_world, (torch.zeros_like(pa_body[0]),) * 3, cm.q_rotate(qa, anchor_a))
    p_a = cm.vwhere(is_world, anchor_a, cm.add(pa_body, rw_a))

    pb_body = cm.vwhere(is_a, oth_pos, own_pos)
    qb = cm.vwhere(is_a, oth_quat, own_quat)
    rw_b = cm.q_rotate(qb, anchor_b)
    p_b = cm.add(pb_body, rw_b)

    delta = cm.sub(p_a, p_b)
    cur_len = torch.sqrt(cm.length_sq(delta))
    degenerate = cur_len < 1.0e-6
    inv = 1.0 / torch.where(degenerate, 1.0, cur_len)
    n = tuple(torch.where(degenerate, 0.0, d * inv) for d in delta)
    return {
        "C": torch.where(valid, cur_len - s.rrest, 0.0),
        "n": n,
        "rw_own": cm.vwhere(is_a, rw_a, rw_b),
        "valid": valid,
        "is_a": is_a,
    }


def spring_force(geom, pen):
    """Soft row: f = penalty * C (lambda excluded, bounds infinite)."""
    return torch.where(geom["valid"], pen * geom["C"], 0.0)


def spring_accumulate(geom, f, pen):
    """Own-side force and Hessian terms summed over the DS slots in slot
    order (J_lin = sign n, J_ang = sign (rw_own x n), spring.cpp:59-90)."""
    sign = torch.where(geom["is_a"], 1.0, -1.0)
    okf = geom["valid"].to(torch.float32)
    n = geom["n"]
    c = cm.cross(geom["rw_own"], n)
    fs = f * okf
    p = pen * okf

    F = [sign * n[k] * fs for k in range(3)]
    T = [sign * c[k] * fs for k in range(3)]
    m_ll = [p * n[0] * n[0], p * n[0] * n[1], p * n[0] * n[2],
            p * n[1] * n[1], p * n[1] * n[2], p * n[2] * n[2]]
    m_la = [p * n[i] * c[k] for i in range(3) for k in range(3)]
    m_aa = [p * c[0] * c[0], p * c[0] * c[1], p * c[0] * c[2],
            p * c[1] * c[1], p * c[1] * c[2], p * c[2] * c[2]]
    return {
        "F": [cm.dsum(x) for x in F],
        "T": [cm.dsum(x) for x in T],
        "m_ll": [cm.dsum(x) for x in m_ll],
        "m_la": [cm.dsum(x) for x in m_la],
        "m_aa": [cm.dsum(x) for x in m_aa],
    }
