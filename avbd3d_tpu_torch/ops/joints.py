"""Weld joint rows (3 linear + 3 angular) on the replicated slot layout.

Port of ``avbd3d_tpu/ops/joints.py`` (the reference; ``source/joint.cpp``).
Rows 0-2: world anchor coincidence C = pA - pB; rows 3-5: relative
orientation drift C = 2 vec(conj(qA) qB conj(q_rest)) (the reference does
not sign-correct w here, and neither does this).  A world-side A has the
identity orientation, its anchor is a world point, and a zero Jacobian.

Every function works on the (DJ, G, 128) body-major slot form
(``state.Joints``).  Each slot is written in the joint's own A/B frame
(``side``, ``world``), so both replicas of a joint compute bit-identical
rows and lam/penalty need no cross-replica exchange; keep that canonical
form, the CUDA step kernel (csrc/step_kernel.cu) repeats it statement for
statement.  Reductions over the DJ axis run in slot order (``cm.dsum``).

Soft rows (finite stiffness): penalty clamped to the stiffness, lambda left
out of the primal force, no dual update (solver.cpp:290-292, 379, 416-417).
"""

from __future__ import annotations

import torch

from .. import cm
from ..state import Joints
from .broadphase import gather
from .replicated import gather_comps

_IDENT = (0.0, 0.0, 0.0, 1.0)


def _row_stiff(j: Joints):
    """Per-row stiffness: rows 0-2 linear, rows 3-5 angular."""
    return [j.stiff_lin] * 3 + [j.stiff_ang] * 3


def joint_decay(joints: Joints, params) -> Joints:
    """Warmstart decay before prediction (solver.cpp:281-293).  With the
    end-of-step dual tracker on (``joint_ema_rate`` > 0) hard rows keep
    their lambda: the tracker is their forgetting mechanism."""
    if joints.dj == 0:
        return joints
    stiff = torch.stack(_row_stiff(joints))
    soft = (stiff > 0.0) & torch.isfinite(stiff)
    lam = joints.lam
    if not params.post_stabilize:
        dec = lam * (params.alpha * params.gamma)
        lam = torch.where(soft, dec, lam) if params.joint_ema_rate > 0.0 else dec
    pen = torch.clamp(joints.penalty * params.gamma, params.penalty_min,
                      params.joint_penalty_cap)
    pen = torch.where(soft, torch.minimum(pen, stiff), pen)
    valid = (joints.other >= 0)[None]
    return joints.replace(lam=torch.where(valid, lam, 0.0), penalty=pen)


def joint_geometry(j: Joints, pose, gather=gather):
    """Slot geometry at the given poses (joint.cpp:68-106).  ``pose``:
    dict of 'pos' (3 comps) and 'quat' (4 comps), each (G, 128).  Returns
    the 6 C rows, the A/B and own-side world lever arms, and the masks."""
    valid = j.other >= 0
    idx = torch.where(valid, j.other, 0)
    is_a = j.side > 0
    is_world = j.world > 0

    own_pos = tuple(c[None] for c in pose["pos"])
    own_quat = tuple(c[None] for c in pose["quat"])
    oth_pos = gather_comps(pose["pos"], idx, gather)
    oth_quat = gather_comps(pose["quat"], idx, gather)

    anchor_a = tuple(j.anchor_a[k] for k in range(3))
    anchor_b = tuple(j.anchor_b[k] for k in range(3))
    rest = tuple(j.rest[k] for k in range(4))

    pa_body = cm.vwhere(is_a, own_pos, oth_pos)
    qa_body = cm.vwhere(is_a, own_quat, oth_quat)
    ident = tuple(torch.full_like(qa_body[0], _IDENT[k]) for k in range(4))
    qa = cm.vwhere(is_world, ident, qa_body)
    zero = torch.zeros_like(pa_body[0])
    rw_a = cm.vwhere(is_world, (zero,) * 3, cm.q_rotate(qa, anchor_a))
    p_a = cm.vwhere(is_world, anchor_a, cm.add(pa_body, rw_a))

    pb_body = cm.vwhere(is_a, oth_pos, own_pos)
    qb = cm.vwhere(is_a, oth_quat, own_quat)
    rw_b = cm.q_rotate(qb, anchor_b)
    p_b = cm.add(pb_body, rw_b)

    lin_c = cm.sub(p_a, p_b)
    q_rel = cm.q_mul((-qa[0], -qa[1], -qa[2], qa[3]), qb)
    dq = cm.q_mul(q_rel, (-rest[0], -rest[1], -rest[2], rest[3]))
    ang_c = (2.0 * dq[0], 2.0 * dq[1], 2.0 * dq[2])

    c_rows = [torch.where(valid, c, 0.0) for c in lin_c + ang_c]
    return {
        "C": c_rows,
        "rw_a": rw_a,
        "rw_b": rw_b,
        "rw_own": cm.vwhere(is_a, rw_a, rw_b),
        "valid": valid,
        "is_a": is_a,
        "is_world": is_world,
    }


def joint_force(geom, j: Joints, lam, pen):
    """f = penalty C + lambdaWarm + motor per row (solver.cpp:379-381);
    soft rows drop lambda; weld bounds are infinite (joint.cpp:102-105)."""
    stiff = _row_stiff(j)
    out = []
    for r in range(6):
        hard = ~torch.isfinite(stiff[r])
        lam_warm = torch.where(hard, lam[r], 0.0)
        f = pen[r] * geom["C"][r] + lam_warm + j.rmotor[r]
        out.append(torch.where(geom["valid"], f, 0.0))
    return out


def joint_accumulate(geom, f_rows, pen):
    """Own-side force and 6x6 Hessian terms, summed over the DJ slots in
    slot order (solver.cpp:375-398).  Rows 0-2: J_lin = sign e_k, J_ang =
    sign (rw_own x e_k); rows 3-5: J_lin = 0, J_ang = sign e_k
    (joint.cpp:108-139).  Returns (G, 128) components F(3), T(3),
    m_ll(6), m_la(9), m_aa(6)."""
    sign = torch.where(geom["is_a"], 1.0, -1.0)
    okf = geom["valid"].to(torch.float32)
    rw = geom["rw_own"]

    f_lin = (f_rows[0] * okf, f_rows[1] * okf, f_rows[2] * okf)
    f_ang = (f_rows[3] * okf, f_rows[4] * okf, f_rows[5] * okf)

    F = [sign * f_lin[k] for k in range(3)]
    tv = cm.cross(rw, f_lin)
    T = [sign * (tv[k] + f_ang[k]) for k in range(3)]

    # c_k = rw x e_k: c_0 = (0, rw_z, -rw_y), c_1 = (-rw_z, 0, rw_x),
    # c_2 = (rw_y, -rw_x, 0).
    zero = torch.zeros_like(rw[0])
    c = [(zero, rw[2], -rw[1]), (-rw[2], zero, rw[0]), (rw[1], -rw[0], zero)]
    p = [pen[r] * okf for r in range(6)]

    m_ll = [p[0], zero, zero, p[1], zero, p[2]]
    m_la = [p[i] * c[i][k] for i in range(3) for k in range(3)]
    m_aa = [
        p[0] * c[0][0] * c[0][0] + p[1] * c[1][0] * c[1][0] + p[2] * c[2][0] * c[2][0] + p[3],
        p[0] * c[0][0] * c[0][1] + p[1] * c[1][0] * c[1][1] + p[2] * c[2][0] * c[2][1],
        p[0] * c[0][0] * c[0][2] + p[1] * c[1][0] * c[1][2] + p[2] * c[2][0] * c[2][2],
        p[0] * c[0][1] * c[0][1] + p[1] * c[1][1] * c[1][1] + p[2] * c[2][1] * c[2][1] + p[4],
        p[0] * c[0][1] * c[0][2] + p[1] * c[1][1] * c[1][2] + p[2] * c[2][1] * c[2][2],
        p[0] * c[0][2] * c[0][2] + p[1] * c[1][2] * c[1][2] + p[2] * c[2][2] * c[2][2] + p[5],
    ]
    return {
        "F": [cm.dsum(x) for x in F],
        "T": [cm.dsum(x) for x in T],
        "m_ll": [cm.dsum(x) for x in m_ll],
        "m_la": [cm.dsum(x) for x in m_la],
        "m_aa": [cm.dsum(x) for x in m_aa],
    }


def _cross_e(rw, k):
    """rw x e_k in closed form."""
    z = torch.zeros_like(rw[0])
    return [(z, rw[2], -rw[1]), (-rw[2], z, rw[0]), (rw[1], -rw[0], z)][k]


def joint_dual(geom, j: Joints, lam, pen, beta, params):
    """Per-iteration dual ascent (rate ``joint_dual_rate``, 0 by default)
    and penalty ramp of the hard rows at the post-primal poses
    (solver.cpp:411-429 with infinite weld bounds: every row is active).
    Returns the stacked (6, DJ, G, 128) lam and penalty."""
    stiff = _row_stiff(j)
    worldf = geom["is_world"].to(torch.float32)
    lam_new, pen_new = [], []
    for r in range(6):
        hard = ~torch.isfinite(stiff[r]) & geom["valid"]
        lam_r = torch.where(hard, lam[r] + params.joint_dual_rate * pen[r] * geom["C"][r],
                            lam[r])
        # rowPenaltyGain weights (solver.cpp:94-125): both bodies' J.
        if r < 3:
            ca = _cross_e(geom["rw_a"], r)
            cb = _cross_e(geom["rw_b"], r)
            lin_w = 2.0 - worldf
            ang_w = cm.length_sq(ca) * (1.0 - worldf) + cm.length_sq(cb)
        else:
            lin_w = torch.zeros_like(pen[r])
            ang_w = 2.0 - worldf
        total = lin_w + ang_w
        gain = torch.where(
            total < 1.0e-8, beta,
            (beta * lin_w + beta * params.angular_beta_scale * ang_w)
            / torch.clamp(total, min=1.0e-8))
        pen_r = torch.where(
            hard,
            torch.clamp(pen[r] + gain * torch.abs(geom["C"][r]), max=params.joint_penalty_cap),
            pen[r])
        lam_new.append(lam_r)
        pen_new.append(pen_r)
    return torch.stack(lam_new), torch.stack(pen_new)


def joint_dual_ema(geom, j: Joints, lam, pen, params):
    """Once-per-step slow dual tracker on the hard rows at the final poses:
    lambda += joint_ema_rate * penalty * C (the reference's rationale and
    measurements are in its ops/joints.py:249-288)."""
    eta = params.joint_ema_rate
    stiff = _row_stiff(j)
    out = []
    for r in range(6):
        hard = ~torch.isfinite(stiff[r]) & geom["valid"]
        out.append(torch.where(hard, lam[r] + eta * pen[r] * geom["C"][r], lam[r]))
    return torch.stack(out)
