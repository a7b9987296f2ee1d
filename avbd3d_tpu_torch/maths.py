"""Batched 3D math: quaternion ops in row form and the component-form
guarded LDL solves.

Row form (``(..., 3)`` vectors, ``(..., 4)`` quats stored ``(x, y, z, w)``)
serves the ballistic step's predict/finalize; component form (tuples of
tensors) serves the contact step.  Same formulas, epsilons and operation
order as ``avbd3d_tpu.maths`` (the reference).
"""

from __future__ import annotations

import torch

# FLT_EPSILON pivot guard of the reference LDL solve (maths.h:104).
_PIVOT_EPS = 1.1920929e-07
VEC_EPS = 1e-6


def quat_mul(q1, q2):
    """Hamilton product (maths.h:67)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def quat_rotate(q, v):
    """Rotate vector by quaternion: v + 2 w (qv x v) + 2 qv x (qv x v)."""
    qv = q[..., :3]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + q[..., 3:4] * t + torch.linalg.cross(qv, t)


def quat_normalize(q):
    """Identity for degenerate quats (maths.h:65)."""
    msq = torch.sum(q * q, dim=-1)
    safe = torch.sqrt(torch.where(msq < VEC_EPS, 1.0, msq))
    unit = q / safe[..., None]
    ident = torch.zeros_like(q)
    ident[..., 3] = 1.0
    return torch.where((msq < VEC_EPS)[..., None], ident, unit)


def quat_vec_doubled(q):
    """2 * vector part, sign-corrected so w >= 0 (solver.cpp:365-369)."""
    sign = torch.where(q[..., 3] < 0.0, -1.0, 1.0)
    return 2.0 * q[..., :3] * sign[..., None]


def solve3_sym_cm(a, b):
    """Component-form 3x3 LDL^T solve of a symmetric system.

    ``a`` = (xx, xy, xz, yy, yz, zz), ``b`` = (b0, b1, b2); returns the zero
    vector wherever a pivot falls below FLT_EPSILON (maths.h:104)."""
    xx, xy, xz, yy, yz, zz = a
    bad0 = torch.abs(xx) < _PIVOT_EPS
    d0 = torch.where(bad0, 1.0, xx)
    l10 = xy / d0
    l20 = xz / d0
    d1_raw = yy - xy * l10
    bad1 = torch.abs(d1_raw) < _PIVOT_EPS
    d1 = torch.where(bad1, 1.0, d1_raw)
    l21 = (yz - xz * l10) / d1
    d2_raw = zz - xz * l20 - (yz - xz * l10) * l21
    bad2 = torch.abs(d2_raw) < _PIVOT_EPS
    d2 = torch.where(bad2, 1.0, d2_raw)

    y0 = b[0]
    y1 = b[1] - l10 * y0
    y2 = b[2] - l20 * y0 - l21 * y1
    z0 = y0 / d0
    z1 = y1 / d1
    z2 = y2 / d2
    x2 = z2
    x1 = z1 - l21 * x2
    x0 = z0 - l10 * x1 - l20 * x2
    bad = bad0 | bad1 | bad2
    return (
        torch.where(bad, 0.0, x0),
        torch.where(bad, 0.0, x1),
        torch.where(bad, 0.0, x2),
    )


def solve66_cm(a_ll, a_la, a_aa, b_l, b_a):
    """Component-form 6x6 Schur solve (structure of solver.cpp:68-83).

    a_ll: 6 symmetric comps; a_la: 9 row-major comps; a_aa: 6 symmetric
    comps; b_l/b_a: 3 comps each.  Returns (dl, da) component tuples."""
    cols = [
        solve3_sym_cm(a_ll, (a_la[0 + j], a_la[3 + j], a_la[6 + j]))
        for j in range(3)
    ]
    x0 = solve3_sym_cm(a_ll, b_l)
    aa = {
        (0, 0): a_aa[0], (0, 1): a_aa[1], (0, 2): a_aa[2],
        (1, 1): a_aa[3], (1, 2): a_aa[4], (2, 2): a_aa[5],
    }
    schur = []
    for (i, j) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        s = aa[(i, j)]
        for k in range(3):
            s = s - a_la[k * 3 + i] * cols[j][k]
        schur.append(s)
    rhs_s = []
    for i in range(3):
        s = b_a[i]
        for k in range(3):
            s = s - a_la[k * 3 + i] * x0[k]
        rhs_s.append(s)
    y = solve3_sym_cm(tuple(schur), tuple(rhs_s))
    dl = tuple(
        x0[k] - (cols[0][k] * y[0] + cols[1][k] * y[1] + cols[2][k] * y[2])
        for k in range(3)
    )
    return dl, y
