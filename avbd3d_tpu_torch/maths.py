"""Batched 3D math: quaternion ops in row form and the component-form
guarded LDL solves.

Row form (``(..., 3)`` vectors, ``(..., 4)`` quats stored ``(x, y, z, w)``,
``(..., 3, 3)`` matrices) serves predict/finalize and the portable step's
assembly and ``solve66``; component form (tuples of tensors) serves the
fused step's plain version.  Same formulas, epsilons and operation order as
``avbd3d_tpu.maths`` (the reference).
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


def _solve3_cols(a, b):
    """The LDL^T solve of ``a`` (..., 3, 3) for every column of ``b``
    (..., 3, k): one factorization, each column substituted with the
    statements of ``solve3``, so each gives solve3's bits."""
    c0, c1, c2 = a[..., :, 0], a[..., :, 1], a[..., :, 2]
    d0 = c0[..., 0]
    bad0 = torch.abs(d0) < _PIVOT_EPS
    d0s = torch.where(bad0, 1.0, d0)
    l10 = c0[..., 1] / d0s
    l20 = c0[..., 2] / d0s
    c1p = c1 - c0 * l10[..., None]
    d1 = c1p[..., 1]
    bad1 = torch.abs(d1) < _PIVOT_EPS
    d1s = torch.where(bad1, 1.0, d1)
    l21 = c1p[..., 2] / d1s
    c2p = c2 - c0 * l20[..., None] - c1p * l21[..., None]
    d2 = c2p[..., 2]
    bad2 = torch.abs(d2) < _PIVOT_EPS
    d2s = torch.where(bad2, 1.0, d2)

    d0s, d1s, d2s, l10, l20, l21 = (x[..., None] for x in (d0s, d1s, d2s, l10, l20, l21))
    y0 = b[..., 0, :]
    y1 = b[..., 1, :] - l10 * y0
    y2 = b[..., 2, :] - l20 * y0 - l21 * y1
    z0 = y0 / d0s
    z1 = y1 / d1s
    z2 = y2 / d2s
    x2 = z2
    x1 = z1 - l21 * x2
    x0 = z0 - l10 * x1 - l20 * x2
    x = torch.stack([x0, x1, x2], dim=-2)
    return torch.where((bad0 | bad1 | bad2)[..., None, None], 0.0, x)


def solve3(a, b):
    """Row-form 3x3 LDL^T solve (maths.h:104), column-wise as the
    reference: returns the zero vector wherever a pivot falls below
    FLT_EPSILON.  ``a`` (..., 3, 3), ``b`` (..., 3) -> (..., 3)."""
    return _solve3_cols(a, b[..., None])[..., 0]


def mat_vec(a, v):
    """(..., 3, 3) @ (..., 3), the sums written out in k order (as the
    reference's einsum sums), so that a batched call gives the same bits."""
    return a[..., 0] * v[..., None, 0] + a[..., 1] * v[..., None, 1] + a[..., 2] * v[..., None, 2]


def mat_mul(a, b):
    """(..., 3, 3) @ (..., 3, 3), the sums written out in k order."""
    return (a[..., :, 0, None] * b[..., None, 0, :] + a[..., :, 1, None] * b[..., None, 1, :]
            + a[..., :, 2, None] * b[..., None, 2, :])


def solve33_matrix(a, b):
    """Solve A X = B for (..., 3, 3) B, column by column."""
    return _solve3_cols(a, b)


def solve66(a_ll, a_la, a_al, a_aa, b_l, b_a):
    """Row-form 6x6 block solve by the Schur complement on the angular
    block (structure of solver.cpp:68-83): AinvB = A_ll^-1 A_la, x0 =
    A_ll^-1 b_l, S = A_aa - A_al AinvB, y = S^-1 (b_a - A_al x0), x = x0 -
    AinvB y.  Returns (x_linear, y_angular), each (..., 3)."""
    cols = _solve3_cols(a_ll, torch.cat([a_la, b_l[..., None]], dim=-1))
    ainv_b, x0 = cols[..., :3], cols[..., 3]
    schur = a_aa - mat_mul(a_al, ainv_b)
    rhs_s = b_a - mat_vec(a_al, x0)
    y = solve3(schur, rhs_s)
    return x0 - mat_vec(ainv_b, y), y


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
