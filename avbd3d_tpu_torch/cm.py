"""Component-major math: vectors as tuples of same-shaped component tensors.

A "vec3" is a tuple (x, y, z) of tensors, a "quat" is (x, y, z, w).  Every
helper mirrors ``avbd3d_tpu.cm`` one to one, in the same operation order,
so the port's float results track the reference op for op and the CUDA
kernels (csrc/) can repeat the same order bit for bit.
"""

from __future__ import annotations

import torch

VEC_EPS = 1e-6


def where(c, a, b):
    """Elementwise select that accepts Python scalars on either side."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a) if isinstance(b, torch.Tensor) else torch.full(
            c.shape, a, dtype=torch.float32, device=c.device)
    return torch.where(c, a, b)


def vwhere(c, a, b):
    return tuple(where(c, x, y) for x, y in zip(a, b))


def add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def scale(a, s):
    return tuple(x * s for x in a)


def neg(a):
    return tuple(-x for x in a)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length_sq(a):
    return dot(a, a)


def normalize_or(a, fallback):
    lsq = length_sq(a)
    bad = lsq < VEC_EPS
    inv = torch.where(bad, 0.0, 1.0 / torch.sqrt(torch.where(bad, 1.0, lsq)))
    return tuple(where(bad, f, x * inv) for x, f in zip(a, fallback))


def q_rotate(q, v):
    """Rotate vec3 tuple by quat tuple: v + 2w(qv x v) + 2 qv x (qv x v)."""
    qv = (q[0], q[1], q[2])
    t = scale(cross(qv, v), 2.0)
    return add(add(v, scale(t, q[3])), cross(qv, t))


def q_rotate_inv(q, v):
    return q_rotate((-q[0], -q[1], -q[2], q[3]), v)


def q_mul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return (
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    )


def q_axes(q):
    """Box axes (columns of the rotation matrix, maths.h:88) from a quat."""
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    ax0 = (1 - 2 * (yy + zz), 2 * (xy + wz), 2 * (xz - wy))
    ax1 = (2 * (xy - wz), 1 - 2 * (xx + zz), 2 * (yz + wx))
    ax2 = (2 * (xz + wy), 2 * (yz - wx), 1 - 2 * (xx + yy))
    return ax0, ax1, ax2


def div(x, c: float):
    """x / c as a true float32 division.  (PyTorch's CUDA kernels turn a
    division by a Python scalar into a multiplication by its reciprocal,
    which rounds differently; a same-device tensor divisor does not.)"""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def dsum(x):
    """Sum over the leading (slot) axis, strictly in slot order — the order
    the CUDA kernels accumulate in, so both give the same bits."""
    acc = x[0]
    for d in range(1, x.shape[0]):
        acc = acc + x[d]
    return acc
