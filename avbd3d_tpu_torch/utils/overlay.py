"""Render-overlay extraction: contact points, normal rays, joint/spring lines.

The port's counterpart of ``avbd3d_tpu/utils/overlay.py``: numpy on the
host, each world leaf it uses read with one device-to-host copy, the
per-contact loop of the reference written as array operations (same values,
same order).  Reproduces the C++ reference's debug-draw semantics:

- contact midpoints colored by stick state — yellow sticking, purple
  sliding — plus a red normal ray of length 0.5 from the midpoint
  (manifold.cpp:273-307);
- joint anchor-to-anchor lines in green (joint.cpp:141-161);
- spring anchor-to-anchor lines in blue (spring.cpp:92-109).

Used by the OBJ exporter (utils/export.py) and the interactive viewer
(avbd3d_tpu_torch.viewer).
"""

from __future__ import annotations

import numpy as np

COLOR_STICK = (1.0, 1.0, 0.0)
COLOR_SLIDE = (0.8, 0.2, 0.8)
COLOR_NORMAL = (1.0, 0.2, 0.2)
COLOR_JOINT = (0.2, 0.8, 0.2)
COLOR_SPRING = (0.2, 0.2, 0.9)


def _host(t):
    """One device-to-host copy of a tensor leaf."""
    return t.detach().cpu().numpy()


def _poses(world):
    """(pos (N, 3), rotation matrices (N, 3, 3)) on the host."""
    b = world.bodies
    pos = _host(b.pos).reshape(3, -1).T
    x, y, z, w = _host(b.quat).reshape(4, -1)
    rot = np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )
    return pos, rot


def contact_overlay(world):
    """Active contact points (deduped to one replica per pair), in slot
    order (d, g, lane), then contact index.

    Returns (mid (K, 3), normal (K, 3), stick (K,) bool)."""
    pos, rot = _poses(world)
    dyn = _host(world.bodies.inv_mass).reshape(-1) > 0.0
    c = world.contacts
    other = _host(c.other)                            # (D, G, 128)
    d, g, _ = other.shape
    own = np.arange(g * 128).reshape(1, g, 128)
    valid = other >= 0
    once = valid & ((own < other) | ~dyn[np.where(valid, other, 0)])
    dd, gg, ll = np.nonzero(once)
    if dd.size == 0:
        return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,), bool)
    body, oth = gg * 128 + ll, other[dd, gg, ll]
    # Slot data is stored in the canonical pair frame: A = lower index.
    a, b = np.minimum(body, oth), np.maximum(body, oth)
    r_a = _host(c.r_a)[:, :, dd, gg, ll]              # (4, 3, K)
    r_b = _host(c.r_b)[:, :, dd, gg, ll]
    pa = pos[a][None] + np.einsum("kij,sjk->ski", rot[a], r_a)
    pb = pos[b][None] + np.einsum("kij,sjk->ski", rot[b], r_b)
    mid = ((pa + pb) * 0.5).transpose(1, 0, 2)        # (K, 4, 3)
    keep = np.arange(4)[None, :] < _host(c.count)[dd, gg, ll][:, None]
    normal = np.repeat(_host(c.normal)[:, dd, gg, ll].T[:, None, :], 4, axis=1)
    stick = _host(c.stick)[:, dd, gg, ll].T
    return mid[keep], normal[keep], stick[keep].astype(bool)


def _anchor_lines(world, rows):
    """Anchor-to-anchor segments (pA, pB) of the active rows of a dense
    joint or spring table, (K, 2, 3); body_a == -1 anchors to the world."""
    if rows.body_b.shape[0] == 0:
        return np.zeros((0, 2, 3))
    active = _host(rows.active).astype(bool)
    if not active.any():
        return np.zeros((0, 2, 3))
    pos, rot = _poses(world)
    body_a, body_b = _host(rows.body_a)[active], _host(rows.body_b)[active]
    r_a, r_b = _host(rows.r_a)[active], _host(rows.r_b)[active]
    ia = np.maximum(body_a, 0)
    pa = np.where((body_a >= 0)[:, None], pos[ia] + np.einsum("kij,kj->ki", rot[ia], r_a), r_a)
    pb = pos[body_b] + np.einsum("kij,kj->ki", rot[body_b], r_b)
    return np.stack([pa, pb], axis=1)


def joint_overlay(world):
    """Joint anchor lines (pA, pB) per active joint, (J, 2, 3)."""
    return _anchor_lines(world, world.joints)


def spring_overlay(world):
    """Spring anchor lines (S, 2, 3)."""
    return _anchor_lines(world, world.springs)
