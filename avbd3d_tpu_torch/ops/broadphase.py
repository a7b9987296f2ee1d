"""Broadphase: all-pairs world-AABB culling to per-body candidate slots.

Port of ``avbd3d_tpu/ops/broadphase.py`` (the reference; its module
docstring explains the AABB-gap ranking, the unique int32 selection keys and
the symmetric filter).  Torch ops throughout; ``control_lanes`` here is the
plain version of the control-lanes kernel (csrc/control_lanes.cu).

Integer outputs (slots, keys, thresholds, counts) are identical to the
reference's for identical poses: the gap expression, its quantization
``(gap + range) * (q_max / range)`` and the int32 truncation run in the same
float32 order, and ``torch.topk`` can only order differently among the
``INT32_MIN`` scores of empty slots, which are masked to -1.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import cm

INT32_MIN = -(2**31) + 1
INT32_MAX = 2**31 - 1


def gather(table, idx):
    """table (G, 128), idx (D, G, 128) -> (D, G, 128) by direct indexing."""
    return table.reshape(-1)[idx.reshape(-1).long()].reshape(idx.shape)


def world_halves(quat_cg, half_cg):
    """World-frame AABB half-extents of oriented boxes (3-tuple)."""
    axes = cm.q_axes(tuple(quat_cg))
    return tuple(
        half_cg[0] * torch.abs(axes[0][k]) + half_cg[1] * torch.abs(axes[1][k])
        + half_cg[2] * torch.abs(axes[2][k])
        for k in range(3)
    )


def _rot_chord(quat_cg, anchor_quat_cg, radius_g):
    """Bound on any surface point's motion due to rotation since the anchor
    pose: 2*|vec(q (x) qa*)|*radius, which also bounds AABB growth."""
    q = tuple(quat_cg[k] for k in range(4))
    qa = tuple(anchor_quat_cg[k] for k in range(4))
    dq = cm.q_mul(q, (-qa[0], -qa[1], -qa[2], qa[3]))
    svec = torch.sqrt(dq[0] * dq[0] + dq[1] * dq[1] + dq[2] * dq[2])
    return 2.0 * torch.clamp(svec, max=1.0) * torch.clamp(radius_g, min=0.0)


@dataclasses.dataclass(frozen=True)
class BroadphaseCache:
    """Margin-enlarged candidate lists plus the poses they were computed at
    (reuse bounds in the reference's BroadphaseCache docstring)."""

    anchor: Any        # (3, G, 128) positions at last refresh
    anchor_quat: Any   # (4, G, 128)
    nb: Any            # (D, G, 128) int32 candidate partner (-1 empty)
    key: Any           # (D, G, 128) int32 selection keys
    thr: Any           # (G, 128) int32 largest key each body kept
    cand: Any          # () int32 directed candidate slots at refresh
    slack: Any         # () f32 min positive dynamic->static anchor gap
    dropped: Any       # () int32 directed slots dropped by top-k capacity

    def replace(self, **kw) -> "BroadphaseCache":
        return dataclasses.replace(self, **kw)


def build_bp_cache(b, exclusions, degree: int, margin: float) -> BroadphaseCache:
    """Fresh candidate lists anchored at the current poses."""
    half = tuple(b.size[k] * 0.5 for k in range(3))
    nb, key, thr, cand, slack = candidate_lists(
        b.pos, b.quat, half, b.radius, b.dynamic, exclusions, degree, margin)
    dropped = cand - torch.sum((nb >= 0).to(torch.int32)).to(torch.int32)
    return BroadphaseCache(anchor=b.pos, anchor_quat=b.quat, nb=nb, key=key,
                           thr=thr, cand=cand, slack=slack, dropped=dropped)


def refresh_scalar(bp: BroadphaseCache, dv, b, exclusions, degree: int,
                   margin: float):
    """Scalar-gated refresh (broadphase.py:215-228 of the reference) on the
    step's host copy ``dv`` (diagnostics lanes 0-15, then bp.slack): the
    anchor deviations of lanes 14/15 against the cache's reuse bounds,
    compared in float32 as JAX compares them.  Returns (cache, refreshed)."""
    f32 = np.float32
    need = bool((f32(dv[14]) > f32(0.5 * margin))
                | (f32(dv[15]) > f32(dv[16]) + f32(margin)))
    return (build_bp_cache(b, exclusions, degree, margin) if need else bp), need


def candidate_lists(pos_cg, quat_cg, half_cg, radius_g, dynamic_g,
                    exclusions, degree: int, margin: float = 0.0):
    """Per-body candidate slots, deepest-gap first, as unique int32 keys.

    Returns nb (D, G, 128), key (D, G, 128), thr (G, 128), the directed
    candidate count () int32 and the mover-static slack () f32 — the
    reference's whole-matrix path (N <= 2048, one row block)."""
    g = radius_g.shape[0]
    n = g * 128
    dev = radius_g.device
    wh_cg = world_halves(tuple(quat_cg[k] for k in range(4)), half_cg)
    px, py, pz = (pos_cg[k].reshape(n) for k in range(3))
    wh = [wh_cg[k].reshape(n) for k in range(3)]
    radius = radius_g.reshape(n)
    dynamic = dynamic_g.reshape(n)

    q_max = (2**31 - 1) // n - 1
    max_wh = torch.maximum(torch.maximum(wh[0].max(), wh[1].max()), wh[2].max())
    gap_range = torch.clamp(2.0 * max_wh + margin, min=1e-6)

    rsum = radius[:, None] + radius[None, :] + margin
    ii = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    jj = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    gap = torch.maximum(
        torch.maximum(
            torch.abs(px[:, None] - px[None, :]) - (wh[0][:, None] + wh[0][None, :]),
            torch.abs(py[:, None] - py[None, :]) - (wh[1][:, None] + wh[1][None, :]),
        ),
        torch.abs(pz[:, None] - pz[None, :]) - (wh[2][:, None] + wh[2][None, :]),
    ) - margin
    # rsum > margin rejects padding bodies (sentinel negative radius).
    mask = (gap <= 0.0) & (rsum > margin) & (ii != jj) & dynamic[:, None]
    for e in range(exclusions.shape[0]):
        mask &= jj != exclusions[e].reshape(n)[:, None]
    cand = torch.sum(mask.to(torch.int32)).to(torch.int32)

    # (gap, partner) packed into one strictly increasing int32 key.  The
    # scale is a float32 division q_max / range (not a reciprocal times
    # q_max), as in the reference.
    scale = torch.full_like(gap_range, float(q_max)) / gap_range
    qq = torch.clamp((gap + gap_range) * scale, 0.0, float(q_max)).to(torch.int32)
    key = qq * n + jj

    score = torch.where(mask, -key, INT32_MIN)
    vals, nb = torch.topk(score, degree, dim=1)          # deepest first
    valid = vals > INT32_MIN
    nb = torch.where(valid, nb.to(torch.int32), -1)
    key_slot = torch.where(valid, -vals, 0)
    last = vals[:, degree - 1]
    thr = torch.where(last > INT32_MIN, -last, INT32_MAX)

    slack_mask = (dynamic[:, None] & ~dynamic[None, :] & (rsum > margin)
                  & (gap > 0.0) & (ii != jj))
    slack = torch.min(torch.where(slack_mask, gap, 1.0e9))
    return (
        nb.T.contiguous().reshape(degree, g, 128),
        key_slot.T.contiguous().reshape(degree, g, 128),
        thr.reshape(g, 128).contiguous(),
        cand,
        slack,
    )


def symmetric_filter(nb, key, thr, dynamic_g):
    """Drop directed slots whose dynamic partner did not keep the pair.
    Returns (filtered nb, kept directed-slot count () int32)."""
    d, g, _ = nb.shape
    n = g * 128
    valid = nb >= 0
    idx = torch.where(valid, nb, 0)
    own = torch.arange(n, dtype=torch.int32, device=nb.device).reshape(1, g, 128)
    q = torch.div(key, n, rounding_mode="floor")
    key_rev = q * n + own
    partner_kept_me = key_rev <= gather(thr, idx)
    partner_static = gather(dynamic_g.to(torch.float32), idx) < 0.5
    keep = valid & (partner_kept_me | partner_static)
    return torch.where(keep, nb, -1), torch.sum(keep.to(torch.int32)).to(torch.int32)


def control_lanes(nb, pos_cg, quat_cg, half_cg, radius_g, linvel_cg,
                  angvel_cg, dynamic_g, anchor, anchor_quat, params):
    """The five step-control scalars (diagnostics lanes 11-15) on
    end-of-step state; plain version of the control-lanes kernel.

    Returns a (5,) f32 tensor: gate_speed_sq, near_speed_sq, min_cand_gap,
    bp_dev_mm, bp_dev_raw (semantics in state.Diagnostics)."""
    valid = nb >= 0
    idx = torch.where(valid, nb, 0)

    wh = world_halves(tuple(quat_cg), tuple(half_cg))
    pwh = [gather(wh[k], idx) for k in range(3)]
    ppos = [gather(pos_cg[k], idx) for k in range(3)]
    gap = torch.maximum(
        torch.maximum(
            torch.abs(ppos[0] - pos_cg[0][None]) - (wh[0][None] + pwh[0]),
            torch.abs(ppos[1] - pos_cg[1][None]) - (wh[1][None] + pwh[1]),
        ),
        torch.abs(ppos[2] - pos_cg[2][None]) - (wh[2][None] + pwh[2]),
    )
    min_gap = torch.min(torch.where(valid, gap, 1.0e9))

    g_len = float(sum(x * x for x in params.gravity) ** 0.5)
    lv, av = linvel_cg, angvel_cg
    speed_sq = lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2]
    speed = torch.sqrt(speed_sq)
    wspin = torch.sqrt(av[0] * av[0] + av[1] * av[1] + av[2] * av[2]) \
        * torch.clamp(radius_g, min=0.0)
    travel = (speed + wspin) * params.dt
    reach = travel[None] + gather(travel, idx) + 4.0 * params.dt**2 * g_len
    near = torch.any(valid & (gap - reach <= params.collision_margin), dim=0)

    alive = dynamic_g
    if params.fall_freeze_y > -1.0e8:
        alive = alive & (pos_cg[1] >= params.fall_freeze_y)
    v2 = torch.where(alive, speed_sq, 0.0)
    gate_speed_sq = torch.max(v2)
    near_speed_sq = torch.max(torch.where(near, v2, 0.0))

    disp = [pos_cg[k] - anchor[k] for k in range(3)]
    disp2 = disp[0] * disp[0] + disp[1] * disp[1] + disp[2] * disp[2]
    moved = dynamic_g | (disp2 > 0.0)
    chord = _rot_chord(tuple(quat_cg), tuple(anchor_quat), radius_g)
    mf = moved.to(torch.float32)
    nm = torch.clamp(torch.sum(mf), min=1.0)
    t = [torch.sum(d * mf) / nm for d in disp]
    e = [disp[k] - t[k] for k in range(3)]
    dev = torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]) + chord
    dev_mm = torch.max(torch.where(moved, dev, 0.0))
    dev_raw = torch.max(torch.where(moved, torch.sqrt(disp2) + chord, 0.0))
    return torch.stack([gate_speed_sq, near_speed_sq, min_gap, dev_mm, dev_raw])
