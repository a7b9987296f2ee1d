"""Broadphase: all-pairs world-AABB culling to per-body candidate slots.

Port of ``avbd3d_tpu/ops/broadphase.py`` (the reference; its module
docstring explains the AABB-gap ranking, the unique int32 selection keys and
the symmetric filter).  Torch ops throughout; ``control_lanes`` here is the
plain version of the control-lanes kernel (csrc/control_lanes.cu).

The reference's seams are keyword arguments with identity defaults:
``gather`` (partner reads), ``own_iota`` / ``n_total`` (global ids of this
shard's rows and the global body count) and ``comm`` (``comm.LOCAL_COMM``;
world-wide reductions and the column tables' all-gather on a body-sharded
world).  With the defaults every function computes exactly what it did
without them.

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
from ..comm import LOCAL_COMM

INT32_MIN = -(2**31) + 1
INT32_MAX = 2**31 - 1
# Above this many bodies candidate_lists takes its rows in blocks
# (the reference's block_rows).
BLOCK_ROWS = 2048


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


def build_bp_cache(b, exclusions, degree: int, margin: float,
                   comm=LOCAL_COMM) -> BroadphaseCache:
    """Fresh candidate lists anchored at the current poses."""
    half = tuple(b.size[k] * 0.5 for k in range(3))
    nb, key, thr, cand, slack = candidate_lists(
        b.pos, b.quat, half, b.radius, b.dynamic, exclusions, degree, margin, comm=comm)
    dropped = cand - comm.psum(torch.sum((nb >= 0).to(torch.int32)).to(torch.int32))
    return BroadphaseCache(anchor=b.pos, anchor_quat=b.quat, nb=nb, key=key,
                           thr=thr, cand=cand, slack=slack, dropped=dropped)


def refresh_scalar(bp: BroadphaseCache, dv, b, exclusions, degree: int,
                   margin: float, comm=LOCAL_COMM):
    """Scalar-gated refresh (broadphase.py:215-228 of the reference) on the
    step's host copy ``dv`` (diagnostics lanes 0-15, then bp.slack): the
    anchor deviations of lanes 14/15 against the cache's reuse bounds,
    compared in float32 as JAX compares them.  Returns (cache, refreshed)."""
    return refresh_or_reuse(bp, refresh_due(dv, margin), b, exclusions, degree, margin, comm)


def refresh_due(dv, margin: float) -> bool:
    """The reuse bounds broken (``refresh_scalar``'s predicate) on a host
    copy ``dv`` (diagnostics lanes 0-15, then bp.slack)."""
    f32 = np.float32
    return bool((f32(dv[14]) > f32(0.5 * margin)) | (f32(dv[15]) > f32(dv[16]) + f32(margin)))


def anchor_deviation(pos_cg, quat_cg, radius_g, dynamic_g, anchor, anchor_quat,
                     comm=LOCAL_COMM):
    """The cached lists' two reuse bounds (the reference's BroadphaseCache
    docstring): over moved bodies, the largest surface motion since the
    anchor poses net of the mean displacement (|disp - t| + chord), and the
    largest raw one (|disp| + chord).  Returns (dev_mm, dev_raw) () f32."""
    disp = [pos_cg[k] - anchor[k] for k in range(3)]
    disp2 = disp[0] * disp[0] + disp[1] * disp[1] + disp[2] * disp[2]
    moved = dynamic_g | (disp2 > 0.0)
    chord = _rot_chord(tuple(quat_cg), tuple(anchor_quat), radius_g)
    mf = moved.to(torch.float32)
    nm = torch.clamp(comm.psum(torch.sum(mf)), min=1.0)
    t = [comm.psum(torch.sum(d * mf)) / nm for d in disp]
    e = [disp[k] - t[k] for k in range(3)]
    dev = torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]) + chord
    dev_mm = comm.pmax(torch.max(torch.where(moved, dev, 0.0)))
    dev_raw = comm.pmax(torch.max(torch.where(moved, torch.sqrt(disp2) + chord, 0.0)))
    return dev_mm, dev_raw


def refresh_needed(bp: BroadphaseCache, b, margin: float):
    """The refresh predicate of ``refresh_or_reuse`` (reference
    broadphase.py:153-188) by device reductions on the current state, as a
    () bool tensor; the bounds compare in float32."""
    dev_mm, dev_raw = anchor_deviation(b.pos, b.quat, b.radius, b.dynamic,
                                       bp.anchor, bp.anchor_quat)
    half = torch.tensor(0.5 * margin, dtype=torch.float32, device=dev_mm.device)
    return (dev_mm > half) | (dev_raw > bp.slack + np.float32(margin))


def refresh_or_reuse(bp: BroadphaseCache, need: bool, b, exclusions, degree: int,
                     margin: float, comm=LOCAL_COMM):
    """Rebuild the candidate lists when ``need`` (the predicate, read on the
    host) says the cached superset no longer holds.  Returns (cache, need)."""
    return (build_bp_cache(b, exclusions, degree, margin, comm) if need else bp), need


def candidate_lists(pos_cg, quat_cg, half_cg, radius_g, dynamic_g,
                    exclusions, degree: int, margin: float = 0.0, comm=LOCAL_COMM):
    """Per-body candidate slots, deepest-gap first, as unique int32 keys.

    Returns nb (D, G, 128), key (D, G, 128), thr (G, 128), the directed
    candidate count () int32 and the mover-static slack () f32.  Above
    ``BLOCK_ROWS`` bodies the rows are taken in blocks (the largest
    multiple of 128 rows <= ``BLOCK_ROWS`` that divides N), so every
    intermediate is (block, N), never (N, N); the key constants are global,
    so the blocks give the whole-matrix result (reference
    broadphase.py:231-387).

    On a body-sharded world (``comm``) the inputs are this shard's rows: the
    column tables are all-gathered to the global body set, row ids are
    offset to global ids, the two scalars are all-reduced, and nb / key /
    thr stay this shard's rows, exactly the rows one device would give."""
    g = radius_g.shape[0]
    n_rows = g * 128
    row0 = comm.row0(n_rows)
    n = n_rows * comm.n_shards
    dev = radius_g.device
    wh_cg = world_halves(tuple(quat_cg[k] for k in range(4)), half_cg)
    px, py, pz = (comm.all_gather_g(pos_cg[k]).reshape(n) for k in range(3))
    wh = [comm.all_gather_g(wh_cg[k]).reshape(n) for k in range(3)]
    radius = comm.all_gather_g(radius_g).reshape(n)
    dynamic = comm.all_gather_g(dynamic_g).reshape(n)
    px_r, py_r, pz_r = (pos_cg[k].reshape(n_rows) for k in range(3))
    wh_r = [wh_cg[k].reshape(n_rows) for k in range(3)]
    radius_r = radius_g.reshape(n_rows)
    dynamic_r = dynamic_g.reshape(n_rows)
    excl = [exclusions[e].reshape(n_rows) for e in range(exclusions.shape[0])]

    q_max = (2**31 - 1) // n - 1
    max_wh = torch.maximum(torch.maximum(wh[0].max(), wh[1].max()), wh[2].max())
    gap_range = torch.clamp(2.0 * max_wh + margin, min=1e-6)
    # The scale is a float32 division q_max / range (not a reciprocal times
    # q_max), as in the reference.
    scale = torch.full_like(gap_range, float(q_max)) / gap_range
    jj = torch.arange(n, dtype=torch.int32, device=dev)[None, :]

    def row_block(r0: int, rows: int):
        sl = slice(r0, r0 + rows)
        rsum = radius_r[sl, None] + radius[None, :] + margin
        ii = torch.arange(row0 + r0, row0 + r0 + rows, dtype=torch.int32, device=dev)[:, None]
        gap = torch.maximum(
            torch.maximum(
                torch.abs(px_r[sl, None] - px[None, :]) - (wh_r[0][sl, None] + wh[0][None, :]),
                torch.abs(py_r[sl, None] - py[None, :]) - (wh_r[1][sl, None] + wh[1][None, :]),
            ),
            torch.abs(pz_r[sl, None] - pz[None, :]) - (wh_r[2][sl, None] + wh[2][None, :]),
        ) - margin
        # rsum > margin rejects padding bodies (sentinel negative radius).
        mask = (gap <= 0.0) & (rsum > margin) & (ii != jj) & dynamic_r[sl, None]
        for e in excl:
            mask &= jj != e[sl, None]
        cand = torch.sum(mask.to(torch.int32)).to(torch.int32)

        # (gap, partner) packed into one strictly increasing int32 key.
        qq = torch.clamp((gap + gap_range) * scale, 0.0, float(q_max)).to(torch.int32)
        key = qq * n + jj
        score = torch.where(mask, -key, INT32_MIN)
        vals, nb = torch.topk(score, degree, dim=1)      # deepest first
        valid = vals > INT32_MIN
        nb = torch.where(valid, nb.to(torch.int32), -1)
        key_slot = torch.where(valid, -vals, 0)
        last = vals[:, degree - 1]
        thr = torch.where(last > INT32_MIN, -last, INT32_MAX)

        slack_mask = (dynamic_r[sl, None] & ~dynamic[None, :] & (rsum > margin)
                      & (gap > 0.0) & (ii != jj))
        slack = torch.min(torch.where(slack_mask, gap, 1.0e9))
        return nb, key_slot, thr, cand, slack

    if n_rows <= BLOCK_ROWS:
        nb, key_slot, thr, cand, slack = row_block(0, n_rows)
    else:
        block = 128 * max(bg for bg in range(1, BLOCK_ROWS // 128 + 1) if g % bg == 0)
        parts = [row_block(r0, block) for r0 in range(0, n_rows, block)]
        nb, key_slot, thr = (torch.cat([p[i] for p in parts]) for i in range(3))
        cand = torch.stack([p[3] for p in parts]).sum().to(torch.int32)
        slack = torch.stack([p[4] for p in parts]).min()
    return (
        nb.T.contiguous().reshape(degree, g, 128),
        key_slot.T.contiguous().reshape(degree, g, 128),
        thr.reshape(g, 128).contiguous(),
        comm.psum(cand),
        comm.pmin(slack),
    )


def symmetric_filter(nb, key, thr, dynamic_g, gather=gather, own_iota=None, n_total=None):
    """Drop directed slots whose dynamic partner did not keep the pair.
    ``own_iota`` (G, 128): global ids of the rows (default 0..N-1);
    ``n_total``: the global body count the keys were packed with (default
    N).  Returns (filtered nb, kept directed-slot count () int32)."""
    d, g, _ = nb.shape
    n = g * 128 if n_total is None else n_total
    valid = nb >= 0
    idx = torch.where(valid, nb, 0)
    if own_iota is None:
        own = torch.arange(g * 128, dtype=torch.int32, device=nb.device).reshape(1, g, 128)
    else:
        own = own_iota[None]
    q = torch.div(key, n, rounding_mode="floor")
    key_rev = q * n + own
    partner_kept_me = key_rev <= gather(thr, idx)
    partner_static = gather(dynamic_g.to(torch.float32), idx) < 0.5
    keep = valid & (partner_kept_me | partner_static)
    return torch.where(keep, nb, -1), torch.sum(keep.to(torch.int32)).to(torch.int32)


def bp_probe(nb, pos_cg, quat_cg, half_cg, radius_g, linvel_cg, angvel_cg,
             dt: float, collision_margin: float, grav_len: float):
    """Probe the cached candidate slots at the current poses; plain version
    of the broadphase probe kernel (the reference's bp_probe,
    broadphase.py:716-782, with its statement order).  Returns

      min_sep  () f32   min over valid slots of the pair's best face-axis
                        SAT separation (1e9 when there is no slot):
                        ``min_sep > collision_margin`` proves narrowphase
                        finds no contact at these poses;
      n_slots  () int32 number of valid slots (== cache.cand iff the refresh
                        dropped none: dropped slots are unprobed);
      near     (G, 128) bool  the body could gain a contact row this step:
                        some slot's best separation minus one step of
                        worst-case mutual surface travel is within
                        ``collision_margin``."""
    valid = nb >= 0
    idx = torch.where(valid, nb, 0)
    pp = [gather(pos_cg[k], idx) for k in range(3)]
    pq = [gather(quat_cg[k], idx) for k in range(4)]
    ph = [gather(half_cg[k], idx) for k in range(3)]
    delta = [pp[k] - pos_cg[k][None] for k in range(3)]
    own_ax = [[c[None] for c in ax] for ax in cm.q_axes(tuple(quat_cg))]
    own_half = [h[None] for h in half_cg]
    par_ax = [list(ax) for ax in cm.q_axes(tuple(pq))]

    def proj(axes, half, n_vec):
        """Projection radius of a box (3 axes, 3 half extents) onto n_vec."""
        t = [half[k] * torch.abs(axes[k][0] * n_vec[0] + axes[k][1] * n_vec[1]
                                 + axes[k][2] * n_vec[2]) for k in range(3)]
        return t[0] + t[1] + t[2]

    best = torch.full(nb.shape, -1.0e9, dtype=torch.float32, device=nb.device)
    for n_vec in own_ax + par_ax:
        sep = (torch.abs(delta[0] * n_vec[0] + delta[1] * n_vec[1] + delta[2] * n_vec[2])
               - proj(own_ax, own_half, n_vec) - proj(par_ax, ph, n_vec))
        best = torch.maximum(best, sep)
    min_sep = torch.min(torch.where(valid, best, 1.0e9))
    n_slots = torch.sum(valid.to(torch.int32)).to(torch.int32)

    lv, av = linvel_cg, angvel_cg
    speed = torch.sqrt(lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2])
    wspin = torch.sqrt(av[0] * av[0] + av[1] * av[1] + av[2] * av[2]) \
        * torch.clamp(radius_g, min=0.0)
    travel = (speed + wspin) * dt
    # The reference writes this constant 4 * dt * dt * |g| (control_lanes
    # writes 4 * dt**2 * |g|, which can round differently in the last bit).
    reach = travel[None] + gather(travel, idx) + 4.0 * dt * dt * grav_len
    near = torch.any(valid & (best - reach <= collision_margin), dim=0)
    return min_sep, n_slots, near


def control_lanes(nb, pos_cg, quat_cg, half_cg, radius_g, linvel_cg,
                  angvel_cg, dynamic_g, anchor, anchor_quat, params,
                  gather=gather, comm=LOCAL_COMM):
    """The five step-control scalars (diagnostics lanes 11-15) on
    end-of-step state; plain version of the control-lanes kernel, and the
    form a body-sharded world uses (``gather`` / ``comm``).

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
    min_gap = comm.pmin(torch.min(torch.where(valid, gap, 1.0e9)))

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
    gate_speed_sq = comm.pmax(torch.max(v2))
    near_speed_sq = comm.pmax(torch.max(torch.where(near, v2, 0.0)))
    dev_mm, dev_raw = anchor_deviation(pos_cg, quat_cg, radius_g, dynamic_g,
                                       anchor, anchor_quat, comm)
    return torch.stack([gate_speed_sq, near_speed_sq, min_gap, dev_mm, dev_raw])


def neighbor_lists(pos_cg, quat_cg, half_cg, radius_g, dynamic_g, exclusions,
                   degree: int):
    """One-call broadphase: candidate lists (no margin) and the symmetric
    filter.  Returns (neighbors (D, G, 128) int32, -1 empty; overflow ()
    int32, the directed slots dropped)."""
    nb, key, thr, cand, _slack = candidate_lists(
        pos_cg, quat_cg, half_cg, radius_g, dynamic_g, exclusions, degree)
    nb, kept = symmetric_filter(nb, key, thr, dynamic_g)
    return nb, cand - kept
