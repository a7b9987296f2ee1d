"""Broadphase: all-pairs world-AABB culling to per-body candidate slots.

Port of ``avbd3d_tpu/ops/broadphase.py`` (the reference; its module
docstring explains the AABB-gap ranking, the unique int32 selection keys and
the symmetric filter).  Torch ops throughout, but for the refresh on the
card: ``candidate_lists`` and ``refresh_needed`` launch the kernels of
csrc/bp_refresh.cu on CUDA tensors (``build_bp_cache`` takes the lists and
``dropped`` from one call) and run their plain versions,
``candidate_lists_plain`` and ``refresh_needed_plain``, on CPU tensors;
``launches`` on each counts the calls that launched.  ``control_lanes``
here is the plain version of the control-lanes kernel
(csrc/control_lanes.cu).

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

``candidate_lists_swept`` (``Capacity.bp_window > 0``) selects the same
slots by a sorted-axis sweep over chunked column windows, guarded so that
it falls back to ``candidate_lists`` wherever a window could miss a pair;
both share the gap, real-pair and key helpers below, so the sweep's keys
are the matrix keys bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
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
# The swept broadphase: rows per chunk, the fat overlay's width, and the sort
# sentinels of fat (BIG) and padding (2 * BIG) bodies.
CHUNK = 128
N_FAT = 8
BIG = 1.0e30


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


# world_halves over stacked tensors, for the broadphase's (3, N) tables.  The
# rotation entry of axis j, component k (cm.q_axes) is c0 + c1 * (P[a] + s *
# P[b]) over the nine products P of the quaternion's (x, y, z, w): xx yy zz
# xy xz yz wx wy wz.  These are q_axes' float32 operations in its order,
# rewritten exactly (a - b == a + (-1) b; 1 - 2 t == 1 + (-2) t; 2 t ==
# 0 + 2 t up to the sign of a zero, which the abs drops).
_QP = ((0, 1, 2, 0, 0, 1, 3, 3, 3), (0, 1, 2, 1, 2, 2, 0, 1, 2))
_QE = ((1, 2, 1, 1, -2), (3, 8, 1, 0, 2), (4, 7, -1, 0, 2),      # axis 0
       (3, 8, -1, 0, 2), (0, 2, 1, 1, -2), (5, 6, 1, 0, 2),      # axis 1
       (4, 7, 1, 0, 2), (5, 6, -1, 0, 2), (0, 1, 1, 1, -2))      # axis 2


@functools.cache
def _halves_plan(device):
    def t(vals, dtype=torch.int64):
        return torch.tensor(vals, dtype=dtype, device=device)

    cols = list(zip(*_QE))
    return (t(_QP[0]), t(_QP[1]), t(cols[0]), t(cols[1]),
            *(t(c, torch.float32)[:, None] for c in cols[2:]))


def world_halves_rows(quat_cg, half_cg):
    """``world_halves`` as one (3, N) tensor, bit for bit, in ~14 tensor
    operations in place of ~54 (quat_cg (4, ...), half_cg 3-tuple)."""
    i, j, a, b, sgn, c0, c1 = _halves_plan(quat_cg.device)
    q = quat_cg.reshape(4, -1)
    p = q[i] * q[j]
    e = torch.abs(c0 + c1 * (p[a] + p[b] * sgn)).reshape(3, 3, -1)
    m = torch.stack(half_cg).reshape(3, 1, -1) * e
    return m[0] + m[1] + m[2]


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
                   comm=LOCAL_COMM, window: int = 0) -> BroadphaseCache:
    """Fresh candidate lists anchored at the current poses.  ``window`` > 0
    selects the guarded sweep (``candidate_lists_swept``) on a single-shard
    world; 0 the row-blocked matrix."""
    if b.pos.device.type == "cuda" and not (window > 0 and comm.n_shards == 1):
        *lists, dropped = _lists_on_card(b.pos, b.quat, b.size, 0.5, b.radius, b.inv_mass,
                                         exclusions, degree, margin, comm)
        return BroadphaseCache(b.pos, b.quat, *lists, dropped=dropped)
    half = tuple(b.size[k] * 0.5 for k in range(3))
    if window > 0 and comm.n_shards == 1:
        lists = candidate_lists_swept(b.pos, b.quat, half, b.radius, b.dynamic, exclusions,
                                      degree, margin, window)
    else:
        lists = candidate_lists(b.pos, b.quat, half, b.radius, b.dynamic, exclusions,
                                degree, margin, comm=comm)
    return cache_from_lists(b, lists, comm)


def cache_from_lists(b, lists, comm=LOCAL_COMM) -> BroadphaseCache:
    """The cache of ``lists`` (nb, key, thr, cand, slack) anchored at ``b``."""
    nb, key, thr, cand, slack = lists
    dropped = cand - comm.psum(torch.sum((nb >= 0).to(torch.int32)).to(torch.int32))
    return BroadphaseCache(anchor=b.pos, anchor_quat=b.quat, nb=nb, key=key,
                           thr=thr, cand=cand, slack=slack, dropped=dropped)


def refresh_scalar(bp: BroadphaseCache, dv, b, exclusions, degree: int,
                   margin: float, comm=LOCAL_COMM, window: int = 0):
    """Scalar-gated refresh (broadphase.py:215-228 of the reference) on the
    step's host copy ``dv`` (diagnostics lanes 0-15, then bp.slack): the
    anchor deviations of lanes 14/15 against the cache's reuse bounds,
    compared in float32 as JAX compares them.  Returns (cache, refreshed)."""
    return refresh_or_reuse(bp, refresh_due(dv, margin), b, exclusions, degree, margin, comm,
                            window)


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
    broadphase.py:153-188) on the current state, as a () bool tensor with
    no host read: on CUDA tensors one launch of k_refresh_needed
    (csrc/bp_refresh.cu), else ``refresh_needed_plain``."""
    if b.pos.device.type == "cpu":
        return refresh_needed_plain(bp, b, margin)
    from .. import kernels

    need, _devs = kernels.launch_refresh_needed(b, bp.anchor, bp.anchor_quat, bp.slack, margin)
    refresh_needed.launches += 1
    return need


refresh_needed.launches = 0


def refresh_needed_plain(bp: BroadphaseCache, b, margin: float):
    """Plain version of the refresh predicate kernel: device reductions on
    the current state, a () bool tensor; the bounds compare in float32."""
    dev_mm, dev_raw = anchor_deviation(b.pos, b.quat, b.radius, b.dynamic,
                                       bp.anchor, bp.anchor_quat)
    return reuse_broken(dev_mm, dev_raw, bp.slack, margin)


def reuse_broken(dev_mm, dev_raw, slack, margin: float):
    """The cached lists' reuse bounds broken, from the two anchor
    deviations (() f32 tensors), compared in float32."""
    half = torch.tensor(0.5 * margin, dtype=torch.float32, device=dev_mm.device)
    return (dev_mm > half) | (dev_raw > slack + np.float32(margin))


def refresh_or_reuse(bp: BroadphaseCache, need: bool, b, exclusions, degree: int,
                     margin: float, comm=LOCAL_COMM, window: int = 0):
    """Rebuild the candidate lists when ``need`` (the predicate, read on the
    host) says the cached superset no longer holds.  Returns (cache, need)."""
    return (build_bp_cache(b, exclusions, degree, margin, comm, window) if need else bp), need


def _key_packing(wh, margin: float, n: int):
    """The selection keys' global constants (n, q_max, gap_range, scale)
    over the world-AABB halves ``wh`` (3, n) of all ``n`` bodies.  The scale is a
    float32 division q_max / range (not a reciprocal times q_max), as in
    the reference."""
    q_max = (2**31 - 1) // n - 1
    max_wh = wh.max()
    gap_range = torch.clamp(2.0 * max_wh + margin, min=1e-6)
    scale = torch.full_like(gap_range, float(q_max)) / gap_range
    return n, q_max, gap_range, scale


def _cheb_gap(rc, rw, pc, pw, margin: float):
    """Chebyshev world-AABB gap minus ``margin`` of rows (centres ``rc``,
    halves ``rw``, axis first: (3, ...)) against partners (``pc``, ``pw``),
    broadcast: max over the axes of |rc - pc| - (rw + pw), each in float32
    as the reference orders it (the max of three values is exact in any
    order)."""
    return torch.amax(torch.abs(rc - pc) - (rw + pw), dim=0) - margin


def _real_pair(radius_a, radius_b, margin: float):
    """rsum > margin: rejects padding bodies (sentinel negative radius)."""
    return radius_a + radius_b + margin > margin


def _keys(gap, pack, partner):
    """(gap, partner) packed into one strictly increasing int32 key."""
    n, q_max, gap_range, scale = pack
    qq = torch.clamp((gap + gap_range) * scale, 0.0, float(q_max)).to(torch.int32)
    return qq * n + partner


def candidate_lists(pos_cg, quat_cg, half_cg, radius_g, dynamic_g,
                    exclusions, degree: int, margin: float = 0.0, comm=LOCAL_COMM):
    """Per-body candidate slots, deepest-gap first, as unique int32 keys
    (``candidate_lists_plain`` says what): on CUDA tensors the kernels of
    csrc/bp_refresh.cu, else ``candidate_lists_plain``.  Returns nb, key,
    thr, cand, slack."""
    if radius_g.device.type == "cpu":
        return candidate_lists_plain(pos_cg, quat_cg, half_cg, radius_g, dynamic_g, exclusions,
                                     degree, margin, comm)
    return _lists_on_card(pos_cg, quat_cg, torch.stack(tuple(half_cg)), 1.0, radius_g,
                          dynamic_g.to(torch.float32), exclusions, degree, margin, comm)[:5]


candidate_lists.launches = 0


def _lists_on_card(pos, quat, ext, ext_scale: float, radius, dyn_key, exclusions, degree: int,
                   margin: float, comm=LOCAL_COMM):
    """The candidate lists and the dropped count on the card: k_bp_tables
    (the bodies' table and largest half extent; halves ``ext * ext_scale``,
    dynamic ``dyn_key > 0``), then k_bp_lists over this shard's rows against
    every body's table (all-gathered on a body-sharded world, whose scalars
    are then reduced across shards).  Leaves with a leading batch axis give
    every world's lists from the same two launches.  Returns nb, key, thr,
    cand, slack, dropped."""
    from .. import kernels

    table, max_wh = kernels.launch_bp_tables(pos, quat, ext, ext_scale, radius, dyn_key)
    cols = table
    if comm.n_shards > 1:
        cols, max_wh = comm.all_gather_g(table), comm.pmax(max_wh)
    nb, key, thr, cand, slack, kept, dropped = kernels.launch_bp_lists(
        table, cols, max_wh, exclusions, degree, margin, comm.row0(table.shape[-2]))
    candidate_lists.launches += 1
    if comm.n_shards > 1:
        cand, slack = comm.psum(cand), comm.pmin(slack)
        dropped = cand - comm.psum(kept)
    return nb, key, thr, cand, slack, dropped


def candidate_lists_plain(pos_cg, quat_cg, half_cg, radius_g, dynamic_g,
                          exclusions, degree: int, margin: float = 0.0, comm=LOCAL_COMM):
    """Per-body candidate slots, deepest-gap first, as unique int32 keys;
    plain version of the candidate-list kernels (csrc/bp_refresh.cu).

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
    wh_r = world_halves_rows(quat_cg, half_cg).reshape(3, g, 128)
    c = torch.stack([comm.all_gather_g(pos_cg[k]) for k in range(3)]).reshape(3, n)
    wh = torch.stack([comm.all_gather_g(wh_r[k]) for k in range(3)]).reshape(3, n)
    radius = comm.all_gather_g(radius_g).reshape(n)
    dynamic = comm.all_gather_g(dynamic_g).reshape(n)
    c_r = pos_cg.reshape(3, n_rows)
    wh_r = wh_r.reshape(3, n_rows)
    radius_r = radius_g.reshape(n_rows)
    dynamic_r = dynamic_g.reshape(n_rows)
    excl = [exclusions[e].reshape(n_rows) for e in range(exclusions.shape[0])]

    pack = _key_packing(wh, margin, n)
    jj = torch.arange(n, dtype=torch.int32, device=dev)[None, :]

    def row_block(r0: int, rows: int):
        sl = slice(r0, r0 + rows)
        real_pair = _real_pair(radius_r[sl, None], radius[None, :], margin)
        ii = torch.arange(row0 + r0, row0 + r0 + rows, dtype=torch.int32, device=dev)[:, None]
        gap = _cheb_gap(c_r[:, sl, None], wh_r[:, sl, None], c[:, None], wh[:, None], margin)
        mask = (gap <= 0.0) & real_pair & (ii != jj) & dynamic_r[sl, None]
        for e in excl:
            mask &= jj != e[sl, None]
        cand = torch.sum(mask.to(torch.int32)).to(torch.int32)

        key = _keys(gap, pack, jj)
        score = torch.where(mask, -key, INT32_MIN)
        vals, nb = torch.topk(score, degree, dim=1)      # deepest first
        valid = vals > INT32_MIN
        nb = torch.where(valid, nb.to(torch.int32), -1)
        key_slot = torch.where(valid, -vals, 0)
        last = vals[:, degree - 1]
        thr = torch.where(last > INT32_MIN, -last, INT32_MAX)

        slack_mask = (dynamic_r[sl, None] & ~dynamic[None, :] & real_pair
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


@functools.cache
def _window_plan(n: int, cw: int, n_fat: int, device):
    """The sweep's static column windows, per shape and device: chunk t's
    window is the sorted columns [start_t, start_t + cw) with start_t =
    min(max(128 t + 64 - cw // 2, 0), n - cw), then the overlay's columns
    n .. n + n_fat - 1 of the column tables.  Returns the (T, cw + n_fat)
    column positions, the (T,) positions just left and just right of each
    window (clamped) and whether the window has each edge."""
    starts = [min(max(CHUNK * t + CHUNK // 2 - cw // 2, 0), n - cw) for t in range(n // CHUNK)]

    def t(vals, dtype=torch.int64):
        return torch.tensor(vals, dtype=dtype, device=device)

    return (t([list(range(s, s + cw)) + list(range(n, n + n_fat)) for s in starts]),
            t([max(s - 1, 0) for s in starts]),
            t([min(s + cw, n - 1) for s in starts]),
            t([s > 0 for s in starts], torch.bool),
            t([s + cw < n for s in starts], torch.bool))


def sweep_lists(pos_cg, quat_cg, half_cg, radius_g, dynamic_g, exclusions, degree: int,
                margin: float, window: int, n_fat: int = N_FAT):
    """The swept selection (the reference's candidate_lists_swept,
    broadphase.py:390-678) without its fallback and with no host read, so
    that it also runs under ``torch.func.vmap``.

    Returns ((nb, key, thr, cand, slack), info); ``info`` holds
    ``need_fallback`` () bool (the guard: where it is True the lists are not
    the matrix path's and the caller must take ``candidate_lists``),
    ``axis`` () the sweep axis and ``fat`` (G, 128) bool the overlay's
    bodies.  Where the guard passes, nb / key / thr / cand are identical to
    ``candidate_lists``' and the slack is at most its slack and positive.

    1. Bodies are sorted (stably, so ties keep body order) by their
       world-AABB minimum along the axis of largest centre spread; fat
       bodies and then padding go to the tail.  Each chunk of 128 sorted
       rows is tested against the ``window`` sorted columns of
       ``_window_plan`` and the overlay, all chunks at once as (T, 128,
       window + n_fat) tensors.
    2. Fat bodies (sweep extent above 4x every slim body's, at most
       ``n_fat``: the ground slab) are the overlay columns of every chunk.
    3. The guard: for each chunk with dynamic slim rows, the nearest column
       outside the window on each side is proven apart from every row by
       an axis gap bound: left, chunk_min - (xmin_s[start - 1] + 2 e_slim) -
       margin; right, xmin_s[start + cw] - chunk_xmax - margin, with the
       exact xmax = c + wh carried through the sort, each less a pad of 16
       float32 epsilons of the slim bodies' axis extent, which covers the
       rounding of the mask's own gap.  A bound <= 0, or a dynamic fat
       body, needs the fallback.  So a pair within an ulp of touching is
       inside a window whose guard passed, or the guard fires.
    4. Slack: the in-window and overlay static columns exactly, plus, when
       a slim static body exists, the two bounds of chunks that have
       dynamic rows (the guard made them positive; chunks without dynamic
       rows add nothing, as their bounds may mix the sort sentinels).
    5. One ``topk`` (smallest first) over the (N, window + n_fat) keys;
       partners decode from the unique keys (``key % N``); rows un-sort
       through the inverse permutation.

    The window must exceed the 128 rows of a chunk by the sorted
    neighbours its bodies can touch on each side (config.Capacity's
    ``bp_window``)."""
    g = radius_g.shape[0]
    n = g * 128
    cw = int(window)
    if not (0 < cw <= n and cw + n_fat >= degree):
        raise ValueError(f"bp_window {cw}: needs {max(degree - n_fat, 1)} <= window <= {n} "
                         f"(N = {n}, {n_fat} overlay columns, degree {degree})")
    n_chunks = n // CHUNK
    dev = radius_g.device
    c = pos_cg.reshape(3, n)
    wh = world_halves_rows(quat_cg, half_cg)
    radius = radius_g.reshape(n)
    dyn = dynamic_g.reshape(n)
    real = radius > 0.0
    pack = _key_packing(wh, margin, n)

    # Sweep axis: the largest real-body centre spread.
    spread = (torch.where(real, c, -BIG).amax(dim=1) - torch.where(real, c, BIG).amin(dim=1))
    ax = torch.argmax(spread)
    pick = ax.reshape(1, 1).expand(1, n)
    c_ax, wh_ax = c.gather(0, pick)[0], wh.gather(0, pick)[0]

    # Fat overlay.  Every body above fat_min is among the top n_fat (fat_min
    # >= the (n_fat + 1)-th largest extent), so the set does not depend on
    # how topk orders ties; top-k members below it are masked out.
    ext = torch.where(real, wh_ax, -BIG)
    fe, fat_idx = torch.topk(ext, n_fat + 1)
    fat_min = 4.0 * torch.clamp(fe[n_fat], min=1e-6)
    fat_idx = fat_idx[:n_fat]
    is_fat = ext > fat_min
    slim = real & ~is_fat
    e_slim = torch.where(slim, wh_ax, 0.0).max()
    pad = 16.0 * float(np.finfo(np.float32).eps) * (
        torch.where(slim, torch.abs(c_ax) + wh_ax, 0.0).max() + margin)

    # Stable sort: slim real bodies by AABB min, then fat, then padding.
    # Column tables: the sorted bodies, then the overlay (n + n_fat).
    xmin_s, orig_s = torch.sort(torch.where(real, torch.where(is_fat, BIG, c_ax - wh_ax),
                                            2.0 * BIG), stable=True)
    idx = torch.cat([orig_s, fat_idx])
    fcol = torch.cat([c, wh, radius[None], (c_ax + wh_ax)[None]])[:, idx]   # (8, n + n_fat)
    ok_s = torch.cat([slim[orig_s], is_fat[fat_idx]])         # the sweep's / the overlay's
    icol = torch.stack([idx.to(torch.int32), dyn[idx].to(torch.int32), ok_s.to(torch.int32)])

    cols, left, right, has_left, has_right = _window_plan(n, cw, n_fat, dev)
    fc, ic = fcol[:, cols], icol[:, cols]                      # (8 | 3, T, C)
    fr = fcol[:, :n].reshape(8, n_chunks, CHUNK, 1)
    row_orig, row_dyn = icol[0, :n].reshape(n_chunks, CHUNK, 1), dyn[orig_s]
    col_orig, col_dyn, col_ok = ic[0, :, None], ic[1, :, None] > 0, ic[2, :, None] > 0

    # The guard and the out-of-window slack bounds, per chunk.
    need = (ok_s[:n] & row_dyn).reshape(n_chunks, CHUNK)
    has_rows = need.any(dim=1)
    chunk_min = torch.where(need, xmin_s.reshape(n_chunks, CHUNK), BIG).amin(dim=1)
    chunk_xmax = torch.where(need, fr[7, :, :, 0], -BIG).amax(dim=1)
    before = torch.where(has_left, chunk_min - (xmin_s[left] + 2.0 * e_slim) - margin - pad,
                         1.0e9)
    beyond = torch.where(has_right, xmin_s[right] - chunk_xmax - margin - pad, 1.0e9)
    guard_bad = torch.any(has_rows & ~((before > 0.0) & (beyond > 0.0)))
    slack_bound = torch.where(has_rows, torch.minimum(before, beyond), 1.0e9).min()

    # Every chunk's rows against its window and the overlay at once.
    row_dyn = row_dyn.reshape(n_chunks, CHUNK, 1)
    gap = _cheb_gap(fr[0:3], fr[3:6], fc[0:3, :, None], fc[3:6, :, None], margin)
    real_pair = _real_pair(fr[6], fc[6, :, None], margin)
    pair = real_pair & row_dyn & (row_orig != col_orig) & col_ok
    mask = (gap <= 0.0) & pair
    for e in exclusions.reshape(exclusions.shape[0], n)[:, orig_s]:
        mask &= col_orig != e.reshape(n_chunks, CHUNK, 1)
    cand = torch.sum(mask.to(torch.int32)).to(torch.int32)
    score = torch.where(mask, _keys(gap, pack, col_orig), INT32_MAX)
    slack = torch.where(pair & ~col_dyn & (gap > 0.0), gap, 1.0e9).min()
    slack = torch.where(torch.any(slim & ~dyn), torch.minimum(slack, slack_bound), slack)
    need_fallback = guard_bad | torch.any(is_fat & dyn)

    # One ranked selection over all chunks (the smallest keys, ascending;
    # every key < INT32_MAX, so the empty slots' INT32_MAX is the
    # threshold's "none"); partners decode from the keys; the rows go back
    # to body order through the inverse permutation.
    vals, _ = torch.topk(score.reshape(n, cw + n_fat), degree, dim=1, largest=False)
    valid = vals < INT32_MAX
    out_s = torch.cat([torch.where(valid, vals % n, -1), torch.where(valid, vals, 0),
                       vals[:, degree - 1:]], dim=1)
    out = out_s[torch.empty_like(orig_s).scatter(0, orig_s, torch.arange(n, device=dev))]
    lists = (out[:, :degree].T.contiguous().reshape(degree, g, 128),
             out[:, degree:2 * degree].T.contiguous().reshape(degree, g, 128),
             out[:, 2 * degree].reshape(g, 128).contiguous(), cand, slack)
    return lists, {"need_fallback": need_fallback, "axis": ax, "fat": is_fat.reshape(g, 128)}


def candidate_lists_swept(pos_cg, quat_cg, half_cg, radius_g, dynamic_g, exclusions,
                          degree: int, margin: float, window: int, n_fat: int = N_FAT,
                          comm=LOCAL_COMM):
    """``candidate_lists`` by the guarded sweep (``sweep_lists``), with the
    reference's fallback: where the guard fires, the matrix path's lists.
    The reference decides that inside ``lax.cond``; here it is one host
    read of the guard per call (so per refresh, never on a reused step).

    Counters (running totals; the caller may reset them):
    ``candidate_lists_swept.swept`` / ``.fallbacks`` count the calls that
    kept the sweep / fell back, ``.host_reads`` the guard reads, and
    ``.last`` holds the last call's ``fallback`` (bool), ``axis`` and
    ``fat`` (tensors, not read).  Single-shard only, as in the reference."""
    assert comm.n_shards == 1, "the swept broadphase is single-shard"
    lists, info = sweep_lists(pos_cg, quat_cg, half_cg, radius_g, dynamic_g, exclusions,
                              degree, margin, window, n_fat)
    candidate_lists_swept.host_reads += 1
    fallback = bool(info["need_fallback"])
    candidate_lists_swept.last = {"fallback": fallback, "axis": info["axis"],
                                  "fat": info["fat"]}
    if fallback:
        candidate_lists_swept.fallbacks += 1
        return candidate_lists(pos_cg, quat_cg, half_cg, radius_g, dynamic_g, exclusions,
                               degree, margin)
    candidate_lists_swept.swept += 1
    return lists


candidate_lists_swept.swept = 0
candidate_lists_swept.fallbacks = 0
candidate_lists_swept.host_reads = 0
candidate_lists_swept.last = None


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
