"""Replicated body-major constraint core.

Port of ``avbd3d_tpu/ops/replicated.py`` (the reference).  Every body owns
D neighbor slots shaped (D, G, 128); each active pair appears twice, once
per endpoint, and all slot math runs in the canonical pair frame (A = lower
body index) so both replicas produce bit-identical duals without any
synchronisation.  Per-body aggregation is a sum over the slot axis, taken
in slot order (``cm.dsum``).  Partner state is fetched through the
reference's ``gather(table, idx)`` seam, by default direct indexing
(``broadphase.gather``; the reference's Mosaic select-gather has no
counterpart here); a body-sharded world passes a gather that reads the
all-gathered global table, and ``own_iota``, the global ids of its own rows
(default 0..N-1).
"""

from __future__ import annotations

import torch

from .. import cm
from ..state import Contacts
from .broadphase import gather

_UP = (0.0, 1.0, 0.0)


def body_iota(g: int, device):
    """(G, 128) int32 body indices."""
    return torch.arange(g * 128, dtype=torch.int32, device=device).reshape(g, 128)


def gather_comps(comps, idx, gather=gather):
    return tuple(gather(c, idx) for c in comps)


def canonical_select(is_a, own, other):
    """Canonical A/B selection: A-side value where this body is A."""
    if isinstance(own, tuple):
        return cm.vwhere(is_a, own, other), cm.vwhere(is_a, other, own)
    return torch.where(is_a, own, other), torch.where(is_a, other, own)


def _own_iota(own_iota, g, device):
    return body_iota(g, device) if own_iota is None else own_iota


def pair_frames(cache_other, body, gather=gather, own_iota=None):
    """Gather partner poses and build the canonical A/B frames; every entry
    has the slot shape (D, G, 128)."""
    d, g, _ = cache_other.shape
    valid = cache_other >= 0
    idx = torch.where(valid, cache_other, 0)
    is_a = _own_iota(own_iota, g, idx.device)[None] < idx
    own_pos = tuple(c[None] for c in body["pos"])
    own_quat = tuple(c[None] for c in body["quat"])
    oth_pos = gather_comps(body["pos"], idx, gather)
    oth_quat = gather_comps(body["quat"], idx, gather)
    pa, pb = canonical_select(is_a, own_pos, oth_pos)
    qa, qb = canonical_select(is_a, own_quat, oth_quat)
    return {"valid": valid, "is_a": is_a, "idx": idx,
            "pa": pa, "qa": qa, "pb": pb, "qb": qb}


def once_mask(other, dynf, gather=gather, own_iota=None):
    """(D, G, 128) mask counting each pair at one replica: the lower-index
    side, or the dynamic side when the partner is static (static bodies own
    no slots).  ``dynf``: (G, 128) float 1 for dynamic bodies."""
    valid = other >= 0
    idx = torch.where(valid, other, 0)
    other_dyn = gather(dynf, idx) > 0.5
    iota = _own_iota(own_iota, dynf.shape[0], dynf.device)[None]
    return valid & ((iota < idx) | ~other_dyn)


def pair_constants(cache_other, body, gather=gather):
    """Friction mu = sqrt(muA muB) (manifold.cpp:73) and the normal-cap
    mass scale (manifold.cpp:199-204); symmetric in the two bodies."""
    valid = cache_other >= 0
    idx = torch.where(valid, cache_other, 0)
    mu = torch.sqrt(body["friction"][None] * gather(body["friction"], idx))
    inv_sum = body["inv_mass"][None] + gather(body["inv_mass"], idx)
    mass_scale = torch.where(inv_sum > 1.0e-6,
                             1.0 / torch.clamp(inv_sum, min=1.0e-6), 1.0)
    return {"mu": mu, "mass_scale": mass_scale, "valid": valid, "idx": idx}


def _face_axis_sep(delta, own_ax, own_half, par_ax, ph):
    """Best separation over the 6 face axes of the two boxes."""
    def proj(axes, half, n_vec):
        acc = None
        for k in range(3):
            term = half[k] * torch.abs(
                axes[k][0] * n_vec[0] + axes[k][1] * n_vec[1]
                + axes[k][2] * n_vec[2])
            acc = term if acc is None else acc + term
        return acc

    best = None
    for n_vec in list(own_ax) + list(par_ax):
        sep = (
            torch.abs(delta[0] * n_vec[0] + delta[1] * n_vec[1]
                      + delta[2] * n_vec[2])
            - proj(own_ax, own_half, n_vec)
            - proj(par_ax, ph, n_vec)
        )
        best = torch.clamp(sep, min=-1.0e9) if best is None else torch.maximum(best, sep)
    return best


def precull_near(dc: int, neighbors, body, params, gather=gather):
    """Compact the (D, G, 128) candidate slots, in candidate order, to the
    ``dc`` slots whose 6-face-axis separation is within the collision
    margin (+1e-4 guard).  Returns (neighbors (dc, G, 128), dropped ())."""
    valid = neighbors >= 0
    idx = torch.where(valid, neighbors, 0)
    pp = gather_comps(body["pos"], idx, gather)
    pq = gather_comps(body["quat"], idx, gather)
    ph = gather_comps(body["half"], idx, gather)
    delta = tuple(pp[k] - body["pos"][k][None] for k in range(3))
    own_ax = [tuple(c[None] for c in ax) for ax in cm.q_axes(tuple(body["quat"]))]
    own_half = tuple(h[None] for h in body["half"])
    par_ax = cm.q_axes(tuple(pq))
    best = _face_axis_sep(delta, own_ax, own_half, par_ax, ph)
    keep = valid & (best <= params.collision_margin + 1.0e-4)

    d = neighbors.shape[0]
    run = torch.zeros_like(neighbors[0])
    rank = []
    for dd in range(d):
        rank.append(run)
        run = run + keep[dd].to(torch.int32)
    dropped = torch.sum(torch.clamp(run - dc, min=0)).to(torch.int32)
    out = []
    for t in range(dc):
        acc = torch.full_like(neighbors[0], -1)
        for dd in range(d):
            acc = torch.where(keep[dd] & (rank[dd] == t), neighbors[dd], acc)
        out.append(acc)
    return torch.stack(out), dropped


def collide_and_init(old: Contacts, neighbors, body, params, gather=gather, own_iota=None):
    """Replicated narrowphase + warmstart transfer (manifold.cpp:71-175,
    solver.cpp:281-293).  Returns (Contacts, dropped-manifold count ())."""
    from .narrowphase_cm import collide_pairs_cm

    d_new = neighbors.shape[0]
    d_cache = old.other.shape[0]
    dropped = torch.zeros((), dtype=torch.int32, device=neighbors.device)
    if d_cache < d_new:
        neighbors, dropped = precull_near(d_cache, neighbors, body, params, gather)
    frames = pair_frames(neighbors, body, gather, own_iota)
    valid = frames["valid"]
    is_a = frames["is_a"]

    own_half = tuple(c[None] for c in body["half"])
    oth_half = gather_comps(body["half"], frames["idx"], gather)
    ha, hb = canonical_select(is_a, own_half, oth_half)

    geom = collide_pairs_cm(
        {"pos": frames["pa"], "quat": frames["qa"], "half": ha},
        {"pos": frames["pb"], "quat": frames["qb"], "half": hb},
        params.collision_margin,
    )
    slot_ok = [ok & valid for ok in geom["slot_ok"]]
    feature = [torch.where(ok, ft, -1) for ok, ft in zip(slot_ok, geom["feature"])]
    count = torch.where(valid, geom["count"], 0)
    g_normal = geom["normal"]
    g_xa = geom["x_a"]
    g_xb = geom["x_b"]

    # ---- pair match against the body's OWN old slots ----
    d_old = old.other.shape[0]
    found = torch.zeros_like(valid)
    match_d = torch.zeros_like(neighbors)
    for dp in range(d_old):
        hit = (valid & (old.other[dp][None] == neighbors)
               & (old.count[dp][None] > 0) & ~found)
        found = found | hit
        match_d = torch.where(hit, dp, match_d)

    m_idx = match_d.long()

    def fetch(arr):
        """arr[..., match_d, g, lane]: each new slot's matched old slot."""
        return arr.gather(arr.dim() - 3, m_idx.expand(arr.shape[:-3] + m_idx.shape))

    o_count = torch.where(found, fetch(old.count), 0)
    o_feature = [torch.where(found, fetch(old.feature[s]), -1) for s in range(4)]
    o_stick = [fetch(old.stick[s].to(torch.int32)) > 0 for s in range(4)]
    o_normal = [fetch(old.normal[k]) for k in range(3)]
    o_r_a = [[fetch(old.r_a[s, k]) for k in range(3)] for s in range(4)]
    o_r_b = [[fetch(old.r_b[s, k]) for k in range(3)] for s in range(4)]
    o_lam = [fetch(old.lam[r]) for r in range(12)]
    o_pen = [fetch(old.penalty[r]) for r in range(12)]

    new_n_unit = cm.normalize_or(g_normal, _UP)
    old_n_unit = cm.normalize_or(tuple(o_normal), new_n_unit)
    normal_dot = cm.dot(new_n_unit, old_n_unit)

    # ---- within-pair greedy feature match (manifold.cpp:109-119) ----
    used = [torch.zeros_like(valid) for _ in range(4)]
    n_unit, t1, t2 = _contact_basis(g_normal)

    r_a_slots, r_b_slots, stick_slots = [], [], []
    lam_rows, pen_rows = [], []
    c0n_slots, c0t1_slots, c0t2_slots = [], [], []
    decay = params.alpha * params.gamma
    ws2 = params.warmstart_max_drift**2
    st2 = params.stick_anchor_max_drift**2

    old_mid = []
    for s in range(4):
        mid = cm.scale(
            cm.add(
                cm.add(frames["pa"], cm.q_rotate(frames["qa"], tuple(o_r_a[s]))),
                cm.add(frames["pb"], cm.q_rotate(frames["qb"], tuple(o_r_b[s]))),
            ),
            0.5,
        )
        old_mid.append(mid)

    zero = torch.zeros_like(frames["pa"][0])
    for i in range(4):
        slot_valid = slot_ok[i]
        matched = torch.zeros_like(valid)
        m_mid = (zero, zero, zero)
        m_stick = torch.zeros_like(valid)
        m_r_a = (zero, zero, zero)
        m_r_b = (zero, zero, zero)
        m_lam = [zero] * 3
        m_pen = [zero] * 3
        for j in range(4):
            o_ok = (j < o_count) & (o_feature[j] >= 0)
            elig = ((o_feature[j] == feature[i]) & o_ok & ~used[j] & slot_valid
                    & ~matched & found)
            matched = matched | elig
            used[j] = used[j] | elig
            m_mid = cm.vwhere(elig, old_mid[j], m_mid)
            m_stick = torch.where(elig, o_stick[j], m_stick)
            m_r_a = cm.vwhere(elig, tuple(o_r_a[j]), m_r_a)
            m_r_b = cm.vwhere(elig, tuple(o_r_b[j]), m_r_b)
            for k in range(3):
                m_lam[k] = torch.where(elig, o_lam[j * 3 + k], m_lam[k])
                m_pen[k] = torch.where(elig, o_pen[j * 3 + k], m_pen[k])

        new_r_a = cm.q_rotate_inv(frames["qa"], cm.sub(g_xa[i], frames["pa"]))
        new_r_b = cm.q_rotate_inv(frames["qb"], cm.sub(g_xb[i], frames["pb"]))
        new_mid = cm.scale(cm.add(g_xa[i], g_xb[i]), 0.5)

        drift2 = cm.length_sq(cm.sub(new_mid, m_mid))
        warm = (matched & (normal_dot >= params.warmstart_normal_min_dot)
                & (drift2 <= ws2))
        lam_i = [torch.where(warm, l, 0.0) for l in m_lam]
        pen_i = [
            torch.where(warm, torch.clamp(pe, params.penalty_min,
                                          params.manifold_penalty_cap),
                        params.penalty_min)
            for pe in m_pen
        ]
        reuse = (warm & m_stick & (normal_dot >= params.stick_normal_min_dot)
                 & (drift2 <= st2))
        stick_i = m_stick & reuse
        r_a_i = cm.vwhere(reuse, m_r_a, new_r_a)
        r_b_i = cm.vwhere(reuse, m_r_b, new_r_b)

        # warmstart decay (solver.cpp:281-293); contact rows are hard
        if not params.post_stabilize:
            lam_i = [l * decay for l in lam_i]
        pen_i = [torch.clamp(pe * params.gamma, params.penalty_min, params.penalty_max)
                 for pe in pen_i]
        lam_i = [torch.where(slot_valid, l, 0.0) for l in lam_i]
        pen_i = [torch.where(slot_valid, pe, 0.0) for pe in pen_i]

        # alpha-stabilization cache at pre-step poses (manifold.cpp:159-171)
        p_a_i = cm.add(frames["pa"], cm.q_rotate(frames["qa"], r_a_i))
        p_b_i = cm.add(frames["pb"], cm.q_rotate(frames["qb"], r_b_i))
        delta = cm.sub(p_a_i, p_b_i)
        c0n_slots.append(cm.dot(delta, n_unit) - params.normal_contact_margin)
        c0t1_slots.append(cm.dot(delta, t1))
        c0t2_slots.append(cm.dot(delta, t2))

        r_a_slots.append(r_a_i)
        r_b_slots.append(r_b_i)
        stick_slots.append(stick_i)
        lam_rows.extend(lam_i)
        pen_rows.extend(pen_i)

    return Contacts(
        other=torch.where(count > 0, neighbors, -1),
        count=count,
        feature=torch.stack(feature),
        r_a=torch.stack([torch.stack(v) for v in r_a_slots]),
        r_b=torch.stack([torch.stack(v) for v in r_b_slots]),
        normal=torch.stack(n_unit),
        stick=torch.stack(stick_slots),
        c0_n=torch.stack(c0n_slots),
        c0_t1=torch.stack(c0t1_slots),
        c0_t2=torch.stack(c0t2_slots),
        lam=torch.stack(lam_rows),
        penalty=torch.stack(pen_rows),
    ), dropped


def _contact_basis(normal):
    n = cm.normalize_or(normal, _UP)
    cond = torch.abs(n[0]) >= torch.abs(n[2])
    zero = torch.zeros_like(n[0])
    t1 = (
        torch.where(cond, -n[1], zero),
        torch.where(cond, n[0], -n[2]),
        torch.where(cond, zero, n[1]),
    )
    t1 = cm.normalize_or(t1, (1.0, 0.0, 0.0))
    t2 = cm.normalize_or(cm.cross(n, t1), (0.0, 0.0, 1.0))
    return n, t1, t2




# ---------------------------------------------------------------------------
# Iteration-loop row math.  The reference unrolls the 4 contacts of a slot
# (and the 3 rows of a contact) in Python; here they are a leading tensor
# axis of 4 (or 12 = 4 x 3 rows), which keeps the per-element arithmetic
# and every accumulation order while launching a quarter of the ops.
# ---------------------------------------------------------------------------

def geometry_static(cache: Contacts, consts, own_iota=None):
    """Loop-invariant geometry: contact basis (three 3-tuples of (D, G,
    128)), canonical side flag, and the (4, D, G, 128) contact masks."""
    g = _own_iota(own_iota, cache.other.shape[1], cache.other.device)[None]
    s = torch.arange(4, dtype=torch.int32, device=g.device).reshape(4, 1, 1, 1)
    return {
        "basis": _contact_basis((cache.normal[0], cache.normal[1], cache.normal[2])),
        "is_a": g < consts["idx"],
        "slot_ok": (s < cache.count[None]) & consts["valid"][None],
    }


def geometry_pose(cache: Contacts, static, body_pose, consts, partner=None, gather=gather):
    """Pose-dependent geometry (manifold.cpp:184-196) at ``body_pose``
    ('pos' 3, 'quat' 4 tuples of (G, 128)): world lever arms ``rw_a``/
    ``rw_b`` (3-tuples) and raw separation/slips, each (4, D, G, 128).
    ``partner``: the slots' partner poses ('pos', 'quat' tuples of (D, G,
    128)); by default gathered from ``body_pose``."""
    idx = consts["idx"]
    is_a = static["is_a"]
    n_unit, t1, t2 = static["basis"]
    if partner is None:
        partner = {"pos": gather_comps(body_pose["pos"], idx, gather),
                   "quat": gather_comps(body_pose["quat"], idx, gather)}
    own_pos = tuple(c[None] for c in body_pose["pos"])
    own_quat = tuple(c[None] for c in body_pose["quat"])
    pa, pb = canonical_select(is_a, own_pos, partner["pos"])
    qa, qb = canonical_select(is_a, own_quat, partner["quat"])
    ra = cm.q_rotate(qa, (cache.r_a[:, 0], cache.r_a[:, 1], cache.r_a[:, 2]))
    rb = cm.q_rotate(qb, (cache.r_b[:, 0], cache.r_b[:, 1], cache.r_b[:, 2]))
    delta = cm.sub(cm.add(pa, ra), cm.add(pb, rb))
    return {"basis": static["basis"], "rw_a": ra, "rw_b": rb,
            "sep": cm.dot(delta, n_unit), "slip1": cm.dot(delta, t1),
            "slip2": cm.dot(delta, t2), "is_a": is_a,
            "slot_ok": static["slot_ok"]}


def eval_geometry(cache: Contacts, body_pose, consts, gather=gather, own_iota=None):
    """Full geometry evaluation (static + pose-dependent parts) at
    ``body_pose``."""
    return geometry_pose(cache, geometry_static(cache, consts, own_iota), body_pose, consts,
                         gather=gather)


def _rows(x4):
    """(4, 3, ...) per-contact rows -> (12, ...) in row order s * 3 + k."""
    return x4.reshape((12,) + x4.shape[2:])


def eval_rows(geom, cache: Contacts, consts, lam, penalty, stick, alpha, params):
    """computeConstraint row math (manifold.cpp:193-245): biased C, cone
    bounds, lambda projection, stick update.  lam/penalty (12, D, G, 128),
    stick (4, D, G, 128) bool, ``alpha`` a float32 tensor.  Returns
    C/fmin/fmax/lam (12, D, G, 128), stick and row_ok masks."""
    bias = torch.clamp(1.0 - alpha, 0.0, 1.0)
    cap = params.normal_force_cap * consts["mass_scale"]
    lam4 = lam.reshape((4, 3) + lam.shape[1:])
    pen4 = penalty.reshape((4, 3) + penalty.shape[1:])

    c_n = (geom["sep"] - params.normal_contact_margin) + bias * cache.c0_n
    c_t1 = geom["slip1"] + bias * cache.c0_t1
    c_t2 = geom["slip2"] + bias * cache.c0_t2

    lam_n = lam4[:, 0]
    warm_mag = torch.abs(torch.clamp(lam_n, max=0.0))
    trial = pen4[:, 0] * c_n + lam_n
    trial_mag = torch.abs(torch.clamp(trial, max=0.0))
    normal_mag = torch.minimum(torch.maximum(warm_mag, trial_mag), cap)

    mu = torch.where(stick, consts["mu"], consts["mu"] * 0.9)
    limit = mu * normal_mag

    lt1, lt2 = lam4[:, 1], lam4[:, 2]
    tan_mag = torch.sqrt(lt1 * lt1 + lt2 * lt2)
    scale = torch.where((tan_mag > limit) & (tan_mag > 1.0e-8),
                        limit / torch.clamp(tan_mag, min=1.0e-8), 1.0)
    lt1 = lt1 * scale
    lt2 = lt2 * scale

    slip_sq = c_t1 * c_t1 + c_t2 * c_t2
    tan_sq = lt1 * lt1 + lt2 * lt2
    new_stick = ((slip_sq <= params.stick_thresh**2)
                 & (tan_sq <= limit * limit + 1.0e-8) & geom["slot_ok"])

    cap4 = cap.expand_as(limit)
    return {
        "C": _rows(torch.stack([c_n, c_t1, c_t2], 1)),
        "fmin": _rows(torch.stack([-cap4, -limit, -limit], 1)),
        "fmax": _rows(torch.stack([torch.zeros_like(limit), limit, limit], 1)),
        "lam": _rows(torch.stack([lam_n, lt1, lt2], 1)),
        "stick": new_stick,
        "row_ok": _rows(geom["slot_ok"][:, None].expand((4, 3) + limit.shape[1:])),
    }


def _clip(x, lo, hi):
    """jnp.clip with tensor bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def primal_force(rows, penalty):
    """f = clamp(penalty*C + lambda, fmin, fmax) (solver.cpp:379-381),
    (12, D, G, 128)."""
    return torch.where(rows["row_ok"],
                       _clip(penalty * rows["C"] + rows["lam"], rows["fmin"],
                             rows["fmax"]),
                       0.0)


def _contact_sum(x):
    """Sum over the contact axis (dim 1 of (C, 4, ...)) in contact order."""
    return x[:, 0] + x[:, 1] + x[:, 2] + x[:, 3]


def body_forces(geom, f):
    """Own-side generalized force F(3), T(3) per body, reduced over the
    contacts of a slot, then over the slots (solver.cpp:375-398)."""
    n_unit, t1, t2 = geom["basis"]
    sign = torch.where(geom["is_a"], 1.0, -1.0)
    rw = cm.vwhere(geom["is_a"], geom["rw_a"], geom["rw_b"])
    f4 = f.reshape((4, 3) + f.shape[1:])
    fv = tuple(n_unit[k] * f4[:, 0] + t1[k] * f4[:, 1] + t2[k] * f4[:, 2]
               for k in range(3))
    tv = cm.cross(rw, fv)
    per = torch.stack([sign * x for x in fv + tv])        # (6, 4, D, G, 128)
    tot = cm.dsum(_contact_sum(per).transpose(0, 1))      # (6, G, 128)
    return {"F": list(tot[:3]), "T": list(tot[3:])}


def _row_basis(geom):
    """Basis vector of each of the 12 rows (row s*3+k uses basis k) and the
    own lever arm of its contact s, all (12, D, G, 128) comps."""
    n_unit, t1, t2 = geom["basis"]
    shape = (4, 3) + n_unit[0].shape
    b = tuple(_rows(torch.stack([n_unit[i], t1[i], t2[i]])[None].expand(shape))
              for i in range(3))
    return b


def body_matrix(geom, f, penalty, iiw_own):
    """Own-side 6x6 Hessian contributions m_ll(6), m_la(9), m_aa(6) and the
    gyro diagonal (3) per body (solver.cpp:384-397), accumulated over the
    12 rows of a slot in row order, then over the slots."""
    b = _row_basis(geom)
    shape = (4, 3) + b[0].shape[1:]
    rw = tuple(_rows(x[:, None].expand(shape))
               for x in cm.vwhere(geom["is_a"], geom["rw_a"], geom["rw_b"]))
    ok = _rows(geom["slot_ok"][:, None].expand(shape)).to(torch.float32)
    pe = penalty * ok
    c = cm.cross(rw, b)
    terms = [pe * b[0] * b[0], pe * b[0] * b[1], pe * b[0] * b[2],
             pe * b[1] * b[1], pe * b[1] * b[2], pe * b[2] * b[2]]
    terms += [pe * b[i] * c[j] for i in range(3) for j in range(3)]
    terms += [pe * c[0] * c[0], pe * c[0] * c[1], pe * c[0] * c[2],
              pe * c[1] * c[1], pe * c[1] * c[2], pe * c[2] * c[2]]
    w = [x[None] for x in iiw_own]
    ic = (w[0] * c[0] + w[1] * c[1] + w[2] * c[2],
          w[1] * c[0] + w[3] * c[1] + w[4] * c[2],
          w[2] * c[0] + w[4] * c[1] + w[5] * c[2])
    gcr = cm.cross(c, ic)
    af = torch.abs(f)
    terms += [torch.abs(gcr[k]) * af for k in range(3)]
    per = torch.stack(terms)                              # (24, 12, D, G, 128)
    acc = per[:, 0]
    for r in range(1, 12):
        acc = acc + per[:, r]
    tot = cm.dsum(acc.transpose(0, 1))                    # (24, G, 128)
    return {"m_ll": list(tot[:6]), "m_la": list(tot[6:15]),
            "m_aa": list(tot[15:21]), "gyro": list(tot[21:24])}


def body_system(geom, f, penalty, iiw_own):
    """Forces and matrix in one call (the reference's per-iteration form)."""
    out = dict(body_forces(geom, f))
    out.update(body_matrix(geom, f, penalty, iiw_own))
    return out


def dual_update(rows, geom, penalty, beta, params):
    """Dual ascent + penalty ramp (solver.cpp:411-429) at post-primal poses;
    replica-identical because every operand is canonical."""
    b = _row_basis(geom)
    shape = (4, 3) + b[0].shape[1:]
    rw_a = tuple(_rows(x[:, None].expand(shape)) for x in geom["rw_a"])
    rw_b = tuple(_rows(x[:, None].expand(shape)) for x in geom["rw_b"])
    ang_w = cm.length_sq(cm.cross(rw_a, b)) + cm.length_sq(cm.cross(rw_b, b))
    lin_w = 2.0
    gain = (beta * lin_w + beta * params.angular_beta_scale * ang_w) / (
        lin_w + ang_w + 1.0e-8)
    lam_r = _clip(penalty * rows["C"] + rows["lam"], rows["fmin"], rows["fmax"])
    active = (lam_r > rows["fmin"]) & (lam_r < rows["fmax"])
    pe = torch.where(active,
                     torch.clamp(penalty + gain * torch.abs(rows["C"]),
                                 max=params.manifold_penalty_cap),
                     penalty)
    ok = rows["row_ok"]
    return (torch.where(ok, lam_r, 0.0), torch.where(ok, pe, penalty),
            rows["stick"])
