"""Component-major SAT box-box narrowphase.

Port of ``avbd3d_tpu/ops/narrowphase_cm.py`` (the reference; the mapping to
collision.cpp is documented there): 15 SAT axes, the clipped face polygon
as 24 masked candidate points reduced to <= 4 picks, the edge-edge contact,
and the exact feature-id bit layout.  Every quantity is a tensor of pair
shape; small loops are unrolled in Python in the reference's order, which
the collide kernel in csrc/step_kernel.cu repeats statement for statement.
"""

from __future__ import annotations

import torch

from .. import cm

SAT_AXIS_EPSILON = 1.0e-6
PLANE_EPSILON = 1.0e-5
CONTACT_MERGE_DIST_SQ = 1.0e-6
AXIS_EDGE = 2

_NEG = -3.0e38

_w = cm.where


def _select3(idx, items):
    """items[idx] for idx in {0, 1, 2}, component-wise."""
    def sel(c0, c1, c2):
        return _w(idx == 0, c0, _w(idx == 1, c1, c2))
    if isinstance(items[0], tuple):
        return tuple(sel(items[0][k], items[1][k], items[2][k])
                     for k in range(len(items[0])))
    return sel(*items)


def _axis_max(seps, valids):
    """First-win strict-greater max over a static list: (sep, idx)."""
    best_sep = _w(valids[0], seps[0], _NEG)
    best_idx = torch.zeros(seps[0].shape, dtype=torch.int32, device=seps[0].device)
    for k in range(1, len(seps)):
        s = _w(valids[k], seps[k], _NEG)
        take = s > best_sep
        best_sep = torch.where(take, s, best_sep)
        best_idx = torch.where(take, k, best_idx)
    return best_sep, best_idx


def collide_pairs_cm(body_a, body_b, margin):
    """body_a/body_b: dicts of component tuples 'pos' (3), 'quat' (4),
    'half' (3) of pair shape.  Returns normal (B -> A), x_a/x_b, feature,
    slot_ok (4 each) and count, component-major."""
    pa, qa, ha = body_a["pos"], body_a["quat"], body_a["half"]
    pb, qb, hb = body_b["pos"], body_b["quat"], body_b["half"]

    axes_a = cm.q_axes(qa)
    axes_b = cm.q_axes(qb)
    delta = cm.sub(pb, pa)

    face_seps, face_valid, face_normals = [], [], []
    edge_seps, edge_valid, edge_normals = [], [], []

    def test_axis(axis, out_seps, out_valid, out_normals):
        lsq = cm.length_sq(axis)
        degen = lsq < SAT_AXIS_EPSILON
        inv = 1.0 / torch.sqrt(torch.where(degen, 1.0, lsq))
        n = cm.scale(axis, inv)
        flip = cm.dot(n, delta) < 0.0
        n = tuple(torch.where(flip, -x, x) for x in n)
        dist = torch.abs(cm.dot(n, delta))
        r_a = (
            ha[0] * torch.abs(cm.dot(n, axes_a[0]))
            + ha[1] * torch.abs(cm.dot(n, axes_a[1]))
            + ha[2] * torch.abs(cm.dot(n, axes_a[2]))
        )
        r_b = (
            hb[0] * torch.abs(cm.dot(n, axes_b[0]))
            + hb[1] * torch.abs(cm.dot(n, axes_b[1]))
            + hb[2] * torch.abs(cm.dot(n, axes_b[2]))
        )
        out_seps.append(dist - (r_a + r_b))
        out_valid.append(~degen)
        out_normals.append(n)

    for k in range(3):
        test_axis(axes_a[k], face_seps, face_valid, face_normals)
    for k in range(3):
        test_axis(axes_b[k], face_seps, face_valid, face_normals)
    for i in range(3):
        for j in range(3):
            test_axis(cm.cross(axes_a[i], axes_b[j]), edge_seps, edge_valid,
                      edge_normals)

    separated = torch.zeros(face_seps[0].shape, dtype=torch.bool,
                            device=face_seps[0].device)
    for s, v in zip(face_seps + edge_seps, face_valid + edge_valid):
        separated = separated | (v & (s > margin))

    best_face_sep, best_face = _axis_max(face_seps, face_valid)
    best_edge_sep, best_edge = _axis_max(edge_seps, edge_valid)
    edge_any = torch.zeros_like(separated)
    for v in edge_valid:
        edge_any = edge_any | v
    # Edge preference with a depth gate (reference narrowphase_cm.py:105-116).
    use_edge = (
        edge_any
        & (0.95 * best_edge_sep > best_face_sep + 0.01)
        & (best_edge_sep > -0.05)
    )

    # ---- face manifold ----
    ref_is_a = best_face < 3
    ref_axis = torch.where(ref_is_a, best_face, best_face - 3)
    normal_ab = face_normals[0]
    for k in range(1, 6):
        normal_ab = cm.vwhere(best_face == k, face_normals[k], normal_ab)

    def pick_box(field_a, field_b):
        return cm.vwhere(ref_is_a, field_a, field_b)

    ref_axes = (pick_box(axes_a[0], axes_b[0]), pick_box(axes_a[1], axes_b[1]),
                pick_box(axes_a[2], axes_b[2]))
    inc_axes = (pick_box(axes_b[0], axes_a[0]), pick_box(axes_b[1], axes_a[1]),
                pick_box(axes_b[2], axes_a[2]))
    ref_center = pick_box(pa, pb)
    inc_center = pick_box(pb, pa)
    ref_half = tuple(torch.where(ref_is_a, x, y) for x, y in zip(ha, hb))
    inc_half = tuple(torch.where(ref_is_a, x, y) for x, y in zip(hb, ha))

    ref_outward = cm.vwhere(ref_is_a, normal_ab, cm.neg(normal_ab))
    ref_axis_vec = _select3(ref_axis, ref_axes)
    sign_ref = _w(cm.dot(ref_outward, ref_axis_vec) >= 0.0, 1.0, -1.0)
    n_ref = cm.scale(ref_axis_vec, sign_ref)
    ref_h = _select3(ref_axis, ref_half)
    face_center = cm.add(ref_center, cm.scale(n_ref, ref_h))

    u_idx = _w(ref_axis == 0, 1, torch.zeros_like(ref_axis))
    v_idx = _w(ref_axis == 2, 1, torch.full_like(ref_axis, 2))
    u_ax = _select3(u_idx, ref_axes)
    v_ax = _select3(v_idx, ref_axes)
    eu = _select3(u_idx, ref_half)
    ev = _select3(v_idx, ref_half)

    # incident face: most anti-parallel to n_ref (first-win max of |dot|)
    inc_dots = [torch.abs(cm.dot(inc_axes[k], n_ref)) for k in range(3)]
    ones = torch.ones_like(separated)
    _, inc_axis = _axis_max(inc_dots, [ones] * 3)
    inc_axis_vec = _select3(inc_axis, inc_axes)
    sign_inc = _w(cm.dot(inc_axis_vec, n_ref) > 0.0, -1.0, 1.0)
    n_inc = cm.scale(inc_axis_vec, sign_inc)
    inc_h = _select3(inc_axis, inc_half)
    inc_face_center = cm.add(inc_center, cm.scale(n_inc, inc_h))

    iu_idx = _w(inc_axis == 0, 1, torch.zeros_like(inc_axis))
    iv_idx = _w(inc_axis == 2, 1, torch.full_like(inc_axis, 2))
    iu_ax = _select3(iu_idx, inc_axes)
    iv_ax = _select3(iv_idx, inc_axes)
    ieu = _select3(iu_idx, inc_half)
    iev = _select3(iv_idx, inc_half)

    # Incident corners in the (u, v) reference-face frame.
    su = (1.0, -1.0, -1.0, 1.0)
    sv = (1.0, 1.0, -1.0, -1.0)
    cu, cv = [], []
    for m in range(4):
        corner = cm.add(
            inc_face_center,
            cm.add(cm.scale(iu_ax, su[m] * ieu), cm.scale(iv_ax, sv[m] * iev)),
        )
        rel = cm.sub(corner, face_center)
        cu.append(cm.dot(rel, u_ax))
        cv.append(cm.dot(rel, v_ax))

    # Affine height h(u, v) on the incident plane.
    d_nn = cm.dot(n_inc, n_ref)
    d_nn = torch.where(
        torch.abs(d_nn) < SAT_AXIS_EPSILON,
        _w(d_nn < 0, -SAT_AXIS_EPSILON, SAT_AXIS_EPSILON),
        d_nn,
    )
    h0 = cm.dot(n_inc, cm.sub(inc_face_center, face_center)) / d_nn
    hu = -cm.dot(n_inc, u_ax) / d_nn
    hv = -cm.dot(n_inc, v_ax) / d_nn

    # ---- candidates: 4 corners + 16 edge crossings + 4 rect corners ----
    cand_u, cand_v, cand_ok = [], [], []
    for m in range(4):
        ok = (torch.abs(cu[m]) <= eu + PLANE_EPSILON) & (
            torch.abs(cv[m]) <= ev + PLANE_EPSILON)
        cand_u.append(cu[m])
        cand_v.append(cv[m])
        cand_ok.append(ok)

    for m in range(4):
        m2 = (m + 1) % 4
        du = cu[m2] - cu[m]
        dv = cv[m2] - cv[m]
        for side_u, side_sign in ((True, 1.0), (True, -1.0), (False, 1.0),
                                  (False, -1.0)):
            if side_u:
                bound = eu * side_sign
                dcoord, ccoord = du, cu[m]
                oc, od, oext = cv[m], dv, ev
            else:
                bound = ev * side_sign
                dcoord, ccoord = dv, cv[m]
                oc, od, oext = cu[m], du, eu
            denom_ok = torch.abs(dcoord) > SAT_AXIS_EPSILON
            t = (bound - ccoord) / torch.where(denom_ok, dcoord, 1.0)
            hit = oc + t * od
            ok = (
                denom_ok
                & (t >= -PLANE_EPSILON)
                & (t <= 1.0 + PLANE_EPSILON)
                & (torch.abs(hit) <= oext + PLANE_EPSILON)
            )
            if side_u:
                cand_u.append(bound + torch.zeros_like(hit))
                cand_v.append(hit)
            else:
                cand_u.append(hit)
                cand_v.append(bound + torch.zeros_like(hit))
            cand_ok.append(ok)

    area2 = (
        (cu[1] - cu[0]) * (cv[2] - cv[0]) - (cv[1] - cv[0]) * (cu[2] - cu[0])
        + (cu[2] - cu[0]) * (cv[3] - cv[0]) - (cv[2] - cv[0]) * (cu[3] - cu[0])
    )
    wind = _w(area2 >= 0.0, 1.0, -1.0)
    for m in range(4):
        ru = su[m] * eu
        rv = sv[m] * ev
        inside = torch.ones_like(separated)
        for e in range(4):
            e2 = (e + 1) % 4
            z = (cu[e2] - cu[e]) * (rv - cv[e]) - (cv[e2] - cv[e]) * (ru - cu[e])
            inside = inside & ((z * wind) >= -PLANE_EPSILON)
        cand_u.append(ru)
        cand_v.append(rv)
        cand_ok.append(inside)

    cand_h = [h0 + hu * u + hv * v for u, v in zip(cand_u, cand_v)]
    cand_ok = [ok & (h <= margin) for ok, h in zip(cand_ok, cand_h)]

    # ---- reduce to <= 4 picks: deepest, farthest, +/- max area ----
    n_cand = len(cand_u)   # 24

    def pick(valid_list, score_list):
        best_s = _w(valid_list[0], score_list[0], _NEG)
        best_i = torch.zeros(best_s.shape, dtype=torch.int32, device=best_s.device)
        for k in range(1, n_cand):
            s = _w(valid_list[k], score_list[k], _NEG)
            take = s > best_s
            best_s = torch.where(take, s, best_s)
            best_i = torch.where(take, k, best_i)
        return best_i, best_s > _NEG * 0.5

    def gather_cand(lists, idx):
        out = lists[0]
        for k in range(1, n_cand):
            out = torch.where(idx == k, lists[k], out)
        return out

    def drop_near(valid_list, pu, pv):
        return [
            v & ((((u - pu) * (u - pu)) + ((v_ - pv) * (v_ - pv)))
                 >= CONTACT_MERGE_DIST_SQ)
            for v, u, v_ in zip(valid_list, cand_u, cand_v)
        ]

    valid = cand_ok
    i0, f0 = pick(valid, [-h for h in cand_h])
    p0u = gather_cand(cand_u, i0)
    p0v = gather_cand(cand_v, i0)
    valid = drop_near(valid, p0u, p0v)

    d2 = [(u - p0u) * (u - p0u) + (v - p0v) * (v - p0v)
          for u, v in zip(cand_u, cand_v)]
    i1, f1 = pick(valid, d2)
    p1u = gather_cand(cand_u, i1)
    p1v = gather_cand(cand_v, i1)
    valid = drop_near(valid, p1u, p1v)

    a01 = [
        (p1u - p0u) * (v - p0v) - (p1v - p0v) * (u - p0u)
        for u, v in zip(cand_u, cand_v)
    ]
    i2, f2 = pick(valid, a01)
    p2u = gather_cand(cand_u, i2)
    p2v = gather_cand(cand_v, i2)
    valid = drop_near(valid, p2u, p2v)

    i3, f3 = pick(valid, [-a for a in a01])
    p3u = gather_cand(cand_u, i3)
    p3v = gather_cand(cand_v, i3)

    picks_u = [p0u, p1u, p2u, p3u]
    picks_v = [p0v, p1v, p2v, p3v]
    picks_ok = [f0, f0 & f1, f0 & f1 & f2, f0 & f1 & f2 & f3]
    picks_h = [gather_cand(cand_h, i) for i in (i0, i1, i2, i3)]

    # ---- per-slot outputs ----
    eu_safe = _w(eu > SAT_AXIS_EPSILON, eu, 1.0)
    ev_safe = _w(ev > SAT_AXIS_EPSILON, ev, 1.0)
    face_type = ref_is_a.logical_not().to(torch.int32)
    prefix = (face_type << 24) | (ref_axis << 16) | (inc_axis << 8)

    # ---- edge contact ----
    e_i = torch.div(best_edge, 3, rounding_mode="floor")
    e_j = best_edge - e_i * 3
    edge_n = edge_normals[0]
    for k in range(1, 9):
        edge_n = cm.vwhere(best_edge == k, edge_normals[k], edge_n)

    def support_edge(axes, half, axis_index, direction):
        a1 = _select3((axis_index + 1) % 3, axes)
        a2 = _select3((axis_index + 2) % 3, axes)
        h1 = _select3((axis_index + 1) % 3, half)
        h2 = _select3((axis_index + 2) % 3, half)
        hx = _select3(axis_index, half)
        ax = _select3(axis_index, axes)
        s1 = _w(cm.dot(direction, a1) >= 0.0, 1.0, -1.0)
        s2 = _w(cm.dot(direction, a2) >= 0.0, 1.0, -1.0)
        ec = cm.add(cm.scale(a1, h1 * s1), cm.scale(a2, h2 * s2))
        return ec, cm.scale(ax, hx)

    ec_a, eh_a = support_edge(axes_a, ha, e_i, edge_n)
    ec_b, eh_b = support_edge(axes_b, hb, e_j, cm.neg(edge_n))
    p0 = cm.sub(cm.add(pa, ec_a), eh_a)
    p1 = cm.add(cm.add(pa, ec_a), eh_a)
    q0 = cm.sub(cm.add(pb, ec_b), eh_b)
    q1 = cm.add(cm.add(pb, ec_b), eh_b)

    d1 = cm.sub(p1, p0)
    d2_ = cm.sub(q1, q0)
    r = cm.sub(p0, q0)
    a = cm.dot(d1, d1)
    e = cm.dot(d2_, d2_)
    f = cm.dot(d2_, r)
    c = cm.dot(d1, r)
    b_ = cm.dot(d1, d2_)
    denom = a * e - b_ * b_
    a_safe = _w(a > SAT_AXIS_EPSILON, a, 1.0)
    e_safe = _w(e > SAT_AXIS_EPSILON, e, 1.0)
    den_ok = torch.abs(denom) > SAT_AXIS_EPSILON
    s = _w(den_ok,
           torch.clamp((b_ * f - c * e) / _w(den_ok, denom, 1.0), 0.0, 1.0),
           0.0)
    t = (b_ * s + f) / e_safe
    s = torch.where(t < 0.0, torch.clamp(-c / a_safe, 0.0, 1.0),
                    torch.where(t > 1.0, torch.clamp((b_ - c) / a_safe, 0.0, 1.0), s))
    t = torch.clamp(t, 0.0, 1.0)
    edge_x_a = cm.add(p0, cm.scale(d1, s))
    edge_x_b = cm.add(q0, cm.scale(d2_, t))
    edge_feature = (AXIS_EDGE << 24) | (e_i << 8) | e_j

    # ---- merge face/edge per slot ----
    normal_ba = cm.vwhere(use_edge, cm.neg(edge_n), cm.neg(normal_ab))
    out = {"normal": normal_ba, "x_a": [], "x_b": [], "feature": [],
           "slot_ok": []}
    for slot in range(4):
        fu = picks_u[slot]
        fv = picks_v[slot]
        fh = picks_h[slot]
        p_ref = cm.add(face_center, cm.add(cm.scale(u_ax, fu), cm.scale(v_ax, fv)))
        p_inc = cm.add(p_ref, cm.scale(n_ref, fh))
        face_x_a = cm.vwhere(ref_is_a, p_ref, p_inc)
        face_x_b = cm.vwhere(ref_is_a, p_inc, p_ref)
        q_u = torch.clamp(torch.floor((fu / eu_safe + 1.0) * 7.5), 0, 15).to(torch.int32)
        q_v = torch.clamp(torch.floor((fv / ev_safe + 1.0) * 7.5), 0, 15).to(torch.int32)
        face_feat = prefix | (q_u << 4) | q_v

        if slot == 0:
            x_a = cm.vwhere(use_edge, edge_x_a, face_x_a)
            x_b = cm.vwhere(use_edge, edge_x_b, face_x_b)
            feat = torch.where(use_edge, edge_feature, face_feat)
            ok = use_edge | picks_ok[slot]
        else:
            x_a, x_b, feat = face_x_a, face_x_b, face_feat
            ok = picks_ok[slot] & ~use_edge
        ok = ok & ~separated
        out["x_a"].append(x_a)
        out["x_b"].append(x_b)
        out["feature"].append(torch.where(ok, feat, -1))
        out["slot_ok"].append(ok)

    out["count"] = (out["slot_ok"][0].to(torch.int32) + out["slot_ok"][1].to(torch.int32)
                    + out["slot_ok"][2].to(torch.int32) + out["slot_ok"][3].to(torch.int32))
    return out
