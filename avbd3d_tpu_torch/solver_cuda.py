"""The contact step on the card: the fused step kernel (K1) and the
control-lanes kernel (K2), their plain PyTorch versions, and ``step_fused``.

K1 (csrc/step_kernel.cu) replaces ``step_kernel_tpu``
(avbd3d_tpu/solver_tpu.py:863-918) and computes, for one step: symmetric
filter -> precull to the cache width -> 15-axis SAT + warmstart match + row
init -> prediction -> the Jacobi sweeps (eval rows, primal force, 6x6
Hessian rebuilt at cadence block heads, ``solve66_cm``, relaxed pose update,
dual/penalty ramp at block tails, stick) -> velocities, damping, sanitize ->
diagnostics lanes 0-8 and the control lanes on the final poses.  Its plain
version is ``collide_half`` followed by ``solve_half`` and ``control_lanes``.

K2 (csrc/control_lanes.cu) replaces ``control_lanes_tpu``
(solver_tpu.py:261-273); its plain version is ``control_lanes_plain``
(``ops.broadphase.control_lanes`` on a Bodies container).

Each wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``launches`` on each wrapper
counts kernel launches.

The iteration count and the Hessian cadence are runtime arguments (rebuild
at block heads ``it % k == 0``, ramp at block tails and on the last
iteration — the value-identical folded form of solver_tpu.py:586-631), so
every variant ``step_fused`` selects (calm / fresh / boost) goes through
the same kernel.
"""

from __future__ import annotations

import torch

from . import cm
from .config import SolverParams
from .maths import solve66_cm
from .ops import replicated as rep
from .ops.broadphase import control_lanes as control_lanes_math
from .ops.broadphase import gather, symmetric_filter
from .state import Contacts, Diagnostics, World

CACHE_FIELDS = (
    "other", "count", "feature", "r_a", "r_b", "normal",
    "stick", "c0_n", "c0_t1", "c0_t2", "lam", "penalty",
)


def cache_to_args(c: Contacts):
    """Cache leaves as kernel operands (the bool stick latch as float32)."""
    return [getattr(c, f).to(torch.float32) if f == "stick" else getattr(c, f)
            for f in CACHE_FIELDS]


def args_to_cache(args) -> Contacts:
    kw = dict(zip(CACHE_FIELDS, args))
    kw["stick"] = kw["stick"] > 0.5
    return Contacts(**kw)


def _body_dict(b):
    return {
        "pos": tuple(b.pos[k] for k in range(3)),
        "quat": tuple(b.quat[k] for k in range(4)),
        "half": tuple(b.size[k] * 0.5 for k in range(3)),
        "inv_mass": b.inv_mass,
        "friction": b.friction,
    }


def _q_normalize(q):
    msq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]
    bad = msq < 1e-6
    inv = torch.where(bad, 0.0, 1.0 / torch.sqrt(torch.where(bad, 1.0, msq)))
    return tuple(torch.where(bad, float(k == 3), q[k] * inv) for k in range(4))


def _finite3(c):
    return torch.isfinite(c[0]) & torch.isfinite(c[1]) & torch.isfinite(c[2])


def _san(comps, fallback, count):
    """Component-form sanitizeVec3/Quat (solver.cpp:51-66) with a counter."""
    finite = _finite3(comps)
    if len(comps) == 4:
        finite = finite & torch.isfinite(comps[3])
    out = tuple(cm.where(finite, c, f) for c, f in zip(comps, fallback))
    return out, count + torch.sum((~finite).to(torch.float32))


def _world_inertia_comps(quat, diag):
    """World inertia I_w[i][j] = sum_k d_k ax_k[i] ax_k[j] (rigid.cpp:51-59)."""
    axes = cm.q_axes(quat)
    return [
        diag[0] * axes[0][i] * axes[0][j] + diag[1] * axes[1][i] * axes[1][j]
        + diag[2] * axes[2][i] * axes[2][j]
        for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    ]


# ---------------------------------------------------------------------------
# K1, plain version
# ---------------------------------------------------------------------------

def collide_half(old: Contacts, nb_raw, keys, thr, b, params: SolverParams):
    """Symmetric filter + precull + narrowphase + warmstart init (the first
    half of K1; the reference's ``collide_and_init_math``).
    Returns (contacts, kept directed slots () int32, dropped manifolds)."""
    body = _body_dict(b)
    neighbors, kept = symmetric_filter(nb_raw, keys, thr, b.inv_mass > 0.0)
    contacts, dropped = rep.collide_and_init(old, neighbors, body, params)
    return contacts, kept, dropped


def solve_half(params: SolverParams, cache: Contacts, b, n_main: int,
               k_rebuild: int):
    """Phases 3-6 (the second half of K1; the reference's
    ``_kernel_b_math`` for a contact-only scene).

    ``n_main``: main iterations; ``k_rebuild``: Hessian cadence.  Returns
    (pos, quat, linvel, angvel, prev_linvel, prev_angvel, lam, penalty,
    stick (f32), diag (8, 128) with lanes 0-8 filled)."""
    dt = params.dt
    inv_dt2 = 1.0 / (dt * dt)
    iters_end = n_main + (1 if params.post_stabilize else 0)
    relax = params.relaxation
    grav = params.gravity
    g_len = float(sum(x * x for x in grav) ** 0.5)
    ghat = tuple(x / g_len for x in grav) if g_len > 1e-5 else (0.0, 0.0, 0.0)
    k_re = max(1, k_rebuild)

    pos0 = tuple(b.pos[k] for k in range(3))
    quat0 = tuple(b.quat[k] for k in range(4))
    mass, inv_mass = b.mass, b.inv_mass
    inertia = tuple(b.inertia[k] for k in range(3))
    inv_inertia = tuple(b.inv_inertia[k] for k in range(3))
    dyn = inv_mass > 0.0
    dynf = dyn.to(torch.float32)
    san = torch.zeros((), dtype=torch.float32, device=mass.device)

    body = {"pos": pos0, "quat": quat0, "inv_mass": inv_mass,
            "friction": b.friction}
    consts = rep.pair_constants(cache.other, body)

    # ---- phase 3: prediction (solver.cpp:299-337) ----
    lv_in = tuple(b.linvel[k] for k in range(3))
    av_in = tuple(b.angvel[k] for k in range(3))
    plv = tuple(b.prev_linvel[k] for k in range(3))
    lv, san = _san(lv_in, (0.0, 0.0, 0.0), san)
    w_norm = torch.sqrt(cm.length_sq(av_in))
    w_scale = torch.where(
        w_norm > params.max_angular_speed,
        torch.full_like(w_norm, params.max_angular_speed)
        / torch.clamp(w_norm, min=1e-12),
        1.0,
    )
    av = tuple(c * w_scale for c in av_in)
    av, san = _san(av, (0.0, 0.0, 0.0), san)

    ip = tuple(torch.where(dyn, pos0[k] + lv[k] * dt + grav[k] * dt * dt, pos0[k])
               for k in range(3))
    omega = (av[0], av[1], av[2], torch.zeros_like(av[0]))
    oq = cm.q_mul(omega, quat0)
    iq = _q_normalize(tuple(quat0[k] + oq[k] * (0.5 * dt) for k in range(4)))
    iq = tuple(torch.where(dyn, iq[k], quat0[k]) for k in range(4))

    if g_len > 1e-5:
        proj = None
        for k in range(3):
            term = cm.div(lv[k] - plv[k], dt) * ghat[k]
            proj = term if proj is None else proj + term
        aw = torch.clamp(cm.div(proj, g_len), 0.0, 1.0)
        aw = torch.where(torch.isfinite(aw), aw, 0.0)
    else:
        aw = torch.zeros_like(mass)
    ps = tuple(pos0[k] + (lv[k] * dt + grav[k] * (aw * dt * dt)) * dynf
               for k in range(3))
    ps, san = _san(ps, pos0, san)
    qs = iq

    static = rep.geometry_static(cache, consts)

    def geom_at(pos, quat):
        return rep.geometry_pose(cache, static, {"pos": pos, "quat": quat}, consts)

    # ---- phase 4: the iterative solve (solver.cpp:340-431) ----
    pos, quat = ps, qs
    geom = geom_at(ps, qs)
    lam, pen, stick = cache.lam, cache.penalty, cache.stick
    mat = None
    for it in range(iters_end):
        rebuild = it % k_re == 0
        ramp = (it % k_re == k_re - 1) or (it == iters_end - 1)
        if params.post_stabilize:
            alpha_cur = 1.0 if it < n_main else 0.0
        else:
            alpha_cur = params.alpha
        alpha_t = torch.tensor(alpha_cur, dtype=torch.float32, device=mass.device)
        rows = rep.eval_rows(geom, cache, consts, lam, pen, stick, alpha_t, params)
        f = rep.primal_force(rows, pen)
        if rebuild:
            iiw = _world_inertia_comps(quat, inv_inertia)
            m = rep.body_matrix(geom, f, pen, iiw)
            mat = m["m_ll"] + m["m_la"] + m["m_aa"] + m["gyro"]
        m_ll, m_la, m_aa, gyro = mat[:6], mat[6:15], mat[15:21], mat[21:24]
        forces = rep.body_forces(geom, f)

        iw = _world_inertia_comps(quat, inertia)
        rhs_l = [mass * (pos[k] - ip[k]) * inv_dt2 + forces["F"][k] for k in range(3)]
        q_err = cm.q_mul(quat, (-iq[0], -iq[1], -iq[2], iq[3]))
        sgn = torch.where(q_err[3] < 0.0, -2.0, 2.0)
        rot = (q_err[0] * sgn, q_err[1] * sgn, q_err[2] * sgn)
        rhs_a = [
            (iw[0] * rot[0] + iw[1] * rot[1] + iw[2] * rot[2]) * inv_dt2 + forces["T"][0],
            (iw[1] * rot[0] + iw[3] * rot[1] + iw[4] * rot[2]) * inv_dt2 + forces["T"][1],
            (iw[2] * rot[0] + iw[4] * rot[1] + iw[5] * rot[2]) * inv_dt2 + forces["T"][2],
        ]
        m_dt2 = mass * inv_dt2
        a_ll = (m_ll[0] + m_dt2, m_ll[1], m_ll[2], m_ll[3] + m_dt2, m_ll[4],
                m_ll[5] + m_dt2)
        a_aa = (
            m_aa[0] + iw[0] * inv_dt2 + gyro[0],
            m_aa[1] + iw[1] * inv_dt2,
            m_aa[2] + iw[2] * inv_dt2,
            m_aa[3] + iw[3] * inv_dt2 + gyro[1],
            m_aa[4] + iw[4] * inv_dt2,
            m_aa[5] + iw[5] * inv_dt2 + gyro[2],
        )
        dl, da = solve66_cm(a_ll, tuple(m_la), a_aa, tuple(rhs_l), tuple(rhs_a))

        new_pos = tuple(pos[k] - relax * dl[k] * dynf for k in range(3))
        dq = cm.q_mul((da[0] * relax, da[1] * relax, da[2] * relax,
                       torch.zeros_like(da[0])), quat)
        nq = _q_normalize(tuple(quat[k] - 0.5 * dq[k] for k in range(4)))
        nq = tuple(torch.where(dyn, nq[k], quat[k]) for k in range(4))

        geom = geom_at(new_pos, nq)
        rows2 = rep.eval_rows(geom, cache, consts, rows["lam"], pen,
                              rows["stick"], alpha_t, params)
        lam2, pen2, stick2 = rep.dual_update(rows2, geom, pen, params.beta, params)
        do_dual = it < n_main
        lam = lam2 if do_dual else rows2["lam"]
        if do_dual and ramp:
            pen = pen2
        stick = stick2 if do_dual else rows2["stick"]
        pos, quat = new_pos, nq

    pos_f, san = _san(pos, pos0, san)
    quat_f, san = _san(quat, quat0, san)

    # ---- phase 5: velocities + damping (solver.cpp:433-469) ----
    nlv = tuple(torch.where(dyn, cm.div(pos_f[k] - pos0[k], dt) * params.linear_damping,
                            lv_in[k]) for k in range(3))
    dqv = cm.q_mul(quat_f, (-quat0[0], -quat0[1], -quat0[2], quat0[3]))
    vsgn = torch.where(dqv[3] < 0.0, -2.0, 2.0)
    nav = tuple(torch.where(dyn, cm.div(dqv[k] * vsgn, dt) * params.angular_damping,
                            av_in[k]) for k in range(3))
    nlv, san = _san(nlv, (0.0, 0.0, 0.0), san)
    nav, san = _san(nav, (0.0, 0.0, 0.0), san)

    # ---- phase 6: diagnostics (solver.cpp:471-513) ----
    other_dyn = gather(dynf, consts["idx"]) > 0.5
    iota = rep.body_iota(dynf.shape[0], dynf.device)[None]
    once = consts["valid"] & ((iota < consts["idx"]) | ~other_dyn)
    ok, sep = geom["slot_ok"], geom["sep"]
    max_pen = torch.clamp(torch.max(torch.where(ok, -sep, 0.0)), min=0.0)
    max_drift = torch.clamp(
        torch.max(torch.where(ok, params.penetration_slop - sep, 0.0)), min=0.0)
    max_lam_n = torch.clamp(
        torch.max(torch.where(ok, torch.abs(lam[0::3]), 0.0)), min=0.0)
    n_contacts = torch.sum(torch.where(once, cache.count, 0)).to(torch.float32)
    n_manifolds = torch.sum(once & (cache.count > 0)).to(torch.float32)
    n_dyn = torch.sum(dynf)
    max_lin = torch.max(torch.sqrt(cm.length_sq(nlv)) * dynf)
    max_ang = torch.max(torch.sqrt(cm.length_sq(nav)) * dynf)

    diag = torch.zeros((8, 128), dtype=torch.float32, device=mass.device)
    diag[0, :9] = torch.stack([max_pen, max_drift, max_lin, max_ang, max_lam_n,
                               n_contacts, n_manifolds, n_dyn, san])
    return (
        torch.stack(pos_f),
        torch.stack(quat_f),
        torch.stack(nlv),
        torch.stack(nav),
        torch.stack(tuple(torch.where(dyn, lv[k], plv[k]) for k in range(3))),
        torch.stack(tuple(torch.where(dyn, av[k], av_in[k]) for k in range(3))),
        lam,
        pen,
        stick.to(torch.float32),
        diag,
    )


def step_kernel_plain(old: Contacts, nb_raw, keys, thr, b, anchor, anchor_quat,
                      params: SolverParams, n_main: int, k_rebuild: int):
    """Plain version of K1.  Returns (contacts', body leaves (6), diag
    (8, 128)) with the kernel's diag row layout: lanes 0-8 diagnostics,
    9 kept directed slots, 10-14 control lanes, 15 dropped manifolds."""
    new, kept, dropped = collide_half(old, nb_raw, keys, thr, b, params)
    outs = solve_half(params, new, b, n_main, k_rebuild)
    ctrl = control_lanes_math(
        nb_raw,
        tuple(outs[0][k] for k in range(3)),
        tuple(outs[1][k] for k in range(4)),
        tuple(b.size[k] * 0.5 for k in range(3)), b.radius,
        tuple(outs[2][k] for k in range(3)),
        tuple(outs[3][k] for k in range(3)),
        b.inv_mass > 0.0, anchor, anchor_quat, params,
    )
    contacts = new.replace(lam=outs[6], penalty=outs[7], stick=outs[8] > 0.5)
    diag = outs[9]
    diag[0, 9] = kept.to(torch.float32)
    diag[0, 10:15] = ctrl
    diag[0, 15] = dropped.to(torch.float32)
    return contacts, outs[:6], diag


# ---------------------------------------------------------------------------
# Wrappers: plain version on CPU tensors, the kernel on CUDA tensors.
# ---------------------------------------------------------------------------

def step_kernel(old: Contacts, nb_raw, keys, thr, b, anchor, anchor_quat,
                params: SolverParams, n_main: int, k_rebuild: int):
    """K1: phases 2-6 of one contact step plus the end-of-step control
    block.  Returns (contacts', (pos, quat, linvel, angvel, prev_linvel,
    prev_angvel), diag (8, 128))."""
    if b.pos.device.type == "cpu":
        return step_kernel_plain(old, nb_raw, keys, thr, b, anchor, anchor_quat,
                                 params, n_main, k_rebuild)
    from . import kernels

    out = kernels.launch_step(cache_to_args(old), nb_raw, keys, thr, b, anchor,
                              anchor_quat, params, n_main, k_rebuild)
    step_kernel.launches += 1
    cache_out, body_out, diag = out
    return args_to_cache(cache_out), body_out, diag


step_kernel.launches = 0


def control_lanes_plain(nb, b, anchor, anchor_quat, params: SolverParams):
    """Plain version of K2 on the Bodies ``b``."""
    return control_lanes_math(
        nb, tuple(b.pos[k] for k in range(3)), tuple(b.quat[k] for k in range(4)),
        tuple(b.size[k] * 0.5 for k in range(3)), b.radius,
        tuple(b.linvel[k] for k in range(3)), tuple(b.angvel[k] for k in range(3)),
        b.inv_mass > 0.0, anchor, anchor_quat, params)


def control_lanes(nb, b, anchor, anchor_quat, params: SolverParams):
    """K2: the (5,) f32 control block (diagnostics lanes 11-15) on ``b``."""
    if b.pos.device.type == "cpu":
        return control_lanes_plain(nb, b, anchor, anchor_quat, params)
    from . import kernels

    out = kernels.launch_control(nb, b, anchor, anchor_quat, params)
    control_lanes.launches += 1
    return out


control_lanes.launches = 0


def reset_launch_counts() -> None:
    step_kernel.launches = 0
    control_lanes.launches = 0


# ---------------------------------------------------------------------------
# The contact step
# ---------------------------------------------------------------------------

def select_variant(params: SolverParams, stale_ok: bool, calm: bool):
    """(n_main, k_rebuild) for this step — the calm / fresh / boost kernel
    variants of step_pallas (solver_tpu.py:1071-1141) as runtime values."""
    k_re = max(1, params.lhs_rebuild_every)
    k_fr = max(1, params.lhs_fresh_rebuild_every)
    boost = 0 < params.iterations < params.impact_iterations
    n_main = params.iterations
    if boost and not calm:
        n_main = params.impact_iterations
    k = k_re
    if k_re > 1 and not stale_ok and (k_fr != k_re or boost):
        k = k_fr
    return n_main, k


def step_fused(world: World, params: SolverParams, stale_ok: bool,
               calm: bool) -> World:
    """One contact step through K1 (the counterpart of ``step_pallas``).
    ``world.bp`` is the (possibly refreshed) broadphase cache; the gates
    come from the step's one host read (solver.step)."""
    bp = world.bp
    b = world.bodies
    n_main, k = select_variant(params, stale_ok, calm)
    contacts, body_out, diag_v = step_kernel(
        world.contacts, bp.nb, bp.key, bp.thr, b, bp.anchor, bp.anchor_quat,
        params, n_main, k)
    pos, quat, lv, av, plv, pav = body_out
    bodies = b.replace(pos=pos, quat=quat, linvel=lv, angvel=av,
                       prev_linvel=plv, prev_angvel=pav)
    # Kernel row layout -> state layout (solver_tpu.py:1146-1152): lanes
    # 0-8 as is, 9 pair_overflow = cand - kept, 10 degree_overflow =
    # dropped manifolds, 11-15 the control block.
    dv = diag_v[0]
    overflow = bp.cand.to(torch.float32) - dv[9]
    vec = torch.cat([dv[:9], overflow.reshape(1), dv[15:16], dv[10:15]])
    return world.replace(bodies=bodies, contacts=contacts,
                         step_index=world.step_index + 1,
                         diagnostics=Diagnostics(vec=vec))

