"""The AVBD step on PyTorch: gates on the host, the work on the device.

Port of ``avbd3d_tpu/solver.py``'s step driver (the reference).  JAX takes
the step's branches with ``lax.cond`` on device; eager PyTorch needs them on
the host, so each step makes ONE small device-to-host copy and takes every
gate from it.  All comparisons run in float32 on both sides, as JAX compares
an f32 lane against a weakly typed Python float (a float64 compare would
flip a branch at the boundary).  ``step.host_reads`` counts those copies.
With ``cap.bp_window`` > 0 a step that refreshes its candidate lists makes
one more, the swept broadphase's guard (counted in
``broadphase.candidate_lists_swept.host_reads``).

``select_path`` is the reference's backend dispatch with ``cap.backend``
honoured:

- the fused path (N <= 2048, with or without joints and springs): the copy
  is the 16-lane diagnostics vector plus the broadphase cache's ``slack``
  and ``dropped``, packed by ``step_gates`` with the fall-freeze (on the
  card one launch of k_step_gates, csrc/fused_stages.cu); it gates the
  broadphase refresh, the ballistic fast path and the Hessian cadence /
  impact-boost variant.  A contact step runs the fused step kernel
  (``solver_cuda``; its joint/spring branch in a jointed world), whose
  diagnostics come out of K1 in the state layout; a contact-free step of a
  world without joints or springs runs ``ballistic_step`` (on the card one
  launch of k_ballistic_step, predict and finalize, then the control-lanes
  kernel into its lanes 11-15).  No torch operation of this path runs on
  the card.
- the grid tier (contact-only, 2048 < N <= 16384, G % 8 == 0): the copy is
  ``solver_grid.grid_gates``' buffer, the refresh predicate and the
  unrefined speed gates (``stale_lhs_ok``) on the state after the
  fall-freeze, which the same call applies (on the card one launch of
  k_grid_gates); the step is ``solver_grid.step_grid``.  No ballistic path,
  as in the reference.
- the portable path ("xla": ``cap.backend == "xla"``, and every scene
  neither of the above covers, as the reference off the TPU): the same
  gates, copy, refresh and ballistic step as the fused path, then
  ``_step_impl``,
  the reference's whole step in torch ops: its phases around K1's plain
  sweeps (``solver_cuda.sweeps``, with the step's seams and each sweep's
  poses sanitized), and the control lanes from K2 (``attach_control``).
  Its gates are taken on the host: the iteration plan
  (``solver_cuda.iteration_plan``) is Python values, where the reference
  computes both sides of ``lax.cond``.  ``gather`` / ``comm``
  are the reference's seams for a body-sharded world (parallel.sharded);
  ``parallel.batched`` runs the same body under ``torch.func.vmap`` with
  the plan's per-world entries as tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cm, solver_cuda, solver_grid
from .comm import LOCAL_COMM
from .config import Capacity, SolverParams
from .maths import quat_conj, quat_mul, quat_normalize, quat_vec_doubled
from .ops import replicated as rep
from .ops.broadphase import control_lanes as control_lanes_math
from .ops.broadphase import gather, refresh_or_reuse, refresh_scalar, symmetric_filter
from .ops.joints import joint_dual_ema, joint_geometry
from .solver_cuda import body_tables
from .state import World, make_diagnostics
from .utils import host_spans

_F32 = np.float32


def control_vector(world: World):
    """The step's control vector: diagnostics lanes 0-15, then bp.slack and
    bp.dropped, as one (18,) float32 tensor on the world's device."""
    bp = world.bp
    return torch.cat([world.diagnostics.vec, bp.slack.reshape(1).to(torch.float32),
                      bp.dropped.reshape(1).to(torch.float32)])


def host_read(vec) -> np.ndarray:
    """The step's one host read: the control vector ``vec`` copied to the
    host (counted in ``step.host_reads``)."""
    step.host_reads += 1
    return vec.cpu().numpy()


def read_control(world: World) -> np.ndarray:
    """``world``'s control vector read to the host (the portable step's
    own read on a body-sharded world)."""
    return host_read(control_vector(world))


def step_gates_plain(world: World, params: SolverParams):
    """Plain version of k_step_gates: the fall-freeze (``freeze_fallen``,
    when ``params.fall_freeze_y`` > -1e8), then the control vector of the
    frozen world.  Returns (world, (18,) float32)."""
    if params.fall_freeze_y > -1.0e8:
        world = freeze_fallen(world, params)
    return world, control_vector(world)


def step_gates(world: World, params: SolverParams):
    """The fused and portable paths' gates before their one host read (the
    reference's fall-freeze, solver.py:325-333, and the read's vector): on
    CUDA tensors one launch of k_step_gates (csrc/fused_stages.cu), the
    frozen fields in new tensors; on CPU tensors ``step_gates_plain``.
    Returns what ``step_gates_plain`` returns."""
    b = world.bodies
    if b.pos.device.type == "cpu":
        return step_gates_plain(world, params)
    from . import kernels

    bp = world.bp
    lv, av, im, out = kernels.launch_step_gates(b, world.diagnostics.vec, bp.slack, bp.dropped,
                                                params)
    step_gates.launches += 1
    return world.replace(bodies=b.replace(linvel=lv, angvel=av, inv_mass=im)), out


step_gates.launches = 0


def control_gates(dv, refreshed: bool, params: SolverParams):
    """(stale_ok, calm) from the carried control block (float32 compares).
    The refined near-speed lane (12) is trusted only when this step reused
    the candidate lists it was computed against."""
    th2 = _F32(params.lhs_stale_speed_max**2)
    stale_ok = bool(_F32(dv[11]) <= th2) or (
        not refreshed and bool(_F32(dv[12]) <= th2))
    calm_th = min(params.impact_speed_min, params.lhs_stale_speed_max)
    calm = bool(_F32(dv[11]) <= _F32(calm_th**2))
    return stale_ok, calm


def _sanitize(x, default, count):
    """NaN/Inf reset-with-counter on (N, C) rows (solver.cpp:41-66)."""
    finite = torch.all(torch.isfinite(x), dim=-1)
    fixed = torch.where(finite[..., None], x, default)
    return fixed, count + torch.sum(~finite).to(torch.int32)


def _clamp_angular(w, max_speed):
    """80 rad/s hard clamp (solver.cpp:85-92)."""
    speed = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    scale = torch.where(speed > max_speed,
                        torch.full_like(speed, max_speed) / torch.clamp(speed, min=1e-12),
                        1.0)
    return w * scale


def stale_lhs_ok(b, bp, params: SolverParams, refine: bool = True):
    """True when the stale-Hessian cadence is safe this step, by reduction
    on the current state (the reference's stale_lhs_ok, solver.py:73-112):
    no dynamic body is faster than ``lhs_stale_speed_max`` or, with
    ``refine``, none of those the broadphase probe (K7,
    ``solver_cuda.bp_probe`` on the cached slots ``bp.nb``) marks as able to
    gain a contact row this step.  The grid tier calls it with
    ``refine=False``; the fused path reads the same predicates from the
    previous step's control lanes.

    A () bool tensor with no host read; the bound compares in float32.  The
    reference runs the probe under ``lax.cond`` only when the global speed
    test fails; eager PyTorch cannot branch on the device, and ``ok_global
    | refined`` has the same value, so the probe launches on every refined
    call."""
    v2 = dynamic_speed_sq(b)
    thresh = torch.tensor(params.lhs_stale_speed_max**2, dtype=torch.float32,
                          device=v2.device)
    ok_global = torch.max(v2) <= thresh
    if not refine:
        return ok_global
    _min_sep, _n_slots, near = solver_cuda.bp_probe(bp.nb, b, params)
    return ok_global | (torch.max(torch.where(near, v2, 0.0)) <= thresh)


def dynamic_speed_sq(b):
    """Each body's |linvel|^2, 0 for a static body ((G, 128) f32)."""
    lv = b.linvel
    return torch.where(b.dynamic, lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2], 0.0)


def attach_control(world: World, params: SolverParams, gather=gather, comm=LOCAL_COMM) -> World:
    """The control block (lanes 11-15) on ``world``'s end-of-step state,
    written into its diagnostics (the reference's attach_control).  One
    shard: K2 (``solver_cuda.control_lanes``, its plain version on CPU
    tensors), also for a batch of worlds (every leaf with a leading batch
    axis: one launch).  A body-sharded world (``comm.n_shards > 1``) takes
    the plain version with ``gather`` and the collectives; K2 folds over
    one device's bodies only."""
    b = world.bodies
    if comm.n_shards == 1:
        lanes = solver_cuda.control_lanes(world.bp.nb, b, world.bp.anchor,
                                          world.bp.anchor_quat, params)
    else:
        lanes = control_lanes_math(
            world.bp.nb, tuple(b.pos[k] for k in range(3)), tuple(b.quat[k] for k in range(4)),
            tuple(b.size[k] * 0.5 for k in range(3)), b.radius,
            tuple(b.linvel[k] for k in range(3)), tuple(b.angvel[k] for k in range(3)),
            b.dynamic, world.bp.anchor, world.bp.anchor_quat, params, gather=gather, comm=comm)
    vec = torch.cat([world.diagnostics.vec[..., :11], lanes], dim=-1)
    return world.replace(diagnostics=world.diagnostics.replace(vec=vec))


def predict(b, params: SolverParams):
    """Phase 3, inertial prediction (solver.cpp:299-337), on (N, 3) rows.
    Returns (linvel, angvel, inertial_pos, inertial_quat, pos_start,
    quat_start, sanitized); ``pos_start`` is the accel-weighted warm start
    of the iterations (the reference's solver.py:220-231)."""
    dt = params.dt
    n = b.n
    dev = b.pos.device
    gravity = torch.tensor(params.gravity, dtype=torch.float32, device=dev)
    sanitized = torch.zeros((), dtype=torch.int32, device=dev)
    dyn = b.dynamic.reshape(n)

    linvel, sanitized = _sanitize(b.linvel_n3, 0.0, sanitized)
    angvel = _clamp_angular(b.angvel_n3, params.max_angular_speed)
    angvel, sanitized = _sanitize(angvel, 0.0, sanitized)
    pos0, quat0 = b.pos_n3, b.quat_n4
    inertial_pos = torch.where(dyn[:, None], pos0 + linvel * dt + gravity * dt * dt, pos0)
    omega_q = torch.cat([angvel, torch.zeros_like(angvel[:, :1])], dim=-1)
    inertial_quat = quat_normalize(quat0 + quat_mul(omega_q, quat0) * (0.5 * dt))
    inertial_quat = torch.where(dyn[:, None], inertial_quat, quat0)

    g_len = float(sum(x * x for x in params.gravity) ** 0.5)
    if g_len > 1e-5:
        accel = cm.div(linvel - b.prev_linvel.reshape(3, n).T, dt)
        ghat = [x / g_len for x in params.gravity]
        projected = accel[:, 0] * ghat[0] + accel[:, 1] * ghat[1] + accel[:, 2] * ghat[2]
        accel_weight = torch.clamp(cm.div(projected, g_len), 0.0, 1.0)
        accel_weight = torch.where(torch.isfinite(accel_weight), accel_weight, 0.0)
    else:
        accel_weight = torch.zeros((n,), dtype=torch.float32, device=dev)
    dynf = dyn[:, None].to(torch.float32)
    pos_start = pos0 + (linvel * dt + gravity[None, :] * (accel_weight[:, None] * dt * dt)) * dynf
    pos_start, sanitized = _sanitize(pos_start, pos0, sanitized)
    return linvel, angvel, inertial_pos, inertial_quat, pos_start, inertial_quat, sanitized


def finalize(world: World, b, contacts, joints, springs, pos_f, quat_f, pos0, quat0,
             linvel, angvel, lam_c, sep_slots, once, overflow, sanitized,
             params: SolverParams, comm=LOCAL_COMM, degree_overflow=0) -> World:
    """Phases 5+6 (solver.cpp:433-513; the reference's solver.py:234-317):
    velocities, damping, sanitize, and diagnostics lanes 0-10 with the
    control lanes 11-15 at CONTROL_RESET.  ``sep_slots`` (4, D, G, 128): raw
    separations at the final poses; ``once`` (D, G, 128): one replica per
    pair, for counting; ``comm``: on a body-sharded world the diagnostics
    are all-reduced so that every shard carries the global values."""
    n, g, dt = b.n, b.g, params.dt
    dyn = b.dynamic
    dyn_n = dyn.reshape(n)
    new_linvel = cm.div(pos_f - pos0, dt) * params.linear_damping
    delta_q = quat_mul(quat_f, quat_conj(quat0))
    new_angvel = cm.div(quat_vec_doubled(delta_q), dt) * params.angular_damping
    new_linvel = torch.where(dyn_n[:, None], new_linvel, b.linvel_n3)
    new_angvel = torch.where(dyn_n[:, None], new_angvel, b.angvel_n3)
    new_linvel, sanitized = _sanitize(new_linvel, 0.0, sanitized)
    new_angvel, sanitized = _sanitize(new_angvel, 0.0, sanitized)
    lin_speed = torch.linalg.vector_norm(new_linvel, dim=-1) * dyn_n
    ang_speed = torch.linalg.vector_norm(new_angvel, dim=-1) * dyn_n

    def cg(a):
        return a.T.contiguous().reshape(a.shape[1], g, 128)

    bodies = b.replace(
        pos=cg(pos_f), quat=cg(quat_f), linvel=cg(new_linvel),
        angvel=cg(new_angvel),
        prev_linvel=torch.where(dyn[None], cg(linvel), b.prev_linvel),
        prev_angvel=torch.where(dyn[None], cg(angvel), b.prev_angvel),
    )
    s4 = torch.arange(4, device=b.pos.device).reshape(4, 1, 1, 1)
    ok = (s4 < contacts.count[None]) & (contacts.other >= 0)[None]
    max_pen = torch.max(torch.where(ok, -sep_slots, 0.0))
    max_violation = torch.max(torch.where(ok, params.penetration_slop - sep_slots, 0.0))
    max_lam_n = torch.max(torch.where(ok, torch.abs(lam_c[0::3]), 0.0))
    diag = make_diagnostics(
        b.pos.device,
        max_penetration=comm.pmax(torch.clamp(max_pen, min=0.0)),
        max_constraint_violation=comm.pmax(torch.clamp(max_violation, min=0.0)),
        max_linear_speed=comm.pmax(torch.clamp(lin_speed.max(), min=0.0)),
        max_angular_speed=comm.pmax(torch.clamp(ang_speed.max(), min=0.0)),
        max_normal_impulse=comm.pmax(torch.clamp(max_lam_n, min=0.0)),
        active_contacts=comm.psum(torch.sum(torch.where(once, contacts.count, 0))),
        active_manifolds=comm.psum(torch.sum(once & (contacts.count > 0))),
        dynamic_bodies=comm.psum(torch.sum(dyn_n)),
        pair_overflow=overflow,
        degree_overflow=comm.psum(degree_overflow),
        sanitized=comm.psum(sanitized),
    )
    return world.replace(bodies=bodies, contacts=contacts, joints=joints, springs=springs,
                         step_index=world.step_index + 1, diagnostics=diag)


def _ballistic_body(world: World, params: SolverParams) -> World:
    """Contact-free step without its control lanes: with zero constraint
    rows the primal fixed point is the inertial target, so the iterative
    solve is skipped.  The caller guarantees (control lane 13) that
    narrowphase yields no contacts."""
    b = world.bodies
    linvel, angvel, ipos, iquat, _ps, _qs, sanitized = predict(b, params)
    c = world.contacts
    sep = torch.zeros((4,) + c.other.shape, dtype=torch.float32, device=b.pos.device)
    once = torch.zeros(c.other.shape, dtype=torch.bool, device=b.pos.device)
    return finalize(world, b, c, world.joints, world.springs, ipos, iquat, b.pos_n3, b.quat_n4,
                    linvel, angvel, c.lam, sep, once, 0, sanitized, params)


def _ballistic_step(world: World, params: SolverParams) -> World:
    """The ballistic fast path's plain version: ``_ballistic_body``, then
    K2's lanes (``attach_control``)."""
    return attach_control(_ballistic_body(world, params), params)


def ballistic_step(world: World, params: SolverParams) -> World:
    """The ballistic fast path (the reference's _ballistic_step,
    solver.py:418-447).  On CUDA tensors one launch of k_ballistic_step
    (csrc/fused_stages.cu: ``_ballistic_body``'s predict and finalize, the
    16 lanes with the control block at CONTROL_RESET), then K2 writing
    lanes 11-15 into that vector; on CPU tensors ``_ballistic_step``."""
    b = world.bodies
    if b.pos.device.type == "cpu":
        return _ballistic_step(world, params)
    from . import kernels

    pos, quat, lv, av, plv, pav, vec = kernels.launch_ballistic_step(b, world.contacts, params)
    ballistic_step.launches += 1
    bodies = b.replace(pos=pos, quat=quat, linvel=lv, angvel=av, prev_linvel=plv,
                       prev_angvel=pav)
    bp = world.bp
    solver_cuda.control_lanes(bp.nb, bodies, bp.anchor, bp.anchor_quat, params, out=vec[11:])
    return world.replace(bodies=bodies, step_index=world.step_index + 1,
                         diagnostics=world.diagnostics.replace(vec=vec))


ballistic_step.launches = 0


def _step_body(world: World, params: SolverParams, cap: Capacity, plan, gather=gather,
               comm=LOCAL_COMM) -> World:
    """Phases 1-6 of the portable step (the reference's solver.py:491-768)
    on ``world.bp`` as given, one sweep per ``plan`` entry (alpha, do_dual,
    rebuild, ramp, active), without the control lanes (``attach_control``).
    The prediction and the sweeps are K1's plain ones
    (``solver_cuda.predict_cm``, ``sweeps``) with this step's seams and each
    sweep's poses sanitized, so that on one device the poses are the fused
    step's; each plan entry is a Python
    value or, under ``torch.func.vmap``, a per-world tensor, and ``active``
    False freezes the world's carry (it has passed its own last
    iteration)."""
    b = world.bodies
    n, g = b.n, b.g
    dev = b.pos.device
    tables = body_tables(b)
    sharded = comm.n_shards > 1
    own_iota = rep.body_iota(g, dev) + comm.row0(n) if sharded else None

    # Phase 1: the symmetric filter of the (refreshed) candidate lists.
    bp = world.bp
    neighbors, kept = symmetric_filter(bp.nb, bp.key, bp.thr, b.dynamic, gather,
                                       own_iota=own_iota,
                                       n_total=n * comm.n_shards if sharded else None)
    overflow = bp.cand - comm.psum(kept)

    # Phase 2: narrowphase, warmstart and decay (solver.cpp:273-296).
    contacts, man_dropped = rep.collide_and_init(world.contacts, neighbors, tables, params,
                                                 gather, own_iota)
    rows = solver_cuda.row_state(world.joints, world.springs, cap.joint_colors, params)
    joints = rows.joints if rows is not None and rows.joints is not None else world.joints
    springs = rows.springs if rows is not None and rows.springs is not None else world.springs
    consts = rep.pair_constants(contacts.other, tables, gather)

    # Phase 3: inertial prediction (solver.cpp:299-337), K1's.
    linvel, angvel, ipos, iquat, pos_start, sanitized = solver_cuda.predict_cm(b, params)

    def row_form(c):
        return torch.stack(c, dim=-1).reshape(n, len(c))

    # Phase 4: the iterative solve (solver.cpp:340-431).
    pos, quat, lam_c, pen_c, stick, _geom, jout, sanitized = solver_cuda.sweeps(
        params, contacts, b, consts, ipos, iquat, pos_start, iquat, contacts.lam,
        contacts.penalty, contacts.stick, plan, rows=rows, gather=gather, own_iota=own_iota,
        san=sanitized)

    # The slow once-per-step joint dual tracker (ops/joints.joint_dual_ema).
    if jout is not None:
        lam_j, pen_j = jout
        if params.joint_ema_rate > 0.0:
            jgeom_f = joint_geometry(joints, {"pos": pos, "quat": quat}, gather)
            lam_j = joint_dual_ema(jgeom_f, joints, lam_j, pen_j, params)
        joints = joints.replace(lam=lam_j, penalty=pen_j)
    contacts = contacts.replace(lam=lam_c, penalty=pen_c, stick=stick)

    # Phases 5+6 on the final poses; each pair counted at one replica.
    geom_f = rep.eval_geometry(contacts, {"pos": pos, "quat": quat}, consts, gather, own_iota)
    once = rep.once_mask(contacts.other, b.dynamic.to(torch.float32), gather, own_iota)
    return finalize(world, b, contacts, joints, springs, row_form(pos), row_form(quat),
                    b.pos_n3, b.quat_n4, row_form(linvel), row_form(angvel), lam_c,
                    geom_f["sep"], once, overflow, sanitized, params, comm=comm,
                    degree_overflow=man_dropped)


def plan_for(params: SolverParams, control, refreshed: bool):
    """The portable step's sweep plan from the host copy ``control``: the
    gates (``control_gates``), the calm / fresh / boost variant
    (``solver_cuda.select_variant``), one (alpha, do_dual, rebuild, ramp,
    active) per sweep."""
    stale_ok, calm = control_gates(control, refreshed, params)
    n_main, k = solver_cuda.select_variant(params, stale_ok, calm)
    return [e + (True,) for e in solver_cuda.iteration_plan(params, n_main, k)]


def _step_impl(world: World, params: SolverParams, cap: Capacity, gather=gather,
               comm=LOCAL_COMM, refreshed=None, control=None) -> World:
    """The portable whole step (the reference's _step_impl, solver.py:450-769).

    ``refreshed`` None: make the step's one host read (``read_control``)
    and run the scalar-gated broadphase refresh here, as the sharded path
    needs; otherwise the caller (``step``) did both and passes the host copy
    as ``control``.  ``gather`` / ``comm``: the seams of a body-sharded
    world (parallel.sharded); every gate comes from all-reduced values, so
    every shard takes the same branches."""
    if refreshed is None:
        control = read_control(world)
        bp, refreshed = refresh_scalar(world.bp, control, world.bodies, world.exclusions,
                                       cap.max_degree, params.bp_margin, comm,
                                       0 if comm.n_shards > 1 else cap.bp_window)
        world = world.replace(bp=bp)
    out = _step_body(world, params, cap, plan_for(params, control, refreshed), gather, comm)
    return attach_control(out, params, gather, comm)


def ballistic_ok(params: SolverParams, world: World, control, refreshed: bool) -> bool:
    """The ballistic fast path's gate (the reference's solver.py:397-411,
    ``ballistic_able`` off the TPU): no joints or springs, the previous step
    ended without contacts, its control block proves none at these poses
    (lane 13), no refresh and no slot dropped by the refresh."""
    return bool(
        params.ballistic
        and world.joints.dj == 0
        and world.springs.ds == 0
        and _F32(control[5]) == _F32(0.0)
        and _F32(control[13]) > _F32(params.collision_margin)
        and not refreshed
        and control[17] == 0.0
    )


def select_path(world: World, cap: Capacity) -> str:
    """Backend dispatch (the reference's solver.py:334-372) with
    ``cap.backend`` honoured.  "auto": N <= 2048 takes the fused path
    ("fused"), a contact-only scene with N <= 16384 and G % 8 == 0 the grid
    tier ("grid"); "pallas" forces the fused path and "grid" the grid tier,
    each raising the reference's ValueError on a scene it does not cover;
    "xla" forces the portable path ("xla"), which "auto" also takes for
    every scene neither covers (a jointed world above 2048 bodies, a
    contact-only one above 16384 bodies or with G % 8 != 0), as the
    reference does off the TPU.  ``cap.bp_window`` > 0 takes the same
    path; every refresh on it is the swept broadphase
    (``broadphase.candidate_lists_swept``), but a body-sharded world's
    (``parallel.sharded``), which keeps the matrix."""
    b = world.bodies
    supports_fused = b.n <= 2048
    supports_grid = (b.n <= 16384 and b.g % 8 == 0 and world.joints.dj == 0
                     and world.springs.ds == 0)
    if cap.backend == "xla":
        return "xla"
    if cap.backend == "pallas":
        if not supports_fused:
            raise ValueError(
                "backend='pallas' forced on an unsupported scene "
                f"(n={b.n}); the Pallas path covers scenes "
                "with <= 2048 bodies (Mosaic compile ceiling)")
        return "fused"
    if cap.backend == "grid":
        if not supports_grid:
            raise ValueError(
                "backend='grid' needs a contact-only scene with <= 16384 bodies "
                f"and G % 8 == 0 (n={b.n}, G={b.g})")
        return "grid"
    if cap.backend != "auto":
        raise ValueError(f"unknown backend {cap.backend!r}")
    if supports_fused:
        return "fused"
    if supports_grid:
        return "grid"
    return "xla"


def _grid_step(world: World, params: SolverParams, cap: Capacity) -> World:
    """The grid tier: the fall-freeze and the gates (``solver_grid.grid_gates``)
    and their one host read, the broadphase refresh or reuse, then
    ``solver_grid.step_grid``; each in its span (``utils.host_spans``)."""
    t = host_spans.begin("gates")
    world, gates = solver_grid.grid_gates(world, params)
    t = host_spans.switch("gates", t, "read")
    step.host_reads += 1
    refreshed, stale_ok, calm = (v != 0.0 for v in gates.cpu().tolist()[:3])
    t = host_spans.switch("read", t, "refresh")
    b = world.bodies
    bp, _ = refresh_or_reuse(world.bp, refreshed, b, world.exclusions,
                             cap.max_degree, params.bp_margin, window=cap.bp_window)
    t = host_spans.switch("refresh", t, "decide")
    step.last_gates = {"refreshed": refreshed, "stale_ok": stale_ok, "calm": calm}
    t = host_spans.switch("decide", t, "path")
    world = solver_grid.step_grid(world.replace(bp=bp), params, cap, stale_ok, calm)
    host_spans.end("path", t)
    return world


def step(world: World, params: SolverParams, cap: Capacity) -> World:
    """Advance one step (solver.step of the reference): fall-freeze, then
    the grid tier or, on the fused and portable paths, the scalar-gated
    broadphase refresh and the ballistic fast path (worlds without joints or
    springs only, as the reference's ``ballistic_able``,
    ``ballistic_step``) or the fused step (``solver_cuda.step_fused``) or
    the portable one (``_step_impl``).  ``step.last_path`` names the path
    taken; the grid tier applies the fall-freeze with its gates, the others
    with ``step_gates``.  The host's time goes into ``utils.host_spans``:
    ``step``, and inside it ``gates``, ``read`` (the host read), ``refresh``,
    ``decide`` (the gates on the host copy) and ``path``."""
    t0 = host_spans.begin("step")
    world = _step(world, params, cap)
    host_spans.end("step", t0)
    return world


def _step(world: World, params: SolverParams, cap: Capacity) -> World:
    """``step`` inside its ``step`` span."""
    step.last_path = select_path(world, cap)
    if step.last_path == "grid":
        return _grid_step(world, params, cap)
    t = host_spans.begin("gates")
    world, control = step_gates(world, params)
    t = host_spans.switch("gates", t, "read")
    dv = host_read(control)
    t = host_spans.switch("read", t, "refresh")
    bp, refreshed = refresh_scalar(world.bp, dv, world.bodies, world.exclusions,
                                   cap.max_degree, params.bp_margin, window=cap.bp_window)
    world = world.replace(bp=bp)
    t = host_spans.switch("refresh", t, "decide")
    ballistic = ballistic_ok(params, world, dv, refreshed)
    step.last_gates = {"refreshed": refreshed, "ballistic": ballistic}
    if ballistic:
        t = host_spans.switch("decide", t, "path")
        world = ballistic_step(world, params)
    else:
        stale_ok, calm = control_gates(dv, refreshed, params)
        step.last_gates.update(stale_ok=stale_ok, calm=calm)
        t = host_spans.switch("decide", t, "path")
        if step.last_path == "xla":
            world = _step_impl(world, params, cap, refreshed=refreshed, control=dv)
        else:
            world = solver_cuda.step_fused(world, params, cap, stale_ok, calm)
    host_spans.end("path", t)
    return world


def freeze_fallen(world: World, params: SolverParams) -> World:
    """The fall-freeze pre-pass (config.fall_freeze_y): bodies below it
    become static with zeroed velocities."""
    b = world.bodies
    frozen = b.dynamic & (b.pos[1] < params.fall_freeze_y)
    return world.replace(bodies=b.replace(
        linvel=torch.where(frozen[None], 0.0, b.linvel),
        angvel=torch.where(frozen[None], 0.0, b.angvel),
        inv_mass=torch.where(frozen, 0.0, b.inv_mass),
    ))


step.host_reads = 0
step.last_gates = {}
step.last_path = None


def run_steps(world: World, params: SolverParams, cap: Capacity, n_steps: int) -> World:
    """Advance ``n_steps`` steps (a host loop over ``step``)."""
    for _ in range(n_steps):
        world = step(world, params, cap)
    return world
