"""The AVBD step on PyTorch: gates on the host, the work on the device.

Port of ``avbd3d_tpu/solver.py``'s step driver (the reference).  JAX takes
the step's branches with ``lax.cond`` on device; eager PyTorch needs them on
the host.  Each step therefore makes ONE small device-to-host copy — the
16-lane diagnostics vector plus the broadphase cache's ``slack`` and
``dropped`` — and takes every gate from it: the broadphase refresh, the
ballistic fast path and the Hessian cadence / impact-boost variant.  All
comparisons run in float32 on both sides, as JAX compares an f32 lane
against a weakly typed Python float (a float64 compare would flip a branch
at the boundary).  ``step.host_reads`` counts those copies.

A contact step runs through the fused step kernel (``solver_cuda``); a
contact-free step runs ``_ballistic_step`` (predict/finalize in torch, then
the control-lanes kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from . import cm, solver_cuda
from .config import Capacity, SolverParams
from .maths import quat_conj, quat_mul, quat_normalize, quat_vec_doubled
from .ops.broadphase import refresh_scalar
from .state import World, make_diagnostics

_F32 = np.float32


def read_control(world: World) -> np.ndarray:
    """The step's one host read: diagnostics lanes 0-15, then bp.slack and
    bp.dropped, as one float32 vector."""
    bp = world.bp
    vec = torch.cat([world.diagnostics.vec, bp.slack.reshape(1).to(torch.float32),
                     bp.dropped.reshape(1).to(torch.float32)])
    step.host_reads += 1
    return vec.cpu().numpy()


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


def predict(b, params: SolverParams):
    """Phase 3, inertial prediction (solver.cpp:299-337), on (N, 3) rows.
    Returns (linvel, angvel, inertial_pos, inertial_quat, sanitized)."""
    dt = params.dt
    dev = b.pos.device
    gravity = torch.tensor(params.gravity, dtype=torch.float32, device=dev)
    sanitized = torch.zeros((), dtype=torch.int32, device=dev)
    dyn = b.dynamic.reshape(b.n)

    linvel, sanitized = _sanitize(b.linvel_n3, 0.0, sanitized)
    angvel = _clamp_angular(b.angvel_n3, params.max_angular_speed)
    angvel, sanitized = _sanitize(angvel, 0.0, sanitized)
    pos0, quat0 = b.pos_n3, b.quat_n4
    inertial_pos = torch.where(dyn[:, None], pos0 + linvel * dt + gravity * dt * dt, pos0)
    omega_q = torch.cat([angvel, torch.zeros_like(angvel[:, :1])], dim=-1)
    inertial_quat = quat_normalize(quat0 + quat_mul(omega_q, quat0) * (0.5 * dt))
    inertial_quat = torch.where(dyn[:, None], inertial_quat, quat0)
    return linvel, angvel, inertial_pos, inertial_quat, sanitized


def finalize_ballistic(world: World, pos_f, quat_f, linvel, angvel, sanitized,
                       params: SolverParams) -> World:
    """Phases 5+6 (solver.cpp:433-513) for a step with no contact rows:
    velocities, damping, sanitize, and diagnostics lanes 0-10 (the contact
    lanes are zero: the caller proved the cache empty)."""
    b = world.bodies
    n, g, dt = b.n, b.g, params.dt
    dyn_n = b.dynamic.reshape(n)
    pos0, quat0 = b.pos_n3, b.quat_n4
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

    dyn = b.dynamic
    bodies = b.replace(
        pos=cg(pos_f), quat=cg(quat_f), linvel=cg(new_linvel),
        angvel=cg(new_angvel),
        prev_linvel=torch.where(dyn[None], cg(linvel), b.prev_linvel),
        prev_angvel=torch.where(dyn[None], cg(angvel), b.prev_angvel),
    )
    # Separations are zero in a ballistic step; the slot masks still come
    # from the carried cache, as in the reference's finalize.
    c = world.contacts
    valid = c.other >= 0
    zero = torch.zeros((), dtype=torch.float32, device=b.pos.device)
    max_violation, max_lam_n = zero, zero
    for s in range(4):
        ok = (s < c.count) & valid
        max_violation = torch.maximum(max_violation, torch.max(
            torch.where(ok, params.penetration_slop, 0.0)))
        max_lam_n = torch.maximum(max_lam_n, torch.max(
            torch.where(ok, torch.abs(c.lam[s * 3]), 0.0)))
    diag = make_diagnostics(
        b.pos.device,
        max_constraint_violation=max_violation,
        max_normal_impulse=max_lam_n,
        max_linear_speed=torch.clamp(lin_speed.max(), min=0.0),
        max_angular_speed=torch.clamp(ang_speed.max(), min=0.0),
        dynamic_bodies=torch.sum(dyn_n),
        sanitized=sanitized,
    )
    return world.replace(bodies=bodies, step_index=world.step_index + 1,
                         diagnostics=diag)


def _ballistic_step(world: World, params: SolverParams) -> World:
    """Contact-free step: with zero constraint rows the primal fixed point
    is the inertial target, so the iterative solve is skipped.  The caller
    guarantees (control lane 13) that narrowphase yields no contacts."""
    linvel, angvel, ipos, iquat, sanitized = predict(world.bodies, params)
    out = finalize_ballistic(world, ipos, iquat, linvel, angvel, sanitized, params)
    lanes = solver_cuda.control_lanes(out.bp.nb, out.bodies, out.bp.anchor,
                                      out.bp.anchor_quat, params)
    vec = torch.cat([out.diagnostics.vec[:11], lanes])
    return out.replace(diagnostics=out.diagnostics.replace(vec=vec))


def step(world: World, params: SolverParams, cap: Capacity) -> World:
    """Advance one step (solver.step of the reference, contact-only
    scenes): fall-freeze, scalar-gated broadphase refresh, then the
    ballistic fast path or the fused contact step."""
    if world.joints.dj or world.springs.ds:
        raise NotImplementedError("joints and springs are not ported yet")
    if params.fall_freeze_y > -1.0e8:
        b = world.bodies
        frozen = b.dynamic & (b.pos[1] < params.fall_freeze_y)
        world = world.replace(bodies=b.replace(
            linvel=torch.where(frozen[None], 0.0, b.linvel),
            angvel=torch.where(frozen[None], 0.0, b.angvel),
            inv_mass=torch.where(frozen, 0.0, b.inv_mass),
        ))

    dv = read_control(world)
    bp, refreshed = refresh_scalar(world.bp, dv, world.bodies, world.exclusions,
                                   cap.max_degree, params.bp_margin)
    world = world.replace(bp=bp)

    ballistic_ok = bool(
        params.ballistic
        and _F32(dv[5]) == _F32(0.0)
        and _F32(dv[13]) > _F32(params.collision_margin)
        and not refreshed
        and dv[17] == 0.0
    )
    step.last_gates = {"refreshed": refreshed, "ballistic": ballistic_ok}
    if ballistic_ok:
        return _ballistic_step(world, params)
    stale_ok, calm = control_gates(dv, refreshed, params)
    step.last_gates.update(stale_ok=stale_ok, calm=calm)
    return solver_cuda.step_fused(world, params, stale_ok, calm)


step.host_reads = 0
step.last_gates = {}


def run_steps(world: World, params: SolverParams, cap: Capacity, n_steps: int) -> World:
    """Advance ``n_steps`` steps (a host loop over ``step``)."""
    for _ in range(n_steps):
        world = step(world, params, cap)
    return world
