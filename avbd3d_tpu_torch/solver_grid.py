"""The grid tier (N > 2048): the gridded collide kernel (K5), the resident
block-Jacobi solve kernel (K6), their plain PyTorch versions, and
``step_grid``.

Port of the reference's gridded large-N backend (avbd3d_tpu/solver_tpu.py:
1168-1817).  The reference grids its kernels over blocks of ``gb * 128``
bodies only because of a TPU compiler ceiling; what it computes is K1's
physics with one semantic change, kept here: a **bounded cross-block pose
lag**.  A step's solver iterations run in launches of
``Capacity.grid_residency``; within a launch, a contact slot whose partner
lies in the same logical block of ``pick_gb(G) * 128`` bodies reads the
partner's current pose, and a partner in another block is read at its
launch-start pose.  Each launch recomputes the geometry and the Hessian
from its start poses (nothing but poses, duals, penalties and stick latches
carries between launches).  The logical blocks have nothing to do with
CUDA's thread blocks.

K5 (``collide_grid``, csrc/grid_kernels.cu ``avbd_collide_grid``) replaces
``collide_and_init_grid`` (solver_tpu.py:1355): symmetric filter, precull,
SAT, warmstart match and row init, plus the kept mask, the once-per-pair
mask and the dropped-manifold count.  K6 (``iterblock_grid``,
``avbd_iterblock_grid``) replaces ``_iterblock_grid_call``
(solver_tpu.py:1614): one launch's iterations.  Around them, the stages
the reference runs in XLA (solver_tpu.py:1683-1817) are kernels of
csrc/grid_stages.cu on the card: ``grid_gates`` (k_grid_gates: the
fall-freeze, the refresh predicate and the unrefined speed gates),
``grid_predict`` (k_grid_predict: the prediction, written in the (C, G, 128)
layout, and the stick latches' float copy) and ``grid_finalize``
(k_grid_finalize: the pose sanitizes, finalize and the 16 diagnostics
lanes).  Their plain versions are the torch stages of ``solver``
(freeze_fallen, stale_lhs_ok, predict, _sanitize, finalize) and the
broadphase's refresh predicate.  Each wrapper runs its plain version for
CPU tensors and launches its kernel or raises for CUDA tensors;
``launches`` on each wrapper counts kernel launches.
"""

from __future__ import annotations

import torch

from . import solver_cuda
from .config import Capacity, SolverParams
from .ops import replicated as rep
from .ops.broadphase import anchor_deviation, gather, reuse_broken, symmetric_filter
from .state import Contacts, Diagnostics, World


def pick_gb(g: int) -> int:
    """Groups of 128 bodies per logical block: the largest of 16 and 8 that
    divides G (solver_tpu.py:1229-1236)."""
    for gb in (16, 8):
        if g % gb == 0:
            return gb
    raise ValueError(f"grid backend needs G divisible by 8, got G={g}")


def grid_specs(params: SolverParams, n_iters: int, k_cad: int, residency: int):
    """Static launch plan (solver_tpu.py:1654-1680): the step's iterations
    chunked into launches of ``residency``, each iteration tagged (alpha,
    do_dual, rebuild, ramp).  Every launch rebuilds the Hessian at its first
    iteration; the penalty ramps at cadence-block tails, at launch tails and
    on the final main iteration."""
    total = n_iters + (1 if params.post_stabilize else 0)
    r = max(1, residency)
    launches = []
    for s in range(0, total, r):
        spec = []
        for j in range(min(r, total - s)):
            it = s + j
            if params.post_stabilize:
                alpha = 1.0 if it < n_iters else 0.0
            else:
                alpha = float(params.alpha)
            do_dual = it < n_iters
            rebuild = (j % k_cad) == 0
            last_in_launch = j + 1 >= min(r, total - s)
            nxt_rebuild = last_in_launch or (((j + 1) % k_cad) == 0)
            ramp = nxt_rebuild or (it == n_iters - 1)
            spec.append((alpha, do_dual, rebuild, ramp))
        launches.append(tuple(spec))
    return tuple(launches)


# ---------------------------------------------------------------------------
# K5: gridded collide
# ---------------------------------------------------------------------------

def collide_grid_plain(old: Contacts, nb_raw, keys, thr, b, params: SolverParams):
    """Plain version of K5 (the reference's ``_collide_grid_math``; the
    block decomposition does not change its values).  Returns (contacts,
    kept mask (D, G, 128) f32, once mask (DC, G, 128) bool, dropped () i32)."""
    dyn = b.inv_mass > 0.0
    neighbors, _ = symmetric_filter(nb_raw, keys, thr, dyn)
    new, dropped = rep.collide_and_init(old, neighbors, solver_cuda.body_tables(b), params)
    once = rep.once_mask(new.other, dyn.to(torch.float32))
    return new, (neighbors >= 0).to(torch.float32), once, dropped


def collide_grid(old: Contacts, nb_raw, keys, thr, b, params: SolverParams, stickf=None):
    """K5; returns what ``collide_grid_plain`` returns.  ``stickf``: the
    old cache's stick latches as 0 / 1 float32 (``grid_predict`` writes
    them); given, the new cache keeps its latches as float32 too, as K6
    takes them."""
    if b.pos.device.type == "cpu":
        new, keptmask, once, dropped = collide_grid_plain(old, nb_raw, keys, thr, b, params)
        if stickf is not None:
            new = new.replace(stick=new.stick.to(torch.float32))
        return new, keptmask, once, dropped
    from . import kernels

    args = solver_cuda.cache_to_args(old) if stickf is None else [
        stickf if f == "stick" else getattr(old, f) for f in solver_cuda.CACHE_FIELDS]
    cache_out, keptmask, once, dropped = kernels.launch_collide_grid(
        args, nb_raw, keys, thr, b, params)
    collide_grid.launches += 1
    new = (solver_cuda.args_to_cache(cache_out) if stickf is None
           else Contacts(**dict(zip(solver_cuda.CACHE_FIELDS, cache_out))))
    return new, keptmask, once, dropped


collide_grid.launches = 0


# ---------------------------------------------------------------------------
# K6: one resident launch of solver iterations
# ---------------------------------------------------------------------------

def iterblock_grid_plain(params: SolverParams, gb: int, spec, contacts: Contacts, b,
                         pos, quat, lam, pen, stickf, ip, iq):
    """Plain version of K6 (the reference's ``_iterblock_grid_call_math``):
    ``len(spec)`` iterations from the launch-start poses ``pos`` (3, G, 128)
    / ``quat`` (4, G, 128), with partners outside a slot's logical block of
    ``gb * 128`` bodies read at their launch-start poses.  Returns (pos,
    quat, lam, pen, stick f32, sep (4, DC, G, 128) of the last dual pass)."""
    blk = gb * 128
    consts = rep.pair_constants(contacts.other,
                                {"inv_mass": b.inv_mass, "friction": b.friction})
    idx = consts["idx"]
    own = rep.body_iota(idx.shape[1], idx.device)[None]
    same = torch.div(idx, blk, rounding_mode="floor") == torch.div(
        own, blk, rounding_mode="floor")
    start_pos = tuple(pos[k] for k in range(3))
    start_quat = tuple(quat[k] for k in range(4))
    lag_pos = rep.gather_comps(start_pos, idx)
    lag_quat = rep.gather_comps(start_quat, idx)

    def partner(p, q):
        return {"pos": tuple(torch.where(same, gather(p[k], idx), lag_pos[k])
                             for k in range(3)),
                "quat": tuple(torch.where(same, gather(q[k], idx), lag_quat[k])
                              for k in range(4))}

    p, q, lam, pen, stick, geom, _, _ = solver_cuda.sweeps(
        params, contacts, b, consts, tuple(ip[k] for k in range(3)),
        tuple(iq[k] for k in range(4)), start_pos, start_quat, lam, pen,
        stickf > 0.5, spec, partner)
    return (torch.stack(p), torch.stack(q), lam, pen, stick.to(torch.float32),
            geom["sep"])


def iterblock_grid(params: SolverParams, gb: int, spec, contacts: Contacts, b,
                   pos, quat, lam, pen, stickf, ip, iq):
    """K6; returns what ``iterblock_grid_plain`` returns."""
    if b.pos.device.type == "cpu":
        return iterblock_grid_plain(params, gb, spec, contacts, b, pos, quat, lam,
                                    pen, stickf, ip, iq)
    from . import kernels

    out = kernels.launch_iterblock_grid(contacts, b, pos, quat, lam, pen, stickf,
                                        ip, iq, params, gb * 128, spec,
                                        plan=solver_cuda.sweep_plan(
                                            b.n, contacts.other.shape[0], gb * 128))
    iterblock_grid.launches += 1
    return out


iterblock_grid.launches = 0


# ---------------------------------------------------------------------------
# The stages around K5 and K6 (csrc/grid_stages.cu)
# ---------------------------------------------------------------------------

def _cg(a, g: int):
    """(N, C) rows -> the (C, G, 128) layout."""
    return a.T.contiguous().reshape(a.shape[1], g, 128)


def grid_gates_plain(world: World, params: SolverParams):
    """Plain version of k_grid_gates: the fall-freeze (``solver.freeze_fallen``
    when ``params.fall_freeze_y`` > -1e8), then on the frozen state the
    refresh predicate (``refresh_needed_plain``'s deviations and bounds) and
    the unrefined speed gates (``stale_lhs_ok(refine=False)`` at
    ``lhs_stale_speed_max`` and at min(impact_speed_min,
    lhs_stale_speed_max)).  Returns (the frozen world, (6,) float32: need,
    stale_ok, calm as 1 / 0, dev_mm, dev_raw, the largest v^2 of a dynamic
    body)."""
    from .solver import dynamic_speed_sq, freeze_fallen

    if params.fall_freeze_y > -1.0e8:
        world = freeze_fallen(world, params)
    b, bp = world.bodies, world.bp
    dev_mm, dev_raw = anchor_deviation(b.pos, b.quat, b.radius, b.dynamic, bp.anchor,
                                       bp.anchor_quat)
    need = reuse_broken(dev_mm, dev_raw, bp.slack, params.bp_margin)
    v2max = torch.max(dynamic_speed_sq(b))
    calm_th = min(params.impact_speed_min, params.lhs_stale_speed_max)
    th = torch.tensor([params.lhs_stale_speed_max**2, calm_th**2], dtype=torch.float32,
                      device=v2max.device)
    flags = torch.stack([need, v2max <= th[0], v2max <= th[1]]).to(torch.float32)
    return world, torch.cat([flags, torch.stack([dev_mm, dev_raw, v2max])])


def grid_gates(world: World, params: SolverParams):
    """k_grid_gates; returns what ``grid_gates_plain`` returns."""
    if world.bodies.pos.device.type == "cpu":
        return grid_gates_plain(world, params)
    from . import kernels

    b, bp = world.bodies, world.bp
    lv, av, im, out = kernels.launch_grid_gates(b, bp.anchor, bp.anchor_quat, bp.slack, params)
    grid_gates.launches += 1
    return world.replace(bodies=b.replace(linvel=lv, angvel=av, inv_mass=im)), out


grid_gates.launches = 0


def grid_predict_plain(b, stick, params: SolverParams):
    """Plain version of k_grid_predict: ``solver.predict`` in the (C, G, 128)
    layout, and the stick latches (4, DC, G, 128) as 0 / 1 float32.  Returns
    (linvel, angvel, ip, iq, ps, stickf, sanitized () int32); ``iq`` is also
    the iterations' start quaternion."""
    from .solver import predict

    linvel, angvel, ipos, iquat, pos_start, _qs, sanitized = predict(b, params)
    g = b.g
    return (_cg(linvel, g), _cg(angvel, g), _cg(ipos, g), _cg(iquat, g), _cg(pos_start, g),
            stick.to(torch.float32), sanitized)


def grid_predict(b, stick, params: SolverParams):
    """k_grid_predict; returns what ``grid_predict_plain`` returns."""
    if b.pos.device.type == "cpu":
        return grid_predict_plain(b, stick, params)
    from . import kernels

    out = kernels.launch_grid_predict(b, stick, params)
    grid_predict.launches += 1
    return out


grid_predict.launches = 0


def grid_finalize_plain(world: World, b, contacts: Contacts, pos, quat, linvel, angvel,
                        sanitized, sep, once, kept, cand, dropped, params: SolverParams) -> World:
    """Plain version of k_grid_finalize: the sanitizes of K6's last poses
    ``pos`` / ``quat`` (C, G, 128) against the step's start, then
    ``solver.finalize`` with the pair overflow ``cand - sum(kept)``.
    ``contacts``: the cache after the step with K6's 0 / 1 float latches;
    ``linvel`` / ``angvel`` / ``sanitized``: the prediction's; ``sep``,
    ``once``, ``kept``, ``dropped``: K6's and K5's.  Returns the world after
    the step."""
    from .solver import _sanitize, finalize

    n = b.n
    overflow = cand - torch.sum(kept).to(torch.int32)
    pos_f, sanitized = _sanitize(pos.reshape(3, n).T, b.pos_n3, sanitized)
    quat_f, sanitized = _sanitize(quat.reshape(4, n).T, b.quat_n4, sanitized)
    contacts = contacts.replace(stick=contacts.stick > 0.5)
    return finalize(world, b, contacts, world.joints, world.springs, pos_f, quat_f, b.pos_n3,
                    b.quat_n4, linvel.reshape(3, n).T, angvel.reshape(3, n).T, contacts.lam,
                    sep, once, overflow, sanitized, params, degree_overflow=dropped)


def grid_finalize(world: World, b, contacts: Contacts, pos, quat, linvel, angvel, sanitized,
                  sep, once, kept, cand, dropped, params: SolverParams) -> World:
    """k_grid_finalize; returns what ``grid_finalize_plain`` returns."""
    if b.pos.device.type == "cpu":
        return grid_finalize_plain(world, b, contacts, pos, quat, linvel, angvel, sanitized,
                                   sep, once, kept, cand, dropped, params)
    from . import kernels

    pos_f, quat_f, lv, av, plv, pav, stick, diag = kernels.launch_grid_finalize(
        b, pos, quat, linvel, angvel, sanitized, contacts, sep, once, kept, cand, dropped,
        params)
    grid_finalize.launches += 1
    bodies = b.replace(pos=pos_f, quat=quat_f, linvel=lv, angvel=av, prev_linvel=plv,
                       prev_angvel=pav)
    return world.replace(bodies=bodies, contacts=contacts.replace(stick=stick),
                         step_index=world.step_index + 1, diagnostics=Diagnostics(vec=diag))


grid_finalize.launches = 0


def reset_launch_counts() -> None:
    collide_grid.launches = 0
    iterblock_grid.launches = 0
    grid_gates.launches = 0
    grid_predict.launches = 0
    grid_finalize.launches = 0


# ---------------------------------------------------------------------------
# The grid step
# ---------------------------------------------------------------------------

def step_grid(world: World, params: SolverParams, cap: Capacity, stale_ok: bool,
              calm: bool) -> World:
    """One step of the grid tier (solver_tpu.step_grid) after its gates
    (``grid_gates``): the prediction, K5, the launches of K6 that
    ``grid_specs`` plans for the cadence ``stale_ok`` / ``calm`` select,
    and the finalize.  ``world.bp`` is the step's (possibly refreshed)
    broadphase cache; contact-only."""
    b = world.bodies
    gb = pick_gb(b.g)
    bp = world.bp
    linvel, angvel, ip, iq, ps, stickf, sanitized = grid_predict(b, world.contacts.stick,
                                                                 params)
    contacts, keptmask, once, dropped = collide_grid(world.contacts, bp.nb, bp.key, bp.thr, b,
                                                     params, stickf=stickf)
    pos, quat, lam, pen, stickf = ps, iq, contacts.lam, contacts.penalty, contacts.stick
    sep = None
    # The grid tier's gates are unrefined (stale_lhs_ok(refine=False)), so
    # calm implies stale_ok and the fused path's variant rule gives exactly
    # the reference's branches (solver_tpu.py:1755-1802).
    n_iters, k = solver_cuda.select_variant(params, stale_ok, calm)
    for spec in grid_specs(params, n_iters, k, cap.grid_residency):
        pos, quat, lam, pen, stickf, sep = iterblock_grid(
            params, gb, spec, contacts, b, pos, quat, lam, pen, stickf, ip, iq)
    if sep is None:   # no launch: the separations stay at their start, 0
        sep = torch.zeros((4,) + contacts.other.shape, dtype=torch.float32, device=pos.device)
    contacts = contacts.replace(lam=lam, penalty=pen, stick=stickf)
    return grid_finalize(world, b, contacts, pos, quat, linvel, angvel, sanitized, sep, once,
                         keptmask, bp.cand, dropped, params)
