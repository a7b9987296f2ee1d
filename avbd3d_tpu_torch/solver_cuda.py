"""The step on the card: the fused step kernel (K1, with its joint/spring
branch), the control-lanes kernel (K2), the collide (K3) and solve-loop (K4)
entry points the profiler times, their plain PyTorch versions, and
``step_fused``.

K1 (csrc/step_kernel.cu) replaces ``step_kernel_tpu``
(avbd3d_tpu/solver_tpu.py:863-918) and computes, for one step: symmetric
filter -> precull to the cache width -> 15-axis SAT + warmstart match + row
init -> prediction -> the Jacobi sweeps (eval rows, primal force, 6x6
Hessian rebuilt at cadence block heads, ``solve66_cm``, relaxed pose update,
dual/penalty ramp at block tails, stick) -> velocities, damping, sanitize ->
diagnostics lanes 0-8 and the control lanes on the final poses.  Its plain
version is ``collide_half`` followed by ``solve_half`` and ``control_lanes``.
With joints or springs (dj / ds > 0) it decays their rows before the
prediction, solves each sweep in ``n_colors`` Gauss-Seidel colour sub-passes
that add the joint and spring terms at the newest poses, runs the joint dual
after the contact dual and the slow joint dual tracker on the final poses
(the reference's ``_kernel_b_math`` with joints).  K1 reads and writes the
cache's bool stick latches itself and, from the refresh's ``cand``, also
writes the step's 16 diagnostics lanes in the state layout (its diag row
1), which ``step_fused`` hands on as they are.

K3 (``collide_and_init``) and K4 (``solve_loop``) replace
``collide_and_init_tpu`` (solver_tpu.py:151-168) and ``solve_loop_tpu``
(921-954): K1's two halves as separate launches, used only by the profiler
(utils/profile_cuda.py); their plain versions are ``collide_half`` and
``solve_loop_plain``.

K2 (csrc/control_lanes.cu, one launch of ``k_control_lanes``: a warp per
body, the last block folds) replaces ``control_lanes_tpu``
(solver_tpu.py:261-273); its plain version is ``control_lanes_plain``
(``ops.broadphase.control_lanes`` on a Bodies container).

K7 (csrc/bp_probe.cu, one launch of ``k_probe``: a warp per body, the last
block folds) replaces ``bp_probe_tpu`` (solver_tpu.py:206-225), the probe
behind the refined stale-Hessian gate (``solver.stale_lhs_ok``); its plain
version is ``bp_probe_plain`` (``ops.broadphase.bp_probe``).

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

import dataclasses

import torch

from . import cm
from .config import Capacity, SolverParams
from .maths import solve66_cm
from .ops import broadphase
from .ops import replicated as rep
from .ops.broadphase import bp_probe as bp_probe_math
from .ops.broadphase import control_lanes as control_lanes_math
from .ops.broadphase import gather, symmetric_filter
from .ops.joints import (joint_accumulate, joint_decay, joint_dual, joint_dual_ema,
                         joint_force, joint_geometry)
from .ops.springs import spring_accumulate, spring_decay, spring_force, spring_geometry
from .state import Contacts, Diagnostics, World

CACHE_FIELDS = (
    "other", "count", "feature", "r_a", "r_b", "normal",
    "stick", "c0_n", "c0_t1", "c0_t2", "lam", "penalty",
)


# ---------------------------------------------------------------------------
# The sweep plan: how the sweep kernels of K1, K4 and K6 divide a shape
# ---------------------------------------------------------------------------

MAX_THREADS = 1024          # threads of a thread block
MAX_SMEM_BYTES = 232448     # dynamic shared memory a block may opt into (227 KB)
MAX_CLUSTER = 16            # blocks of a thread-block cluster on the H100
H100_SMS = 132              # streaming multiprocessors: blocks a grid barrier can hold, one each
N_PARTIALS = 30             # a slot's partial sums: F (3), T (3), 24 Hessian terms
ROW_TERMS = 27              # a joint or spring slot's terms in a sub-pass: F, T, 21 Hessian
MAX_RESIDENT_ITERS = 64     # sweeps of one resident launch


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """How the tiled sweep kernels run a shape (csrc/step_kernel.cuh).  A
    thread block owns ``tile`` bodies with ``threads`` = tile x lanes
    threads; thread (lane, body) takes the cache slots lane, lane + lanes,
    ... (``slots_per_thread`` at most); ``smem_bytes``: the block's partial
    sums (N_PARTIALS x DC x tile floats; with rows, ROW_TERMS x (DJ + DS) x
    tile where that is more) and folded force / torque (6 x tile).
    ``cluster`` > 0: the sweeps of a logical block of tile x cluster bodies
    run in one launch of thread-block clusters of that size (with joint or
    spring rows: the world is one cluster); ``grid``: the sweeps of a world
    with rows run in one cooperative launch with a grid barrier; neither:
    one launch per half-sweep."""

    tile: int
    threads: int
    slots_per_thread: int
    smem_bytes: int
    cluster: int
    grid: int = 0

    @property
    def route(self) -> str:
        if self.grid:
            return "grid"
        return "cluster" if self.cluster > 0 else "launches"


def _tile_shape(tile: int, dc: int, rows: int = 0):
    """Threads, slots per thread and shared memory of a ``tile``-body block
    for ``dc`` cache slots and ``rows`` joint and spring slots a body: the
    contact partials, or a sub-pass's row terms where they are more, then the
    folded force / torque."""
    spt = -(-dc * tile // MAX_THREADS)
    lanes = -(-dc // spt)
    return lanes * tile, spt, 4 * (max(N_PARTIALS * dc, ROW_TERMS * rows) + 6) * tile


def sweep_plan(n: int, dc: int, blk: int = None, dj: int = 0, ds: int = 0) -> SweepPlan:
    """The route of the sweep kernels for ``n`` bodies (a multiple of 128),
    ``dc`` cache slots, logical blocks of ``blk`` bodies (the whole world by
    default: K1 and K4) and ``dj`` / ``ds`` joint and spring slots.

    A world with joint or spring rows: every sweep of a step in one resident
    launch (``k_joint_sweeps``) with a barrier over the whole world between
    colour sub-passes, in tiles of 32 bodies, or 16 where a 32-body tile
    would take more than 512 threads (DC > 16), so that a thread keeps 128
    registers.  Where the world is at most MAX_CLUSTER tiles the launch is
    one cluster and the barrier the cluster's (measured faster than the
    grid barrier at RodJointed and SoftGrid, PERF.md section 6); otherwise a
    cooperative launch with a grid barrier, whose blocks must all be
    resident: at most one per SM.  A contact-only world: cluster-resident sweeps where a
    logical block fits one cluster: the smallest tile of 32 and 64 bodies with
    blk / tile <= MAX_CLUSTER whose block fits the thread and shared-memory
    limits.  Tiles of 64 bodies only where several logical blocks run side by
    side (the grid tier): a lone cluster of 16 such blocks holds a whole
    1024-body world on 16 of the card's 132 SMs, and measured slower on the
    card than launches of 32-body tiles (PERF.md section 6).  Otherwise one
    launch per half-sweep with tiles of 32 bodies (the most blocks).
    Decided by shape alone, before any launch."""
    blk = n if blk is None else blk
    if n <= 0 or n % 128 or dc < 1:
        raise ValueError(f"need N a positive multiple of 128 and DC >= 1, got N={n}, DC={dc}")
    if blk <= 0 or n % blk or blk % 128:
        raise ValueError(f"logical block of {blk} bodies does not divide N={n} in groups of 128")
    if dj == 0 and ds == 0:
        for tile in (32, 64):
            threads, spt, smem = _tile_shape(tile, dc)
            fills_card = tile == 32 or n // blk > 1
            if blk // tile <= MAX_CLUSTER and smem <= MAX_SMEM_BYTES and fills_card:
                return SweepPlan(tile, threads, spt, smem, blk // tile)
    threads, spt, smem = _tile_shape(32, dc)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"cache width DC={dc} does not fit a block's shared memory")
    if dj == 0 and ds == 0:
        return SweepPlan(32, threads, spt, smem, 0)
    tile = 32 if threads <= 512 else 16
    threads, spt, smem = _tile_shape(tile, dc, dj + ds)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{dj + ds} joint and spring slots do not fit a block's shared memory")
    blocks = n // tile
    if blocks <= MAX_CLUSTER:
        return SweepPlan(tile, threads, spt, smem, blocks)
    if blocks > H100_SMS:
        raise ValueError(f"N={n}: {blocks} blocks of {tile} bodies cannot all be resident for "
                         f"the grid barrier of the joint rows (at most {H100_SMS})")
    return SweepPlan(tile, threads, spt, smem, 0, 1)


def step_kernel_count(plan: SweepPlan, iters_end: int, dj: int = 0, ds: int = 0) -> int:
    """Kernels one K1 call of ``iters_end`` sweeps queues under ``plan``
    (copies and memsets not counted): filter, collide, predict, final body
    and final reduce, plus the sweeps by route: one resident launch per
    MAX_RESIDENT_ITERS sweeps (with joints also the dual tracker after the
    final body, and the colour sub-passes inside the resident launch), or
    the geometry and two launches per sweep."""
    resident = max(1, -(-iters_end // MAX_RESIDENT_ITERS))
    if dj or ds:
        return 5 + resident + (1 if dj else 0)    # the tracker with joint_ema_rate > 0
    if plan.cluster > 0:
        return 5 + resident
    return 6 + 2 * iters_end


def iterblock_kernel_count(plan: SweepPlan, n_iters: int) -> int:
    """Kernels one K6 call queues under ``plan`` (copies not counted): one
    resident launch, or the geometry and two launches per iteration."""
    return 1 if plan.cluster > 0 else 1 + 2 * n_iters


def cache_leaves(c: Contacts):
    """The cache's leaves in CACHE_FIELDS order, as K1 takes them (the stick
    latches the cache's own bools)."""
    return [getattr(c, f) for f in CACHE_FIELDS]


def cache_to_args(c: Contacts):
    """Cache leaves as the operands of K3, K4 and K5 (the bool stick latch
    as float32)."""
    return [getattr(c, f).to(torch.float32) if f == "stick" else getattr(c, f)
            for f in CACHE_FIELDS]


def args_to_cache(args) -> Contacts:
    kw = dict(zip(CACHE_FIELDS, args))
    kw["stick"] = kw["stick"] > 0.5
    return Contacts(**kw)


def body_tables(b):
    """Body state as (G, 128) component tables for the replicated core."""
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
    body = body_tables(b)
    neighbors, kept = symmetric_filter(nb_raw, keys, thr, b.inv_mass > 0.0)
    contacts, dropped = rep.collide_and_init(old, neighbors, body, params)
    return contacts, kept, dropped


@dataclasses.dataclass(frozen=True)
class RowState:
    """The joint and spring rows of a jointed step: the decayed containers
    (None where the world has none), the carried joint duals, the springs'
    step-constant penalty and the number of colour sub-passes."""

    joints: object
    springs: object
    j_lam: object
    j_pen: object
    s_pen: object
    n_colors: int


def row_state(joints, springs, n_colors: int, params: SolverParams):
    """Joint/spring decay before prediction (_kernel_b_math 343-351);
    None for a contact-only world."""
    has_j = joints is not None and joints.dj > 0
    has_s = springs is not None and springs.ds > 0
    if not (has_j or has_s):
        return None
    joints = joint_decay(joints, params) if has_j else None
    springs = spring_decay(springs, params) if has_s else None
    return RowState(joints, springs, joints.lam if has_j else None,
                    joints.penalty if has_j else None,
                    springs.penalty if has_s else None,
                    n_colors if has_j else 1)


def _add_rows(rhs_l, rhs_a, a_ll, a_la, a_aa, acc):
    """Add one row family's accumulated force and Hessian terms."""
    for k in range(3):
        rhs_l[k] = rhs_l[k] + acc["F"][k]
        rhs_a[k] = rhs_a[k] + acc["T"][k]
    for k in range(6):
        a_ll[k] = a_ll[k] + acc["m_ll"][k]
        a_aa[k] = a_aa[k] + acc["m_aa"][k]
    for k in range(9):
        a_la[k] = a_la[k] + acc["m_la"][k]


def _and(a, b):
    """``a & b`` for plan entries that are Python bools or bool tensors."""
    if a is False or b is False:
        return False
    if a is True:
        return b
    return a if b is True else a & b


def _sel(c, a, b):
    """``torch.where(c, a, b)`` for a plan entry ``c``; a Python bool picks
    a side without computing anything."""
    if c is True:
        return a
    if c is False:
        return b
    return torch.where(c, a, b)


def sweeps(params: SolverParams, cache: Contacts, b, consts, ip, iq, pos, quat,
           lam, pen, stick, plan, partner=None, rows: RowState = None, gather=gather,
           own_iota=None, san=None):
    """The sweeps of phase 4 (solver.cpp:340-431), one per entry (alpha,
    do_dual, rebuild, ramp[, active]) of ``plan``: contact rows and primal
    force at the current geometry, the 6x6 Hessian (rebuilt where
    ``rebuild``, and always on the first sweep: nothing carries in), then
    the primal solve and relaxed pose update, then geometry at the new poses
    and the dual update (penalty ramped where ``do_dual`` and ``ramp``).
    Geometry starts at ``pos``/``quat``.  ``partner(pos, quat)`` returns the
    slots' partner poses for ``rep.geometry_pose`` (default: the current
    poses of all bodies, read through ``gather``).

    ``rows`` (a jointed world): contacts stay Jacobi at the sweep-start
    geometry, and the primal solve runs ``rows.n_colors`` Gauss-Seidel
    sub-passes, each evaluating the joint and spring rows at the newest
    poses, adding their terms after the contact and inertia terms, and
    moving only the bodies of its colour (_kernel_b_math 467-541); the joint
    dual follows the contact dual (565-573).

    The portable step (``solver._step_body``) passes its seams (``gather``,
    ``own_iota``: a body-sharded world), a ``san`` counter, with which each
    sweep's poses are sanitized against the sweep's start (the reference's
    _step_impl; K1 sanitizes once after the sweeps), and, under
    ``torch.func.vmap``, plan entries that are per-world bool / float
    tensors; ``active`` False keeps a world's carry (past its own last
    sweep).  Returns (pos, quat, lam, pen, stick, geom, (j_lam, j_pen) or
    None, san) with ``geom`` the last dual pass's geometry."""
    dt = params.dt
    inv_dt2 = 1.0 / (dt * dt)
    relax = params.relaxation
    mass = b.mass
    inertia = tuple(b.inertia[k] for k in range(3))
    inv_inertia = tuple(b.inv_inertia[k] for k in range(3))
    dyn = b.inv_mass > 0.0
    dynf = dyn.to(torch.float32)
    static = rep.geometry_static(cache, consts, own_iota)
    joints = rows.joints if rows is not None else None
    springs = rows.springs if rows is not None else None
    ncol = rows.n_colors if rows is not None else 1
    j_lam = rows.j_lam if joints is not None else None
    j_pen = rows.j_pen if joints is not None else None

    def geom_at(p, q):
        return rep.geometry_pose(cache, static, {"pos": p, "quat": q}, consts,
                                 None if partner is None else partner(p, q), gather)

    geom = geom_at(pos, quat)
    mat = None
    for entry in plan:
        alpha, do_dual, rebuild, ramp = entry[:4]
        active = entry[4] if len(entry) > 4 else True
        carry = (pos, quat, lam, pen, stick, j_lam, j_pen, san)
        alpha_t = torch.as_tensor(alpha, dtype=torch.float32, device=mass.device)
        rows_c = rep.eval_rows(geom, cache, consts, lam, pen, stick, alpha_t, params)
        f = rep.primal_force(rows_c, pen)

        def fresh_mat():
            iiw = _world_inertia_comps(quat, inv_inertia)
            m = rep.body_matrix(geom, f, pen, iiw)
            return m["m_ll"] + m["m_la"] + m["m_aa"] + m["gyro"]

        if mat is None or rebuild is True:
            mat = fresh_mat()
        elif rebuild is not False:
            mat = [torch.where(rebuild, x, y) for x, y in zip(fresh_mat(), mat)]
        m_ll, m_la, m_aa, gyro = mat[:6], mat[6:15], mat[15:21], mat[21:24]
        forces = rep.body_forces(geom, f)

        cur_pos, cur_quat = pos, quat
        for ci in range(ncol):
            cur = {"pos": cur_pos, "quat": cur_quat}
            accs = []
            if joints is not None:
                jg = joint_geometry(joints, cur, gather)
                accs.append(joint_accumulate(jg, joint_force(jg, joints, j_lam, j_pen), j_pen))
            if springs is not None:
                sg = spring_geometry(springs, cur, gather)
                accs.append(spring_accumulate(sg, spring_force(sg, rows.s_pen), rows.s_pen))

            iw = _world_inertia_comps(cur_quat, inertia)
            rhs_l = [mass * (cur_pos[k] - ip[k]) * inv_dt2 + forces["F"][k] for k in range(3)]
            q_err = cm.q_mul(cur_quat, (-iq[0], -iq[1], -iq[2], iq[3]))
            sgn = torch.where(q_err[3] < 0.0, -2.0, 2.0)
            rot = (q_err[0] * sgn, q_err[1] * sgn, q_err[2] * sgn)
            rhs_a = [
                (iw[0] * rot[0] + iw[1] * rot[1] + iw[2] * rot[2]) * inv_dt2 + forces["T"][0],
                (iw[1] * rot[0] + iw[3] * rot[1] + iw[4] * rot[2]) * inv_dt2 + forces["T"][1],
                (iw[2] * rot[0] + iw[4] * rot[1] + iw[5] * rot[2]) * inv_dt2 + forces["T"][2],
            ]
            m_dt2 = mass * inv_dt2
            a_ll = [m_ll[0] + m_dt2, m_ll[1], m_ll[2], m_ll[3] + m_dt2, m_ll[4],
                    m_ll[5] + m_dt2]
            a_la = list(m_la)
            a_aa = [
                m_aa[0] + iw[0] * inv_dt2 + gyro[0],
                m_aa[1] + iw[1] * inv_dt2,
                m_aa[2] + iw[2] * inv_dt2,
                m_aa[3] + iw[3] * inv_dt2 + gyro[1],
                m_aa[4] + iw[4] * inv_dt2,
                m_aa[5] + iw[5] * inv_dt2 + gyro[2],
            ]
            for acc in accs:
                _add_rows(rhs_l, rhs_a, a_ll, a_la, a_aa, acc)
            dl, da = solve66_cm(tuple(a_ll), tuple(a_la), tuple(a_aa), tuple(rhs_l),
                                tuple(rhs_a))

            if ncol > 1:
                mine = rows.joints.color == ci
                applyf, applyb = dynf * mine.to(torch.float32), dyn & mine
            else:
                applyf, applyb = dynf, dyn
            new_pos = tuple(cur_pos[k] - relax * dl[k] * applyf for k in range(3))
            dq = cm.q_mul((da[0] * relax, da[1] * relax, da[2] * relax,
                           torch.zeros_like(da[0])), cur_quat)
            nq = _q_normalize(tuple(cur_quat[k] - 0.5 * dq[k] for k in range(4)))
            cur_pos = new_pos
            cur_quat = tuple(torch.where(applyb, nq[k], cur_quat[k]) for k in range(4))
        new_pos, nq = cur_pos, cur_quat
        if san is not None:
            new_pos, san = _san(new_pos, pos, san)
            nq, san = _san(nq, quat, san)

        geom = geom_at(new_pos, nq)
        rows2 = rep.eval_rows(geom, cache, consts, rows_c["lam"], pen,
                              rows_c["stick"], alpha_t, params)
        lam2, pen2, stick2 = rep.dual_update(rows2, geom, pen, params.beta, params)
        lam = _sel(do_dual, lam2, rows2["lam"])
        pen = _sel(_and(do_dual, ramp), pen2, pen)
        stick = _sel(do_dual, stick2, rows2["stick"])
        if joints is not None and do_dual is not False:
            # Joint rows are fresh in every sub-pass, so their ramp runs every
            # iteration (the reference's 565-573).
            jg2 = joint_geometry(joints, {"pos": new_pos, "quat": nq}, gather)
            j_lam2, j_pen2 = joint_dual(jg2, joints, j_lam, j_pen, params.beta, params)
            j_lam, j_pen = _sel(do_dual, j_lam2, j_lam), _sel(do_dual, j_pen2, j_pen)
        pos, quat = new_pos, nq
        if active is not True:
            # Past this world's last sweep: keep its state (the geometry and
            # the Hessian are no longer read).
            new = (pos, quat, lam, pen, stick, j_lam, j_pen, san)
            pos, quat, lam, pen, stick, j_lam, j_pen, san = (
                None if x is None else
                tuple(_sel(active, a, b) for a, b in zip(x, y)) if isinstance(x, tuple)
                else _sel(active, x, y) for x, y in zip(new, carry))
    jout = (j_lam, j_pen) if joints is not None else None
    return pos, quat, lam, pen, stick, geom, jout, san


def iteration_plan(params: SolverParams, n_main: int, k: int):
    """One (alpha, do_dual, rebuild, ramp) per iteration of a step with
    ``n_main`` main iterations (and the post-stabilize one) at Hessian
    cadence ``k``: rebuild at block heads, ramp at block tails and on the
    last iteration (the folded form of the reference's solver.py:702-735)."""
    iters_end = n_main + (1 if params.post_stabilize else 0)
    plan = []
    for it in range(iters_end):
        alpha = (1.0 if it < n_main else 0.0) if params.post_stabilize else params.alpha
        plan.append((alpha, it < n_main, it % k == 0, (it % k == k - 1) or (it == iters_end - 1)))
    return plan


def predict_cm(b, params: SolverParams):
    """Phase 3, inertial prediction (solver.cpp:299-337), in component
    form: (linvel, angvel, inertial pos, inertial quat, the accel-weighted
    start pos, sanitized count), the velocities sanitized (the angular one
    clamped first)."""
    dt = params.dt
    grav = params.gravity
    g_len = float(sum(x * x for x in grav) ** 0.5)
    ghat = tuple(x / g_len for x in grav) if g_len > 1e-5 else (0.0, 0.0, 0.0)
    pos0 = tuple(b.pos[k] for k in range(3))
    quat0 = tuple(b.quat[k] for k in range(4))
    dyn = b.inv_mass > 0.0
    dynf = dyn.to(torch.float32)
    san = torch.zeros((), dtype=torch.float32, device=b.mass.device)
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
        aw = torch.zeros_like(b.mass)
    ps = tuple(pos0[k] + (lv[k] * dt + grav[k] * (aw * dt * dt)) * dynf
               for k in range(3))
    ps, san = _san(ps, pos0, san)
    return lv, av, ip, iq, ps, san


def solve_half(params: SolverParams, cache: Contacts, b, n_main: int,
               k_rebuild: int, joints=None, springs=None, n_colors: int = 1):
    """Phases 3-6 (the second half of K1; the reference's
    ``_kernel_b_math``), with the joint and spring rows of ``joints`` /
    ``springs`` (None or empty for a contact-only world) in ``n_colors``
    sub-passes.

    ``n_main``: main iterations; ``k_rebuild``: Hessian cadence.  Returns
    (pos, quat, linvel, angvel, prev_linvel, prev_angvel, lam, penalty,
    stick (f32), diag (8, 128) with lanes 0-8 filled, j_lam, j_pen, s_pen),
    the last three None where the world has no joints / springs."""
    dt = params.dt
    k_re = max(1, k_rebuild)

    pos0 = tuple(b.pos[k] for k in range(3))
    quat0 = tuple(b.quat[k] for k in range(4))
    mass, inv_mass = b.mass, b.inv_mass
    dyn = inv_mass > 0.0
    dynf = dyn.to(torch.float32)

    body = {"pos": pos0, "quat": quat0, "inv_mass": inv_mass,
            "friction": b.friction}
    consts = rep.pair_constants(cache.other, body)
    rows = row_state(joints, springs, n_colors, params)

    # ---- phase 3: prediction (solver.cpp:299-337) ----
    lv_in = tuple(b.linvel[k] for k in range(3))
    av_in = tuple(b.angvel[k] for k in range(3))
    plv = tuple(b.prev_linvel[k] for k in range(3))
    lv, av, ip, iq, ps, san = predict_cm(b, params)

    # ---- phase 4: the iterative solve (solver.cpp:340-431) ----
    plan = iteration_plan(params, n_main, k_re)
    pos, quat, lam, pen, stick, geom, jout, _ = sweeps(
        params, cache, b, consts, ip, iq, ps, iq, cache.lam, cache.penalty,
        cache.stick, plan, rows=rows)

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

    # The slow joint dual tracker on the final poses (654-661).
    j_lam = j_pen = None
    if jout is not None:
        j_lam, j_pen = jout
        if params.joint_ema_rate > 0.0:
            jgf = joint_geometry(rows.joints, {"pos": pos_f, "quat": quat_f})
            j_lam = joint_dual_ema(jgf, rows.joints, j_lam, j_pen, params)

    # ---- phase 6: diagnostics (solver.cpp:471-513) ----
    once = rep.once_mask(cache.other, dynf)
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
        j_lam,
        j_pen,
        rows.s_pen if rows is not None else None,
    )


def step_kernel_plain(old: Contacts, nb_raw, keys, thr, b, anchor, anchor_quat,
                      params: SolverParams, n_main: int, k_rebuild: int, cand,
                      joints=None, springs=None, n_colors: int = 1):
    """Plain version of K1.  Returns (contacts', body leaves (6), diag
    (8, 128), (j_lam, j_pen, s_pen)) with the kernel's diag row layout in
    row 0: lanes 0-8 diagnostics, 9 kept directed slots, 10-14 control
    lanes, 15 dropped manifolds; row 1 holds, from ``cand`` (the refresh's
    directed candidates, () int32), the state layout
    (``state.Diagnostics``, the reference's solver_tpu.py:1142-1152): lanes
    0-8 as row 0, 9 the pair overflow cand - kept (an int32 difference, as
    the reference takes it), 10 the dropped manifolds, 11-15 the control
    lanes; every other entry is 0.  The row outputs are None where the world
    has no joints / springs."""
    new, kept, dropped = collide_half(old, nb_raw, keys, thr, b, params)
    outs = solve_half(params, new, b, n_main, k_rebuild, joints, springs, n_colors)
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
    diag[1, :9] = diag[0, :9]
    diag[1, 9] = (cand - kept).to(torch.float32)
    diag[1, 10] = diag[0, 15]
    diag[1, 11:16] = ctrl
    return contacts, outs[:6], diag, outs[10:]


# ---------------------------------------------------------------------------
# Wrappers: plain version on CPU tensors, the kernel on CUDA tensors.
# ---------------------------------------------------------------------------

def step_kernel(old: Contacts, nb_raw, keys, thr, b, anchor, anchor_quat,
                params: SolverParams, n_main: int, k_rebuild: int, cand,
                joints=None, springs=None, n_colors: int = 1):
    """K1: phases 2-6 of one step plus the end-of-step control block, with
    the joint/spring branch when ``joints`` or ``springs`` has slots.
    Returns (contacts', (pos, quat, linvel, angvel, prev_linvel,
    prev_angvel), diag (8, 128), (j_lam, j_pen, s_pen)); diag's row 1
    holds the state layout from ``cand`` (``step_kernel_plain``).  The
    kernel reads and writes the cache's bool stick latches itself."""
    if b.pos.device.type == "cpu":
        return step_kernel_plain(old, nb_raw, keys, thr, b, anchor, anchor_quat,
                                 params, n_main, k_rebuild, cand, joints, springs, n_colors)
    from . import kernels

    plan = sweep_plan(b.n, old.other.shape[0], None, joints.dj if joints is not None else 0,
                      springs.ds if springs is not None else 0)
    out = kernels.launch_step(cache_leaves(old), nb_raw, keys, thr, b, anchor,
                              anchor_quat, params, n_main, k_rebuild, cand, joints, springs,
                              n_colors, plan=plan)
    step_kernel.launches += 1
    cache_out, body_out, diag, row_out = out
    return Contacts(*cache_out), body_out, diag, row_out


step_kernel.launches = 0


def collide_and_init(old: Contacts, nb_raw, keys, thr, b, params: SolverParams):
    """K3 (the reference's collide_and_init_tpu): symmetric filter,
    precull, SAT, warmstart match and row init.  Returns (contacts, kept
    directed slots () int32, dropped manifolds () int32); plain version
    ``collide_half``."""
    if b.pos.device.type == "cpu":
        return collide_half(old, nb_raw, keys, thr, b, params)
    from . import kernels

    cache_out, kept, dropped = kernels.launch_collide(cache_to_args(old), nb_raw, keys,
                                                      thr, b, params)
    collide_and_init.launches += 1
    return args_to_cache(cache_out), kept, dropped


collide_and_init.launches = 0


def solve_loop_plain(contacts: Contacts, b, params: SolverParams):
    """Plain version of K4: ``solve_half`` at ``params.iterations`` and
    ``params.lhs_rebuild_every``, contact-only.  Returns (bodies', lam,
    penalty, stick (bool), diag (8, 128) lanes 0-8)."""
    outs = solve_half(params, contacts, b, params.iterations, params.lhs_rebuild_every)
    return _solve_loop_result(b, outs[:6], outs[6], outs[7], outs[8], outs[9])


def _solve_loop_result(b, body_out, lam, pen, stickf, diag):
    pos, quat, lv, av, plv, pav = body_out
    bodies = b.replace(pos=pos, quat=quat, linvel=lv, angvel=av, prev_linvel=plv,
                       prev_angvel=pav)
    return bodies, lam, pen, stickf > 0.5, diag


def solve_loop(contacts: Contacts, b, params: SolverParams):
    """K4 (the reference's solve_loop_tpu): phases 3-6 of a contact-only
    step at ``params.iterations``; returns what ``solve_loop_plain``
    returns."""
    if b.pos.device.type == "cpu":
        return solve_loop_plain(contacts, b, params)
    from . import kernels

    body_out, lam, pen, stickf, diag = kernels.launch_solve_loop(
        cache_to_args(contacts), b, params, params.iterations, params.lhs_rebuild_every,
        plan=sweep_plan(b.n, contacts.other.shape[0]))
    solve_loop.launches += 1
    return _solve_loop_result(b, body_out, lam, pen, stickf, diag)


solve_loop.launches = 0


def control_lanes_plain(nb, b, anchor, anchor_quat, params: SolverParams):
    """Plain version of K2 on the Bodies ``b``; with a leading batch axis on
    every operand, each world's lanes (vmapped)."""

    def lanes(nb, pos, quat, size, radius, linvel, angvel, inv_mass, anchor, anchor_quat):
        return control_lanes_math(
            nb, tuple(pos[k] for k in range(3)), tuple(quat[k] for k in range(4)),
            tuple(size[k] * 0.5 for k in range(3)), radius,
            tuple(linvel[k] for k in range(3)), tuple(angvel[k] for k in range(3)),
            inv_mass > 0.0, anchor, anchor_quat, params)

    ops = (nb, b.pos, b.quat, b.size, b.radius, b.linvel, b.angvel, b.inv_mass, anchor,
           anchor_quat)
    return torch.func.vmap(lanes)(*ops) if nb.dim() == 4 else lanes(*ops)


def control_lanes(nb, b, anchor, anchor_quat, params: SolverParams, out=None):
    """K2: the (5,) f32 control block (diagnostics lanes 11-15) on ``b``,
    or (B, 5) for a batch of B worlds (one launch).  ``out``: a contiguous
    (5,) view the lanes are written into (the ballistic step's diagnostics
    lanes 11-15), returned."""
    if b.pos.device.type == "cpu":
        lanes = control_lanes_plain(nb, b, anchor, anchor_quat, params)
        return lanes if out is None else out.copy_(lanes)
    from . import kernels

    out = kernels.launch_control(nb, b, anchor, anchor_quat, params, out)
    control_lanes.launches += 1
    return out


control_lanes.launches = 0


def bp_probe_plain(nb, b, params: SolverParams):
    """Plain version of K7 on the Bodies ``b``."""
    g_len = float(sum(x * x for x in params.gravity) ** 0.5)
    return bp_probe_math(
        nb, tuple(b.pos[k] for k in range(3)), tuple(b.quat[k] for k in range(4)),
        tuple(b.size[k] * 0.5 for k in range(3)), b.radius,
        tuple(b.linvel[k] for k in range(3)), tuple(b.angvel[k] for k in range(3)),
        params.dt, params.collision_margin, g_len)


def bp_probe(nb, b, params: SolverParams):
    """K7 (the reference's bp_probe_tpu): the candidate slots ``nb`` probed
    at the poses of ``b``.  Returns (min_sep () f32, n_slots () int32, near
    (G, 128) bool); semantics in ``ops.broadphase.bp_probe``."""
    if b.pos.device.type == "cpu":
        return bp_probe_plain(nb, b, params)
    from . import kernels

    out = kernels.launch_bp_probe(nb, b, params)
    bp_probe.launches += 1
    return out


bp_probe.launches = 0


def reset_launch_counts() -> None:
    """Every launch count of this module, of the fused path's stage wrappers
    (``solver.step_gates`` / ``ballistic_step``) and of the broadphase
    refresh's (``ops.broadphase.candidate_lists`` / ``refresh_needed``) to
    0."""
    from . import solver

    solver.step_gates.launches = 0
    solver.ballistic_step.launches = 0
    broadphase.candidate_lists.launches = 0
    broadphase.refresh_needed.launches = 0
    step_kernel.launches = 0
    control_lanes.launches = 0
    bp_probe.launches = 0
    collide_and_init.launches = 0
    solve_loop.launches = 0


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


def step_fused(world: World, params: SolverParams, cap: Capacity, stale_ok: bool,
               calm: bool) -> World:
    """One step through K1 (the counterpart of ``step_pallas``), joints and
    springs written back as the reference does (its 1143-1144); the
    diagnostics are K1's row in the state layout (its diag row 1, pair
    overflow against ``bp.cand``).  ``world.bp`` is the (possibly
    refreshed) broadphase cache; the gates come from the step's one host
    read (solver.step)."""
    bp = world.bp
    b = world.bodies
    n_main, k = select_variant(params, stale_ok, calm)
    joints, springs = world.joints, world.springs
    contacts, body_out, diag_v, (j_lam, j_pen, s_pen) = step_kernel(
        world.contacts, bp.nb, bp.key, bp.thr, b, bp.anchor, bp.anchor_quat,
        params, n_main, k, bp.cand, joints if joints.dj else None,
        springs if springs.ds else None, cap.joint_colors)
    pos, quat, lv, av, plv, pav = body_out
    bodies = b.replace(pos=pos, quat=quat, linvel=lv, angvel=av,
                       prev_linvel=plv, prev_angvel=pav)
    if j_lam is not None:
        joints = joints.replace(lam=j_lam, penalty=j_pen)
    if s_pen is not None:
        springs = springs.replace(penalty=s_pen)
    return world.replace(bodies=bodies, contacts=contacts, joints=joints, springs=springs,
                         step_index=world.step_index + 1,
                         diagnostics=Diagnostics(vec=diag_v[1, :16]))

