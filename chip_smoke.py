"""Smoke run of the PyTorch + CUDA port (avbd3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card and the torch/CUDA versions, builds the kernels from
   avbd3d_tpu_torch/csrc/ (one nvcc per source, in parallel) and prints the
   build time.
2. Fused path: Stress1000 (1000 cubes + ground, N = 1024, 20 iterations,
   D = 24, DC = 12) through ``load_scene(..., device="cuda")`` and ``step``
   for 700 steps (the falling regime with the ballistic rain-in, the landing,
   the settling pile), with the launch counters reset before and read after.
   Checks: the gates kernel (csrc/fused_stages.cu) once a step, K1 once a
   contact step, the ballistic step's kernel and K2 once a ballistic step
   and the refresh kernels once a refresh step, each launched; sanitized == 0, overflow 0,
   penetration below PEN_LIMIT at every step after the landing cascade,
   poses finite.
3. Kernel vs plain on the card: K1 for one step from a landing state and a
   settled state (Stress1000 takes one launch per half-sweep), K1 on its
   cluster-resident route on Pyramid and a 7^3 pile, K2 on Stress1000's
   initial and settled states, Stress2048's initial state and Stress1000's
   initial state with every body static (nm = 0).  Integer outputs must be
   identical and K1's floats equal (difference 0) but for the control
   lanes' world-wide sums; K2's lanes 0, 1, 2 and 4 bit-identical, its lane
   3 within 1e-5; the tolerances of the others are stated at the checks.
4. Times: steps/s of the falling window (steps 0-300) and of a settled block
   (steps 700-1000) with the kernels, steps/s of the plain path over a few
   settled steps, and each kernel's time beside its plain version's; K2 at
   three states also traced, held to one kernel a call, its own time
   printed.
5. Grid tier: Stress4096 (16^3 cubes + ground, N = 5120, G = 40, D = 28,
   DC = 16, x-major order) for 1000 steps, the reference's validated window,
   counters reset before and read after.  Checks: every step took the grid
   tier, K5 launched once and K6 five times per step, the gates, prediction
   and finalize kernels (csrc/grid_stages.cu) once a step and the refresh
   kernels once a refresh step, one host read a step, sanitized 0, pair and
   degree overflow 0 and finite poses at every step, penetration below
   PEN_LIMIT over steps 901-1000; 20 steps from the settled state traced
   (utils/profile_phases.trace): at most GRID_STEP_LAUNCHES launches a step,
   every kernel of the step counted, its device time and idle share.  Then
   K5 (two kernels a call, held to
   that in a trace; floats with difference 0) and K6 against their plain
   versions from a landing and a settled state (K6 on its cluster-resident
   route, logical blocks of 1024 bodies, and on its launch-per-half-sweep
   route, the world as one logical block; K5 also with one body's pos.y,
   then pos.x, NaN), their times, and the falling
   (0-300) and settled (901-1000) steps/s.
6. The reference's large-N gate (tests/test_large_n_envelope.py): the
   low-drop 16^3 pile with Stress4096's plan, 60 landing + 30 settle steps,
   overflow 0, sanitized 0, and the worst settle penetration held to
   LOW_DROP_PEN_LIMIT (see there: the reference's own grid tier does not
   meet the slop bound on IEEE float32).
7. Stress2048 (N = 2048, fused path) for 600 steps: K1 launched, the same
   envelope (penetration below PEN_LIMIT over steps 401-600), steps/s of
   the last 200 steps, and K1 against its plain version at the settled
   state.
8. Jointed worlds through K1's joint/spring branch, counters reset before
   and read after each: RodJointed 600 steps held to the reference's slow
   tests (static anchor, weld gaps, rest, link tensions), SoftGrid 150
   steps, the spring and world-joint worlds of the reference's component
   tests, and 20 SoftGrid sheets side by side (N = 2048, 3,600 soft
   joints) for 300 steps with their steps/s and K1 time; then K1 with
   joints against its plain version at a state of each of the three
   scenes (float difference 0), on the resident route ``sweep_plan`` gives
   each (one cluster at N = 128, a cooperative launch of 128 blocks for the
   sheets), and at a welded rod with a cache of width 1 (its row terms,
   not its contact partials, size the launch's shared memory), and traces
   of jointed steps (profile_phases on RodJointed, five
   sheet steps) held to ``step_kernel_count``: one resident launch a step.
9. The profiler path: K3 and K4 against their plain versions at the
   settled Stress1000 state (K3 also with one body's pos.y, then pos.x,
   NaN), utils/profile_cuda's per-phase table, and their times.
10. K7 and the refined stale-Hessian gate: a second Stress1000 run of 300
   steps (counters reset before, read after) that calls
   ``solver.stale_lhs_ok`` refined and unrefined on every pre-step state
   (one K7 launch per refined call, no host read) and probes the slots each
   step used.  Checks: refined is True wherever unrefined is; wherever
   ``min_sep > collision_margin`` with every candidate probed the step
   finds zero contacts.  Then K7 against its plain version at the landing
   and settled Stress1000 states, the settled Stress2048 and Stress4096
   states, the 20 sheets (D = 32), fresh lists of 40 slots at settled
   Stress1000 and Ground (no slots) (``n_slots`` and ``near`` identical,
   ``min_sep`` bit for bit), and its times at settled Stress1000 and
   Stress4096, traced and held to one kernel a call.
11. The application layer on the card: the headless CLI as a subprocess
   (20 traced Stress1000 steps; ``--bench``), a checkpoint saved at the
   landing state and resumed for 50 steps bitwise equal to the
   uninterrupted run, ``pick`` straight down onto the settled pile, the
   viewer's ``Sim`` (state, spawn into a padding slot, the refresh after
   it), and utils/profile_phases' table for 50 settled steps, whose kernel
   count is held to the sweep plan's own and its refresh kernels to the
   traced steps' refreshes.
12. The race gate: every resident route (K1's cluster route at clusters of
   4, 12 and 16 blocks, K6 with 5 clusters, K1's joint route at RodJointed,
   SoftGrid and the 20 sheets, RodJointed also on the grid barrier), K7,
   K2, the refresh kernels (whose last block folds every block's
   partials), the grid step's stage kernels and the fused path's (the
   prediction, the finalize and the ballistic step folding by atomics into
   words their last block reads and clears) run RACE_REPS
   times on one input with every output bit-identical, then through a
   build whose odd blocks sleep before their pose reads and writes (K7,
   K2: before their partials' write and the ticket), bit-identical again;
   compute-sanitizer's racecheck and synccheck on the collide kernels (the
   tool's control) and on each resident kernel of Stack and RodJointed,
   cluster and grid barrier, where the tool runs (else the reason).
13. The sweep kernels' record: the route ``solver_cuda.sweep_plan`` gives
   each scene and the kernels a step of it queues, ptxas registers and spill
   bytes of the tiled, the collide, K7's, K2's and the refresh kernels, and K1-K7
   timed by utils/time_sweeps.py (CUDA events, and the kernels' own time in
   a trace) in this tree and, where an archive of the parent commit lies in
   ``_archive/parent`` (git-ignored), in that tree too, in turns within
   this one run.
14. The portable path (``backend="xla"``) on Stress1000, 300 steps from step
   0 through the landing: one host read, one gates launch and one K2 launch
   a step, the ballistic kernel once a ballistic step, the refresh kernels
   once a refresh, no other kernel, sanitized 0, overflow
   0; one step from its landing state and
   from the settled state on both paths: candidate lists and contact counts
   identical, poses within the reference's backend bound (2e-3 m); its
   ms/step and kernel launches a step.
15. A jointed world above 2048 bodies (150 RodJointed chains, N = 3072,
   the default 10 iterations) under ``"auto"``: the portable path, 200
   steps, K2 once a step,
   sanitized 0, degree overflow 0, RodJointed's weld gates at step 200.
16. ``parallel.batched_step`` over 16 kicked Stress1000 worlds: 3 steps,
   each world equal to its own single run, K2 once a batched step (one
   launch for the whole batch), the refresh kernels once a batched step in
   which a world refreshes (one call for the whole batch) and no other
   kernel, K2's batched lanes
   against its plain version; then 100 timed batched steps from the
   landing state (world-steps/s, launches and host reads a step).
17. The swept broadphase (``cap.bp_window`` > 0, windows SWEPT_WINDOWS):
   one refresh at Stress1000's landing and settled states and at settled
   Stress4096, the sweep on the card against the matrix on the card (lists
   identical, slack at most the matrix's) and against the sweep's plain
   run on the CPU (lists identical), with both refreshes' times, kernels
   and device time; Stress1000 700 steps from step 0 with the sweep (K1 and
   K2 launched, the sweep taken on most refreshes, the envelope of phase
   2); Stress4096 200 steps from step 0 on the grid tier (K5 and K6 a step,
   sanitized 0, overflow 0, the sweep taken on some refreshes: the falling
   layers need a larger window) and 20 steps from its settled state equal
   to the matrix's bit for bit, the sweep taken; one refresh of a
   16384-body pile, timed.
18. The port's bench as a user starts it: ``python -m avbd3d_tpu_torch.bench
   --quick`` in a subprocess (every regime of the root bench.py at shorter
   windows, each checked against its own untimed rerun), its last line
   parsed: ``correct`` true, ``device`` the card of phase 1, K1 and K2
   launched on Stress1000, K5 once and K6 five times a Stress4096 grid
   step, one host read a fused step; the phase's seconds.  Each regime's
   host spans (``layers.host_span_us_per_step``, utils/host_spans.py):
   every ``<id>.call`` a step equal to that kernel's launches a step,
   ``step_other`` at most 10% of ``step``, the allocator's counts read,
   the span ranges' device mirrors absent from the traced device figures;
   the split printed.  Then each cell
   of BENCHMARK.json as its command runs it, with ``--quick``, in a
   subprocess: its last line held to ``correct``, the cell's seed, the
   plain-version check at both ends of the timed windows (one step on the
   card against the same step on the CPU through the plain versions, its
   float16 control failing it) and ``failed_steps`` 0, the headline a rate
   over its count of timed steps; its idle share, longest idle gap and peak
   memory printed.
19. The broadphase refresh on the card (csrc/bp_refresh.cu): the lists
   kernels (``build_bp_cache``) against their plain version on the same
   card tensors at Stress1000's initial, landing and settled states (also
   at D = 4, where rows exceed the width, D = 40, and every body static),
   Stress2048 steps 700 and 800, Stress4096 steps 800 and 2800 (and 2800
   with a 2.5 m margin, whose rows overflow the kernel's per-row buffer of
   128 keys and are cut to their D smallest), RodJointed
   (exclusion columns) and the 16384-body pile compressed: nb, key, thr,
   cand, dropped identical, slack bit for bit; the lists of two halves of
   the rows (a sharded call) equal to the whole's; the refresh predicate
   against its plain version at those states and against older lists: the
   bool equal (both values taken), dev_raw bit for bit, dev_mm within 1e-5
   relative, both the bits of K2's lanes 3 and 4; times of both beside the
   torch versions' (and their launches) at N = 1024, 2048, 5120 and 16384.
   The grid step no longer launches the predicate kernel (phase 20's gates
   kernel folds the same predicate); ``refresh_needed`` keeps it.
20. The grid step's stage kernels (csrc/grid_stages.cu) against their
   plain versions on the same card tensors, at Stress4096 steps 800 and
   2800, step 2800 with its lists fresh at its poses (no refresh due), the
   low-drop 16^3 pile of phase 6 (step 90), step 800 with every
   body static, with three bodies below fall_freeze_y, with a NaN and
   an infinite velocity and a NaN final pose, with a NaN pos.y and with a
   body at pos.x 3.4e38 moving at 3e38 (its inertial position infinite),
   and step 2800 with one live
   slot's separation NaN and with every separation +0 (the finalize's
   fold: lanes 0 and 1 NaN; +0 and the slop): k_grid_gates' flags, dev_raw,
   v^2 max and frozen fields bit for bit, dev_mm within 1e-5 relative of
   the torch version's (a non-finite one the same value) and both
   deviations bit for bit k_refresh_needed's
   (the fold the gates kernel ran in one block before its cooperative
   tail);
   k_grid_predict's outputs bit for bit; k_grid_finalize's bodies, latches
   and diagnostics lanes identical (a NaN matching a NaN) but the speed
   lanes (2, 3) within 1e-6 relative; each flag takes both values.  Each kernel's time at step 2800
   beside its plain version's (and its launches), traced and held to one
   kernel a call, and its bound.
21. The fused path's stage kernels (csrc/fused_stages.cu) and K1's new tail
   against their plain versions on the same card tensors, at Stress1000
   steps 0, 1 (its next step ballistic) and 700, step 700 with three bodies
   below fall_freeze_y, with a NaN and an infinite velocity and an angular
   speed above the clamp, with a NaN pos.y, with a NaN pos.x and with a
   body at pos.x 3.4e38 moving at 3e38 (its inertial position infinite),
   with every body static, and RodJointed at step 600 through K1's joint
   branch: k_step_gates' control
   vector and frozen fields bit for bit (the world it was given unchanged);
   k_ballistic_step's bodies bit for bit and its lanes identical, lanes 0
   and 1 with their sign bits, the speed lanes within 1e-6 relative; the ballistic step with K2 writing lanes
   11-15 into its vector (``out=``) against ``_ballistic_step``, K2's exact
   lanes bit for bit and those lanes equal to K2's own call; K1's row in
   the state layout (diag row 1) and its bool latches against
   ``step_kernel_plain``'s, the pair overflow both as the int32 difference
   and as the float one; K1's cache and bodies too, integers identical and
   floats difference 0, a NaN matching a NaN (so at the NaN poses as well;
   K3 and K5 are held so at NaN poses in phases 9 and 5).  Each kernel's
   time at the rain-in and settled states beside its plain version's,
   traced and held to one kernel a call, and its bound, k_step_gates'
   beside its launch floor (k_launch_floor at its grid and block: empty,
   with a load and a store a thread, and with the gates' own three loads
   before its store); then the launches of 20 traced settled steps and of a
   traced falling window (steps 1-100), held to the port's kernels alone,
   kernel by kernel to what the launch counters give: the gates, K1's
   kernels or the ballistic kernel and K2, the refresh kernels.

Exits non-zero on any failure, and without CUDA.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import shlex
import subprocess
import sys
import tempfile
import time
import types

# Penetration bound, held at every step after the landing cascade (Stress1000
# steps 301-700, Stress2048 401-600, Stress4096 901-1000).  During the
# cascade (cubes arriving at up to ~25 m/s) the reference itself penetrates
# transiently far deeper — its JAX CPU run of Stress1000 reaches 0.22 at step
# 162 — so those steps are reported, not held to it.
PEN_LIMIT = 0.01

# The reference's large-N gate (tests/test_large_n_envelope.py) holds the
# low-drop 16^3 pile's settle-window penetration to penetration_slop
# (0.005).  On IEEE float32 the reference's own grid tier does not meet it:
# run on XLA:CPU from the same world (backend="grid", its kernels' math
# twins) it reaches 0.0790 over settle steps 61-90.  The pile is numbered
# y-major, so each logical block of 1024 bodies is four horizontal layers
# and every block boundary is a layer of contacts under the cross-block pose
# lag (the reference's scene_stress4096 docstring reports standing
# penetration for that order).  The port's grid step equals the reference's
# on a step (tests/test_torch_parity_grid.py), but the collapse of the
# 16-layer stack is chaotic, so the card is held to twice the reference's
# IEEE value rather than to that value.
LOW_DROP_PEN_LIMIT = 2 * 0.0790

# Stress1000's settled steps/s before the joint branch existed, printed
# beside this run's (PERF.md §6, the grid tier's A/B pairs: one H100 80GB
# HBM3 at 700 W).
PRIOR_SETTLED = "before the joint branch: 390.2-554.7 steps/s (PERF.md, grid tier A/B)"


def fail(msg: str):
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync():
    import torch

    torch.cuda.synchronize()


@contextlib.contextmanager
def plain_wrappers():
    """Route the step through the kernels' plain versions (by name)."""
    from avbd3d_tpu_torch import solver_cuda

    k1, k2 = solver_cuda.step_kernel, solver_cuda.control_lanes
    solver_cuda.step_kernel = solver_cuda.step_kernel_plain
    solver_cuda.control_lanes = solver_cuda.control_lanes_plain
    try:
        yield
    finally:
        solver_cuda.step_kernel, solver_cuda.control_lanes = k1, k2


def k1_inputs(world, scene):
    """The step kernel's operands for the next step of ``world``, prepared
    as ``solver.step`` prepares them (refresh, gates, variant), the
    refreshed cache's ``cand`` among them (index 10)."""
    from avbd3d_tpu_torch import solver, solver_cuda
    from avbd3d_tpu_torch.ops.broadphase import refresh_scalar

    p, cap = scene.params, scene.cap
    dv = solver.read_control(world)
    bp, refreshed = refresh_scalar(world.bp, dv, world.bodies, world.exclusions,
                                   cap.max_degree, p.bp_margin)
    world = world.replace(bp=bp)
    n_main, k = solver_cuda.select_variant(p, *solver.control_gates(dv, refreshed, p))
    bp, j, sp = world.bp, world.joints, world.springs
    return (world.contacts, bp.nb, bp.key, bp.thr, world.bodies, bp.anchor,
            bp.anchor_quat, p, n_main, k, bp.cand, j if j.dj else None, sp if sp.ds else None,
            cap.joint_colors)


def event_ms(fn, reps: int) -> float:
    import torch

    fn()
    sync()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    sync()
    return a.elapsed_time(b) / reps


def float_diff(a, b) -> float:
    """Largest |a - b| of two float tensors; positions that are equal (an
    infinity the same infinity) or NaN on both sides count 0, NaN on one
    side only counts inf."""
    import torch

    if a.numel() == 0:
        return 0.0
    both = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(both, torch.zeros_like(a), (a - b).abs())
    return float(torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d).max())


def same_bits(a, b) -> bool:
    """Bit-identical tensors (floats compared as their 32-bit words)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def compare_k1(args, label: str) -> float:
    """K1 kernel vs plain on the same operands: integers (slots, counts,
    feature ids, kept/dropped lanes) identical and every float of the cache,
    the bodies and the joint/spring rows with difference 0 — both sides run
    the same float32 operations in the same order (csrc/avbd_common.cuh).
    Diagnostics lanes 0-9 and 15 equal too; the control lanes (10-14) sum
    over the whole world in another order and are held to 1e-5 relative.
    Returns the largest float difference (0.0, or the run has failed)."""
    from avbd3d_tpu_torch import solver_cuda

    cp, bp_, dp, rp = solver_cuda.step_kernel_plain(*args)
    ck, bk, dk, rk = solver_cuda.step_kernel(*args)
    sync()
    err = 0.0
    for name, a, b in zip(("j_lam", "j_pen", "s_pen"), rp, rk):
        if (a is None) != (b is None):
            fail(f"K1 {label}: {name} returned by one side only")
        if a is not None:
            err = max(err, float_diff(a, b))
    for f in solver_cuda.CACHE_FIELDS:
        a, b = getattr(cp, f), getattr(ck, f)
        if a.dtype.is_floating_point:
            err = max(err, float_diff(a, b))
        elif not same_bits(a, b):
            fail(f"K1 {label}: cache.{f} differs in {int((a != b).sum())} entries")
    err = max([err] + [float_diff(a, b) for a, b in zip(bp_, bk)])
    for lane in list(range(10)) + [15]:
        if float(dp[0, lane]) != float(dk[0, lane]):
            fail(f"K1 {label}: diag lane {lane} {float(dp[0, lane])} vs {float(dk[0, lane])}")
    drel = float(((dp - dk).abs() / (dp.abs() + 1.0)).max())
    if drel > 1e-5:
        fail(f"K1 {label}: control lanes rel err {drel}")
    if err != 0.0:
        fail(f"K1 {label}: float outputs differ from the plain version by up to {err}")
    print(f"K1 vs plain ({label}): integers identical, float difference 0 (cache, bodies, rows), "
          f"control lanes max rel err {drel:.3e}, contacts {int(dk[0, 5])}")
    return err


def small_cluster_worlds():
    """K1 on its cluster-resident route (contact-only worlds whose 32-body
    tiles fit one cluster) against its plain version: Pyramid after 60 steps
    (N = 128, a cluster of 4 blocks) and a settling 7^3 pile after 200 steps
    (N = 384, a cluster of 12).  Returns (largest float difference, the
    pile's operands)."""
    from avbd3d_tpu_torch import load_scene, solver, solver_cuda
    from avbd3d_tpu_torch.convert import world_from_arrays
    from avbd3d_tpu_torch.models.scenes import _scene_stress_n

    sc = load_scene("Pyramid", device="cuda")
    arrays, p7, cap7, _ = _scene_stress_n(7, 7, 7)
    worlds = (("Pyramid step 60", sc.world, sc.params, sc.cap, 60, 4),
              ("7^3 pile step 200", world_from_arrays(arrays, "cuda"), p7, cap7, 200, 12))
    err, args = 0.0, None
    for label, w, p, cap, steps, cluster in worlds:
        plan = solver_cuda.sweep_plan(w.bodies.n, w.contacts.other.shape[0])
        if (plan.route, plan.cluster) != ("cluster", cluster):
            fail(f"{label}: expected a cluster of {cluster} blocks, the plan is {plan}")
        w = solver.run_steps(w, p, cap, steps)
        args = k1_inputs(w, types.SimpleNamespace(params=p, cap=cap))
        err = max(err, compare_k1(args, f"{label}, cluster of {cluster}"))
    return err, args


def compare_k2(world, params, label: str) -> float:
    """K2 kernel vs plain: lanes 0, 1, 2 and 4 (gate speed^2, near speed^2,
    min candidate gap, raw anchor deviation) are mins and maxes of values
    both sides compute in the same statement order, exact in any order, so
    they must be bit-identical; lane 3 (the deviation from the mean
    displacement) goes through world-wide sums taken in another order than
    torch.sum's and is held to 1e-5 relative, 1e-6 absolute.  A NaN matches
    a NaN (a NaN pose: both sides keep it in every min and max).  Returns
    the largest difference (that of lane 3)."""
    import torch

    from avbd3d_tpu_torch import solver_cuda

    b, bp = world.bodies, world.bp
    lp = solver_cuda.control_lanes_plain(bp.nb, b, bp.anchor, bp.anchor_quat, params)
    lk = solver_cuda.control_lanes(bp.nb, b, bp.anchor, bp.anchor_quat, params)
    sync()
    exact = [0, 1, 2, 4]
    if not same_bits_nan(lp[exact], lk[exact]):
        fail(f"K2 {label}: lanes 0, 1, 2, 4 differ in bits: plain {lp.tolist()} vs kernel "
             f"{lk.tolist()}")
    finite = bool(torch.isfinite(lp[3]))
    err = float((lp[3] - lk[3]).abs()) if finite else (
        0.0 if same_bits_nan(lp[3:4], lk[3:4]) else math.inf)
    if not err <= (1e-6 + 1e-5 * float(lp[3].abs()) if finite else 0.0):
        fail(f"K2 {label}: lane 3 plain {float(lp[3])!r} vs kernel {float(lk[3])!r}")
    print(f"K2 vs plain ({label}, N = {b.n}, D = {bp.nb.shape[0]}): lanes "
          f"{[round(x, 6) for x in lk.tolist()]}, lanes 0, 1, 2, 4 bit-identical, lane 3 "
          f"abs err {err:.3e}")
    return err


def one_kernel_times(card, what, kernel, call, plain, reps=100) -> dict:
    """``call`` (one wrapper call) timed with CUDA events over ``reps``
    calls back to back, then traced: the port's kernels in the trace must be
    ``kernel`` (a name, or a tuple of the names a call queues), once each a
    call.  ``plain``: the plain version, timed beside it.  Returns {"ms",
    "plain_ms", "device_us" (the kernels' own time a call)}."""
    names = {kernel} if isinstance(kernel, str) else set(kernel)
    ms = event_ms(call, reps)
    plain_ms = event_ms(plain, 20)
    t = trace_kernels(call, reps)
    # The profiler may drop events: one of the many (a count of 0.99 a
    # call), so the count a call is rounded and the time taken per traced
    # launch; or most of them on some runs (42 of 100 seen), so a trace that
    # holds no other kernel and fewer launches than calls is taken again, up
    # to twice, and then held as it is.
    for _ in range(2):
        if not set(t) <= names or (set(t) == names and all(round(t[k][1]) >= 1 for k in t)):
            break
        print(f"{what}: the trace lost records ({t}); tracing again")
        t = trace_kernels(call, reps)
    if set(t) != names or any(round(t[k][1]) != 1 for k in t):
        fail(f"{what}: the trace shows {t}, expected one each of {sorted(names)} a call")
    us = sum(t[k][0] / t[k][1] for k in t)
    print(f"[{card}] {what}: {ms:.4f} ms a call back to back (CUDA events, {reps} calls), plain "
          f"{plain_ms:.4f} ms; on the card {us:.2f} us a call, {len(names)} kernel(s) ("
          + ", ".join(f"{k} {t[k][0] / t[k][1]:.2f} us" for k in sorted(t))
          + f"; trace of {reps} calls)")
    return {"ms": ms, "plain_ms": plain_ms, "device_us": us}


def unmoved_world(world):
    """``world`` (whose candidate lists are anchored at its poses) with every
    body static: no body has moved, so K2's moved count is 0 and it takes
    max(nm, 1); the slots stay those of the dynamic world."""
    b = world.bodies
    return world.replace(bodies=b.replace(inv_mass=b.inv_mass * 0.0))


def reset_counts():
    """Every kernel wrapper's launch count to 0 (K1-K7, the broadphase
    refresh's two wrappers, the grid step's three stages and the fused
    path's two)."""
    from avbd3d_tpu_torch import solver_cuda, solver_grid

    solver_cuda.reset_launch_counts()
    solver_grid.reset_launch_counts()


def read_counts() -> dict:
    from avbd3d_tpu_torch import solver, solver_cuda, solver_grid
    from avbd3d_tpu_torch.ops import broadphase

    return {"step_gates": solver.step_gates.launches,
            "ballistic_step": solver.ballistic_step.launches,
            "candidate_lists": broadphase.candidate_lists.launches,
            "refresh_needed": broadphase.refresh_needed.launches,
            "step_kernel": solver_cuda.step_kernel.launches,
            "control_lanes": solver_cuda.control_lanes.launches,
            "collide_and_init": solver_cuda.collide_and_init.launches,
            "solve_loop": solver_cuda.solve_loop.launches,
            "bp_probe": solver_cuda.bp_probe.launches,
            "collide_grid": solver_grid.collide_grid.launches,
            "iterblock_grid": solver_grid.iterblock_grid.launches,
            "grid_gates": solver_grid.grid_gates.launches,
            "grid_predict": solver_grid.grid_predict.launches,
            "grid_finalize": solver_grid.grid_finalize.launches}


def grid_phase(card: str) -> dict:
    """Stress4096 on the grid tier: 1000 steps with the counters reset
    before and read after, the envelope, K5/K6 against their plain versions
    from a landing (step 250) and the settled (step 1000) state, and times."""
    from avbd3d_tpu_torch import load_scene, solver, solver_grid

    scene = load_scene("Stress4096", device="cuda")
    p, cap = scene.params, scene.cap
    w = scene.world
    shape = (w.bodies.n, w.bodies.g, cap.max_degree, w.contacts.other.shape[0])
    if shape != (5120, 40, 28, 16):
        fail(f"Stress4096 is not N=5120, G=40, D=28, DC=16: {shape}")
    n_steps, hold_from = 1000, 900
    watch = Watch(hold_from)
    paths, refreshes, saved, marks = set(), 0, {}, {}
    reset_counts()
    solver.step.host_reads = 0
    sync()
    t0 = time.perf_counter()
    for i in range(n_steps):
        w = solver.step(w, p, cap)
        paths.add(solver.step.last_path)
        refreshes += int(solver.step.last_gates["refreshed"])
        watch.add(i, w)
        if i + 1 in (250, 800):
            saved[{250: "landing", 800: "step 800"}[i + 1]] = w
        if i + 1 in (300, hold_from):
            sync()
            marks[i + 1] = time.perf_counter() - t0
    sync()
    t_run = time.perf_counter() - t0
    launches = read_counts()
    host_reads = solver.step.host_reads
    print(f"Stress4096: {n_steps} steps in {t_run:.2f} s; paths {sorted(paths)}; "
          f"refresh steps {refreshes}; launches {launches}; host reads {host_reads}")
    if paths != {"grid"}:
        fail(f"Stress4096 did not take the grid tier at every step: {paths}")
    # A grid step runs the gates (one launch: the fall-freeze, the refresh
    # predicate, the speed gates) and, when the predicate holds, refreshes
    # the lists (one call of the refresh kernels); then the prediction, K5,
    # K6 and the finalize.
    want = {"step_gates": 0, "ballistic_step": 0, "candidate_lists": refreshes,
            "refresh_needed": 0, "step_kernel": 0,
            "control_lanes": 0, "collide_and_init": 0, "solve_loop": 0,
            "bp_probe": 0, "collide_grid": n_steps, "iterblock_grid": 5 * n_steps,
            "grid_gates": n_steps, "grid_predict": n_steps, "grid_finalize": n_steps}
    if launches != want or refreshes == 0:
        fail(f"Stress4096 launch counts {launches}, expected {want} ({refreshes} refresh steps)")
    if host_reads != n_steps:
        fail(f"Stress4096 host reads {host_reads}, expected one per step")
    watch.check("Stress4096", n_steps)
    diag = w.diagnostics.as_dict()
    print(f"Stress4096 step {n_steps}: manifolds {int(diag['active_manifolds'])}, contacts "
          f"{int(diag['active_contacts'])}, max_pen {diag['max_penetration']:.6f}, "
          f"max_lin {diag['max_linear_speed']:.4f}")
    saved["settled"] = w
    traced = grid_step_trace(card, w, p, cap)

    k5_err, k6_err = 0.0, 0.0
    for label in ("landing", "settled"):
        wi = grid_inputs(saved[label], scene)
        e5, contacts = compare_k5(wi, scene, label)
        k5_err = max(k5_err, e5)
        a6 = k6_args(wi, scene, contacts)
        k6_err = max(k6_err, compare_k6(a6, label))
        if label == "settled":
            # The launch-per-half-sweep route: one logical block of all 5120
            # bodies fits no cluster.
            whole = (a6[0], wi.bodies.g) + a6[2:]
            k6_err = max(k6_err, compare_k6(whole, "settled, one logical block"))
            # A NaN pose after the lists were built: the precull culls its
            # slots as the plain version's torch.maximum does.
            for comp, axis in ((1, "y"), (0, "x")):
                compare_k5(nan_pose(wi, comp), scene, f"settled, a NaN pos.{axis}")

    fall_sps = 300 / marks[300]
    settled_sps = (n_steps - hold_from) / (t_run - marks[hold_from])
    print(f"[{card}] Stress4096 falling window (steps 0-300): {fall_sps:.1f} steps/s")
    print(f"[{card}] Stress4096 settled block (steps {hold_from + 1}-{n_steps}): "
          f"{settled_sps:.1f} steps/s")
    wi = grid_inputs(w, scene)
    a5 = k5_args(wi, scene)
    k5_ms = event_ms(lambda: solver_grid.collide_grid(*a5), 20)
    k5_plain_ms = event_ms(lambda: solver_grid.collide_grid_plain(*a5), 3)
    # K5 is two kernels a call: the filter (a warp per body) and the SAT (a
    # group of lanes per slot), which also writes the once-per-pair mask.
    k5_trace = trace_kernels(lambda: solver_grid.collide_grid(*a5), 20)
    if (len(k5_trace) != 2 or {k.split("<")[0]: c for k, (_us, c) in k5_trace.items()}
            != {"k_filter_cull": 1.0, "k_collide": 1.0}):
        fail(f"K5 is not one k_filter_cull and one k_collide a call: {k5_trace}")
    print(f"[{card}] K5 on the card alone (trace of 20 calls, settled Stress4096): "
          + ", ".join(f"{k} {us:.2f} us" for k, (us, _c) in sorted(k5_trace.items())))
    a6 = k6_args(wi, scene, solver_grid.collide_grid(*a5)[0])
    k6_ms = event_ms(lambda: solver_grid.iterblock_grid(*a6), 20)
    k6_plain_ms = event_ms(lambda: solver_grid.iterblock_grid_plain(*a6), 3)
    print(f"[{card}] grid collide kernel (K5, settled Stress4096): {k5_ms:.3f} ms, "
          f"plain {k5_plain_ms:.3f} ms")
    print(f"[{card}] grid iteration kernel (K6, one launch of {len(a6[2])} iterations): "
          f"{k6_ms:.3f} ms, plain {k6_plain_ms:.3f} ms")
    out5 = solver_grid.collide_grid(*a5)
    k5_bound = bound(nbytes(a5[:4], [getattr(a5[4], f) for f in ("pos", "quat", "size", "inv_mass")],
                            out5[0], out5[1:3]), float(out5[1].sum()) * OPS_SAT_PAIR)
    slots = int((a6[3].other >= 0).sum())
    out6 = solver_grid.iterblock_grid(*a6)
    k6_bound = bound(
        nbytes(a6[3], [getattr(a6[4], f) for f in ("mass", "inv_mass", "friction", "inertia",
                                                    "inv_inertia")], a6[5:], out6),
        len(a6[2]) * (slots * OPS_CONTACT_SLOT_SWEEP + wi.bodies.n * OPS_BODY_SWEEP))
    return {"settled": w, "params": p, "step 800": saved["step 800"], "scene": scene,
            "refreshes": refreshes, "launches": launches, "k5_err": k5_err, "k6_err": k6_err,
            "traced": traced,
            "k5_ms": k5_ms,
            "k5_plain_ms": k5_plain_ms, "k6_ms": k6_ms, "k6_plain_ms": k6_plain_ms,
            "k5_bound": k5_bound, "k6_bound": k6_bound, "k5_trace": k5_trace, "k6_args": a6}


# The most launches a Stress4096 grid step may make in a trace: K5's 2, K6's
# 5, the gates, the prediction and the finalize, the refresh kernels' 2 on a
# refresh step, and room for 3 more.
GRID_STEP_LAUNCHES = 16


def grid_step_trace(card, w, p, cap, steps: int = 20) -> dict:
    """``steps`` grid steps from ``w`` traced (utils/profile_phases.trace):
    every kernel on the card a step, held to GRID_STEP_LAUNCHES, and the
    port's own kernels to one each of the stage kernels and K5's, five of
    K6 and the refresh kernels once a refresh step; one host read a step.
    A trace that lost records is taken again, up to twice."""
    from avbd3d_tpu_torch import solver
    from avbd3d_tpu_torch.utils import profile_phases

    for attempt in range(3):
        before = solver.step.host_reads
        r = profile_phases.trace(w, p, cap, steps)
        reads = (solver.step.host_reads - before) / (2 * steps)
        per = r["launches"] / steps
        own = collections.Counter()
        for name, _us, c in r["kernels"]:
            if own_kernel(name):
                own[kernel_name(name).split("<")[0]] += c / steps
        other = {kernel_name(name)[:60]: c / steps for name, _us, c in r["kernels"]
                 if not own_kernel(name)}
        lists = own.pop("k_bp_tables", 0.0)
        want = {"k_grid_gates": 1.0, "k_grid_predict": 1.0, "k_filter_cull": 1.0,
                "k_collide": 1.0, "k_sweeps": 5.0, "k_grid_finalize": 1.0}
        if lists:
            want["k_bp_lists"] = lists
        counts_ok = {k: round(v, 6) for k, v in own.items()} == {
            k: round(v, 6) for k, v in want.items()}
        if counts_ok or attempt == 2:
            break
        print(f"Stress4096 traced grid steps: the trace lost records ({dict(own)}); "
              "tracing again")
    print(f"[{card}] Stress4096 grid steps, traced ({steps} steps from the settled state): "
          f"{per:.2f} launches a step ({dict(own)}, refresh kernels {lists:.2f} a step, "
          f"torch's {other}), device {r['device_us'] / steps:.1f} us a step, idle share "
          f"{100.0 * (1.0 - r['busy']):.1f}%, {r['wall_s'] * 1e3 / steps:.3f} ms a step "
          f"traced, {r['untraced_s'] * 1e3 / steps:.3f} untraced; host reads a step {reads:g}")
    if per > GRID_STEP_LAUNCHES or not counts_ok or reads != 1:
        fail(f"Stress4096 traced grid steps: {per} launches a step (at most "
             f"{GRID_STEP_LAUNCHES}), the port's {dict(own)} (expected {want}), host reads "
             f"{reads} a step")
    return {"launches_per_step": per, "device_us_per_step": r["device_us"] / steps,
            "idle_share": 1.0 - r["busy"], "ms_per_step": r["wall_s"] * 1e3 / steps,
            "untraced_ms_per_step": r["untraced_s"] * 1e3 / steps, "own": dict(own),
            "torch": other}


def low_drop_gate():
    """The reference's test_stress4096_envelope on the card: the low-drop
    16^3 pile with Stress4096's 28/16 plan, 60 landing + 30 settle steps;
    every settle step sanitized 0, overflow 0 at the end, and the worst
    settle penetration reported beside the slop and held to
    LOW_DROP_PEN_LIMIT."""
    from avbd3d_tpu_torch import solver

    w, p, cap = low_drop_stress(16, 16, 16, max_degree=28, cache_degree=16)
    if solver.select_path(w, cap) != "grid":
        fail("the low-drop 16^3 pile does not take the grid tier")
    w = solver.run_steps(w, p, cap, 60)
    worst = 0.0
    for _ in range(30):
        w = solver.step(w, p, cap)
        d = w.diagnostics.as_dict()
        worst = max(worst, d["max_penetration"])
        if d["sanitized"] != 0.0:
            fail(f"low-drop gate: sanitized {d['sanitized']}")
    if d["pair_overflow"] + d["degree_overflow"] != 0.0:
        fail(f"low-drop gate: overflow pair {d['pair_overflow']}, degree {d['degree_overflow']}")
    print(f"low-drop gate (16^3, 28/16, 60 + 30 steps): worst settle penetration "
          f"{worst:.6f} (slop {p.penetration_slop}, held to {LOW_DROP_PEN_LIMIT:.4f}), "
          f"overflow 0, sanitized 0, manifolds {int(d['active_manifolds'])}, "
          f"max_lin {d['max_linear_speed']:.3f}")
    if not worst <= LOW_DROP_PEN_LIMIT:
        fail(f"low-drop gate: penetration {worst} > {LOW_DROP_PEN_LIMIT}")
    return w, p, cap


def stress2048_phase(card: str):
    """Stress2048 on the fused path: 600 steps, the envelope after the
    landing, steps/s of the last 200 steps.  Returns (settled world,
    params)."""
    from avbd3d_tpu_torch import load_scene, solver, solver_cuda

    scene = load_scene("Stress2048", device="cuda")
    p, cap = scene.params, scene.cap
    w = scene.world
    if w.bodies.n != 2048 or solver.select_path(w, cap) != "fused":
        fail("Stress2048 is not the N = 2048 fused-path scene")
    n_steps, hold_from, t_from = 600, 400, 400
    watch = Watch(hold_from)
    reset_counts()
    sync()
    t0 = time.perf_counter()
    for i in range(n_steps):
        w = solver.step(w, p, cap)
        watch.add(i, w)
        if i + 1 == t_from:
            sync()
            t_mark = time.perf_counter()
    sync()
    sps = (n_steps - t_from) / (time.perf_counter() - t_mark)
    launches = read_counts()
    print(f"Stress2048: {n_steps} steps in {time.perf_counter() - t0:.2f} s; launches {launches}")
    if launches["step_kernel"] == 0 or launches["collide_grid"] + launches["iterblock_grid"]:
        fail(f"Stress2048 did not run on the fused path: {launches}")
    watch.check("Stress2048", n_steps)
    d = w.diagnostics.as_dict()
    print(f"[{card}] Stress2048 steps {t_from + 1}-{n_steps}: {sps:.1f} steps/s "
          f"(step {n_steps}: manifolds {int(d['active_manifolds'])}, "
          f"max_pen {d['max_penetration']:.6f})")
    err = compare_k1(k1_inputs(w, scene), "Stress2048 settled")
    return w, p, err


def low_drop_stress(nx, ny, nz, max_degree, cache_degree):
    """The reference's large-N gate scene (tests/test_large_n_envelope.py:
    26-51) on the port's SceneBuilder: the stress grid's jitter with the
    layers starting at y = 0.55, 1.05 apart, so the pile forms within ~40
    steps.  Returns (world on the card, params, cap)."""
    from avbd3d_tpu_torch import SceneBuilder, SolverParams
    from avbd3d_tpu_torch.convert import world_from_arrays
    from avbd3d_tpu_torch.models.scenes import _hash01

    sb = SceneBuilder()
    sb.add_body((100, 1, 100), 0.0, 0.5, (0, -0.5, 0))
    for y in range(ny):
        for z in range(nz):
            for x in range(nx):
                seed = (x + nx * (z + nz * y) + 1) & 0xFFFFFFFF
                jx = (_hash01((seed * 9781) & 0xFFFFFFFF) * 2 - 1) * 0.04
                jz = (_hash01((seed * 6271) & 0xFFFFFFFF) * 2 - 1) * 0.04
                jy = _hash01((seed * 3343) & 0xFFFFFFFF) * 0.25
                sb.add_body((1, 1, 1), 1.0, 0.5, (
                    (x - (nx - 1) * 0.5) * 1.15 + jx,
                    0.55 + y * 1.05 + jy,
                    (z - (nz - 1) * 0.5) * 1.15 + jz,
                ))
    params = SolverParams(iterations=20, beta=30000.0, gamma=0.995,
                          lhs_fresh_rebuild_every=4)
    arrays, params, cap, _ = sb.build(params, max_degree=max_degree,
                                      cache_degree=cache_degree)
    return world_from_arrays(arrays, "cuda"), params, cap


def grid_inputs(world, scene):
    """``world`` with the broadphase cache the next grid step would use
    (the refresh predicate and the refresh or reuse of solver._grid_step)."""
    from avbd3d_tpu_torch.ops.broadphase import refresh_needed, refresh_or_reuse

    p, b = scene.params, world.bodies
    need = bool(refresh_needed(world.bp, b, p.bp_margin))
    bp, _ = refresh_or_reuse(world.bp, need, b, world.exclusions, scene.cap.max_degree,
                             p.bp_margin)
    return world.replace(bp=bp)


def k5_args(world, scene):
    bp = world.bp
    return world.contacts, bp.nb, bp.key, bp.thr, world.bodies, scene.params


def k6_args(world, scene, contacts):
    """K6's operands for the first launch of the next step of ``world``
    (cache from K5, prediction as solver_grid.step_grid computes it)."""
    import torch

    from avbd3d_tpu_torch import solver, solver_grid

    b, p = world.bodies, scene.params
    g = b.g
    _lv, _av, ip, iq, ps, qs, _san = solver.predict(b, p)

    def cg(a):
        return a.T.contiguous().reshape(a.shape[1], g, 128)

    spec = solver_grid.grid_specs(p, p.iterations, p.lhs_rebuild_every,
                                  scene.cap.grid_residency)[0]
    return (p, solver_grid.pick_gb(g), spec, contacts, b, cg(ps), cg(qs), contacts.lam,
            contacts.penalty, contacts.stick.to(torch.float32), cg(ip), cg(iq))


def compare_k5(world, scene, label: str):
    """K5 kernel vs plain: integers (slots, counts, feature ids, stick
    latches, kept and once masks, dropped count) identical, floats with
    difference 0 (the same float32 operations in the same order on both
    sides; the lanes of a slot's group pick the serial scans' indices).
    Returns (max abs float error, the kernel's contacts)."""
    from avbd3d_tpu_torch import solver_cuda, solver_grid

    args = k5_args(world, scene)
    cp, kp, op, dp = solver_grid.collide_grid_plain(*args)
    ck, kk, ok, dk = solver_grid.collide_grid(*args)
    sync()
    err = 0.0
    for f in solver_cuda.CACHE_FIELDS:
        a, b = getattr(cp, f), getattr(ck, f)
        if a.dtype.is_floating_point:
            err = max(err, float_diff(a, b))
        elif bool((a != b).any()):
            fail(f"K5 {label}: cache.{f} differs in {int((a != b).sum())} entries")
    if err != 0.0:
        fail(f"K5 {label}: cache floats differ from the plain version by up to {err}")
    for name, a, b in (("kept", kp, kk), ("once", op, ok)):
        if bool((a != b).any()):
            fail(f"K5 {label}: {name} mask differs in {int((a != b).sum())} entries")
    if int(dp) != int(dk):
        fail(f"K5 {label}: dropped {int(dp)} vs {int(dk)}")
    print(f"K5 vs plain ({label}): integers and masks identical, manifolds "
          f"{int((ck.count > 0).sum())}, kept {int(kk.sum())}, dropped {int(dk)}, "
          f"float max abs err {err:.3e}")
    return err, ck


def compare_k6(args, label: str) -> float:
    """K6 kernel vs plain for one launch: stick latches identical, poses
    and separations held to 1e-5 absolute, lambda/penalty to 1e-5 relative
    (the same float32 operations in the same order, as K1)."""
    from avbd3d_tpu_torch import solver_grid

    outs_p = solver_grid.iterblock_grid_plain(*args)
    outs_k = solver_grid.iterblock_grid(*args)
    sync()
    names = ("pos", "quat", "lam", "pen", "stick", "sep")
    err = 0.0
    for name, a, b in zip(names, outs_p, outs_k):
        if name == "stick":
            if bool((a != b).any()):
                fail(f"K6 {label}: stick differs in {int((a != b).sum())} latches")
            continue
        abs_err = float((a - b).abs().max())
        if name in ("lam", "pen"):
            bad = float(((a - b).abs() / (a.abs() + 1.0)).max()) > 1e-5
        else:
            bad = abs_err > 1e-5
            err = max(err, abs_err)
        if bad:
            fail(f"K6 {label}: {name} max abs err {abs_err}")
    from avbd3d_tpu_torch import solver_cuda

    route = solver_cuda.sweep_plan(args[4].n, args[3].other.shape[0], args[1] * 128).route
    print(f"K6 vs plain ({label}, {len(args[2])} iterations, gb={args[1]}, route {route}): "
          f"stick identical, pose/sep max abs err {err:.3e}")
    return err


# ---------------------------------------------------------------------------
# Jointed worlds (K1's joint/spring branch) and the profiler path (K3/K4)
# ---------------------------------------------------------------------------

def run_counted(w, p, cap, n_steps, watch=None, at=()):
    """``n_steps`` steps from ``w`` with the counters reset before and read
    after; returns (world, launches, seconds, {step: world} for ``at``,
    refresh steps)."""
    from avbd3d_tpu_torch import solver

    saved = {}
    refreshes = 0
    reset_counts()
    sync()
    t0 = time.perf_counter()
    for i in range(n_steps):
        w = solver.step(w, p, cap)
        refreshes += int(solver.step.last_gates["refreshed"])
        if watch is not None:
            watch.add(i, w)
        if i + 1 in at:
            saved[i + 1] = w
    sync()
    return w, read_counts(), time.perf_counter() - t0, saved, refreshes


def world_anchor(w, body, local):
    """World position of a body-local point (numpy, float64)."""
    import numpy as np

    pos = w.bodies.pos_n3[body].double().cpu().numpy()
    x, y, z, qw = w.bodies.quat_n4[body].double().cpu().numpy()
    v = np.asarray(local, np.float64)
    qv = np.asarray([x, y, z])
    t = 2.0 * np.cross(qv, v)
    return pos + v + qw * t + np.cross(qv, t)


def expect_fused_only(label, launches, n_steps, refreshes):
    """Every step of a jointed world through the gates kernel and K1 (no
    ballistic step: the gate needs dj == 0 and ds == 0), the refresh kernels
    once a refresh step, no other kernel."""
    want = dict.fromkeys(launches, 0)
    want["step_gates"] = want["step_kernel"] = n_steps
    want["candidate_lists"] = refreshes
    if launches != want:
        fail(f"{label}: launch counts {launches}, expected {want}")


def rod_jointed_phase(card):
    """RodJointed, 600 steps, held to the reference's slow tests
    (test_components.py:23-38, test_joint_dual_tension.py)."""
    import numpy as np

    from avbd3d_tpu_torch import load_scene

    sc = load_scene("RodJointed", device="cuda")
    p, cap = sc.params, sc.cap
    if (sc.world.joints.dj, cap.joint_colors, p.iterations) != (2, 2, 20):
        fail("RodJointed is not the DJ = 2, 2-colour, 20-iteration scene")
    watch = Watch(600)
    w, launches, t_run, saved, refreshes = run_counted(sc.world, p, cap, 600, watch,
                                                       at=(30, 200))
    expect_fused_only("RodJointed", launches, 600, refreshes)
    worst = watch.worst.tolist()
    if not bool(watch.finite) or worst[8] != 0.0:
        fail(f"RodJointed: sanitized {worst[8]} or non-finite poses")
    w200 = saved[200]
    top = w200.bodies.pos_n3[0].double().cpu().numpy()
    if float(np.abs(top - [0.0, 10.0, 0.0]).max()) > 1e-5:
        fail(f"RodJointed: static anchor moved to {top}")
    gaps = [float(np.linalg.norm(world_anchor(w200, k, (0.0, -0.5, 0.0))
                                 - world_anchor(w200, k + 1, (0.0, 0.5, 0.0)))) for k in range(14)]
    if max(gaps) >= 0.02:
        fail(f"RodJointed: welded anchor gap {max(gaps)} >= 0.02 at step 200")
    d = w.diagnostics.as_dict()
    if not d["max_linear_speed"] < 0.02:
        fail(f"RodJointed: max linear speed {d['max_linear_speed']} at step 600")
    other, side = w.joints.other.cpu().numpy(), w.joints.side.cpu().numpy()
    lam_y = w.joints.lam[1].cpu().numpy()
    m, g = 0.25 * 1.0 * 0.25 * 1.0, 10.0
    errs = []
    for k in range(14):                      # joint k welds segment k -> k + 1
        body = k + 1                         # the B-side replica
        slot = np.where((other[:, 0, body] == k) & (side[:, 0, body] < 0))[0]
        errs.append(abs(float(lam_y[slot[0], 0, body]) / ((14 - k) * m * g) - 1.0))
    if max(errs) >= 0.05:
        fail(f"RodJointed: worst link tension error {max(errs):.4f} >= 5%")
    print(f"RodJointed: 600 steps in {t_run:.2f} s ({600 / t_run:.1f} steps/s) [{card}]; "
          f"K1 launches {launches['step_kernel']}; sanitized 0; anchor gap max "
          f"{max(gaps):.2e} at step 200; max_lin {d['max_linear_speed']:.2e} at step 600; "
          f"worst link tension error {max(errs) * 100:.3f}%")
    return sc, saved[30], w


def soft_grid_phase():
    """SoftGrid, 150 steps (test_components.py:107-115).  The sheet's
    step-1 speed is printed: the reference's angular weld rows push away
    from the rest orientation (ROADMAP Queue 3), which the port keeps."""
    from avbd3d_tpu_torch import load_scene

    sc = load_scene("SoftGrid", device="cuda")
    watch = Watch(150)
    w, launches, t_run, saved, refreshes = run_counted(sc.world, sc.params, sc.cap, 150, watch,
                                                       at=(1, 5))
    expect_fused_only("SoftGrid", launches, 150, refreshes)
    if not bool(watch.finite) or watch.worst[8].item() != 0.0:
        fail("SoftGrid: sanitized or non-finite poses")
    pos = w.bodies.pos_n3[1:sc.n_real]
    big, low = float(pos.abs().max()), float(pos[:, 1].min())
    if not (big < 25.0 and low > -0.3):
        fail(f"SoftGrid: max |pos| {big}, min y {low}")
    d = saved[5].diagnostics.as_dict()
    print(f"SoftGrid: 150 steps in {t_run:.2f} s; sanitized 0; max |pos| {big:.3f}, min y "
          f"{low:.4f}; step 1 max_lin {saved[1].diagnostics.as_dict()['max_linear_speed']:.3f}; "
          f"step 5: {int(d['active_manifolds'])} manifolds")
    return sc, saved[5]


def small_worlds_phase():
    """The spring equilibrium and the world joint of test_components.py:65-88."""
    from avbd3d_tpu_torch import SceneBuilder, SolverParams
    from avbd3d_tpu_torch.convert import world_from_arrays

    sb = SceneBuilder()
    a = sb.add_body((1, 1, 1), 0.0, 0.5, (0.0, 5.0, 0.0))
    b = sb.add_body((1, 1, 1), 1.0, 0.5, (0.0, 3.0, 0.0))
    sb.add_spring(a, b, (0, 0, 0), (0, 0, 0), stiffness=100.0)
    arrays, p, cap, _ = sb.build(SolverParams())
    w, launches, _t, _s, refreshes = run_counted(world_from_arrays(arrays, "cuda"), p, cap, 600)
    expect_fused_only("spring world", launches, 600, refreshes)
    dist = float((w.bodies.pos_n3[0] - w.bodies.pos_n3[1]).norm())
    manifolds = w.diagnostics.as_dict()["active_manifolds"]
    if not (abs(dist - 2.1) < 0.03 and manifolds == 0):
        fail(f"spring world: distance {dist} (want 2.1 +- 0.03), manifolds {manifolds}")

    sb = SceneBuilder()
    b = sb.add_body((1, 1, 1), 1.0, 0.5, (0.0, 5.0, 0.0))
    sb.add_world_joint(b, (0.0, 5.5, 0.0))
    arrays, p, cap, _ = sb.build(SolverParams())
    wj, launches, _t, _s, refreshes = run_counted(world_from_arrays(arrays, "cuda"), p, cap, 120)
    expect_fused_only("world joint", launches, 120, refreshes)
    drift = float(abs(world_anchor(wj, 0, (0.0, 0.5, 0.0)) - [0.0, 5.5, 0.0]).max())
    if not drift < 0.02:
        fail(f"world joint: pinned anchor off by {drift}")
    print(f"spring world: distance {dist:.4f} after 600 steps (2.1 +- 0.03), manifolds 0; "
          f"world joint: anchor off by {drift:.2e} after 120 steps")


def narrow_cache_rod(device="cuda"):
    """A rod of four segments hard-welded below a static top segment, and a
    cube resting on a slab, with a contact cache of width 1 (D = 8, DC = 1,
    two joint slots a body, two colours): a world whose
    sub-pass row terms (27 x 2 a body) outnumber its contact partials (30 x
    1), so they size the resident joint launch's shared memory.  The same
    world as tests/test_torch_sweep_plan.py's."""
    from avbd3d_tpu_torch import SceneBuilder, SolverParams
    from avbd3d_tpu_torch.convert import world_from_arrays

    sb = SceneBuilder()
    sb.add_body((40, 1, 40), 0.0, 0.5, (0, -0.5, 0))
    sb.add_body((1, 1, 1), 1.0, 0.5, (3.0, 0.55, 0.0))
    prev = None
    for i in range(5):
        cur = sb.add_body((0.25, 1, 0.25), 0.0 if i == 0 else 1.0, 0.5, (0, 6.0 - i, 0))
        if prev is not None:
            sb.add_joint(prev, cur, (0, -0.5, 0), (0, 0.5, 0))
        prev = cur
    arrays, p, cap, _ = sb.build(SolverParams(iterations=20), max_degree=8, cache_degree=1)
    return world_from_arrays(arrays, device), p, cap


def sheets_world(n_sheets=20):
    """``n_sheets`` copies of SoftGrid's sheet side by side along z at 1.0 m
    pitch on one ground slab: 2001 bodies, N = 2048, 3,600 soft joints,
    one colour, D = DC = 32."""
    from avbd3d_tpu_torch import SceneBuilder, SolverParams
    from avbd3d_tpu_torch.convert import world_from_arrays
    from avbd3d_tpu_torch.models.scenes import soft_sheet

    sb = SceneBuilder()
    sb.add_body((100, 1, 100), 0.0, 0.5, (0, -0.5, 0))
    for k in range(n_sheets):
        soft_sheet(sb, z=(k - (n_sheets - 1) * 0.5) * 1.0)
    arrays, p, cap, n_real = sb.build(SolverParams())
    return world_from_arrays(arrays, "cuda"), p, cap, n_real


def sheets_phase(card):
    """The jointed workload at the fused path's full width: 300 steps.

    Held: sanitized 0, degree overflow 0, finite poses, every step
    through K1.  Reported, not held: pair overflow and max |pos|.  Each
    sheet inherits SoftGrid's angular weld fault (ROADMAP Queue 3): the
    sheets leave the slab at ~40 m/s within their first steps and tumble
    into each other, so their candidate lists overflow D = 32 and bodies
    pass |pos| = 25.  With that force negated the same world keeps pair
    overflow 0 and |pos| < 25 (utils/weld_sign_probe.py)."""
    from avbd3d_tpu_torch import solver, solver_cuda

    w, p, cap, n_real = sheets_world()
    shape = (n_real, w.bodies.n, w.bodies.g, w.joints.dj, int((w.joints.other >= 0).sum()) // 2,
             cap.joint_colors, cap.max_degree, w.contacts.other.shape[0])
    if shape != (2001, 2048, 16, 4, 3600, 1, 32, 32) or solver.select_path(w, cap) != "fused":
        fail(f"20-sheet world is not N = 2048 / 3600 soft joints / D = DC = 32: {shape}")
    watch = Watch(300)
    w, launches, t_run, saved, refreshes = run_counted(w, p, cap, 300, watch, at=(100,))
    expect_fused_only("20 sheets", launches, 300, refreshes)
    worst = watch.worst.tolist()
    if not bool(watch.finite) or worst[8] != 0.0 or worst[10] != 0.0:
        fail(f"20 sheets: sanitized {worst[8]}, degree overflow {worst[10]}")
    big = float(w.bodies.pos_n3[1:n_real].abs().max())
    scene = types.SimpleNamespace(params=p, cap=cap)
    a1 = k1_inputs(w, scene)
    ms = event_ms(lambda: solver_cuda.step_kernel(*a1), 20)
    plain_ms = event_ms(lambda: solver_cuda.step_kernel_plain(*a1), 2)
    d = w.diagnostics.as_dict()
    print(f"[{card}] 20 sheets (N = 2048, 3600 soft joints): 300 steps in {t_run:.2f} s = "
          f"{300 / t_run:.1f} steps/s; K1 {ms:.3f} ms per step ({a1[8]} iterations), plain "
          f"{plain_ms:.1f} ms; sanitized 0, degree overflow 0; reported: worst pair overflow "
          f"{worst[9]:.0f}, max_lin {worst[2]:.2f}; step 300: {int(d['active_manifolds'])} "
          f"manifolds, max |pos| {big:.2f}, max_pen {d['max_penetration']:.4f}")
    return {"scene": scene, "state": saved[100], "args": a1, "ms": ms, "plain_ms": plain_ms,
            "launches": launches["step_kernel"]}


# The kernels of the broadphase refresh (csrc/bp_refresh.cu): one call of
# ``candidate_lists`` on the card queues each of REFRESH_KERNELS once; the
# refresh predicate is PREDICATE_KERNEL, once a call.
REFRESH_KERNELS = ("k_bp_tables", "k_bp_lists")
PREDICATE_KERNEL = "k_refresh_needed"


def profiled_kernels(scene_name: str, warm: int, steps: int, per_step: int):
    """``profile_phases.profile`` of ``steps`` steps after ``warm`` steps of
    ``scene_name``, and its traced kernels of csrc/ but the refresh kernels
    and the gates kernel ({name: count}).  The refresh kernels are held to
    the refresh steps of the traced block, which the counters give: its
    untraced twin and the traced block run the same steps from the same
    state, and a run of the ``warm`` steps of its own counts their
    refreshes.  The gates kernel, one a step, is held by the launch
    counters, not here.  The kernels are counted in a session of their own
    over the same block (``block_kernels``, opened by two K7 launches left
    out of the count): the profiler loses one of the first records of the
    port's kernels in a session (seen: the first step's gates, a
    ``k_filter_cull`` of profile_phases' own session), and on
    some runs a few more, so a count whose other kernels are fewer than
    ``per_step`` a step is taken again, up to twice; the callers hold the
    last one.  Returns (profile's numbers, the other kernels, the traced
    block's refresh steps)."""
    from avbd3d_tpu_torch import load_scene, solver
    from avbd3d_tpu_torch.utils import profile_phases

    sc = load_scene(scene_name, device="cuda")
    w, warm_refreshes = sc.world, 0
    for _ in range(warm):
        w = solver.step(w, sc.params, sc.cap)
        warm_refreshes += int(solver.step.last_gates["refreshed"])
    for attempt in range(3):
        reset_counts()
        r = profile_phases.profile(scene_name, warm, steps, "cuda")
        calls = read_counts()["candidate_lists"] - warm_refreshes
        own = collections.Counter(block_kernels(w, sc.params, sc.cap, steps))
        lists = [own.pop(k, 0) for k in REFRESH_KERNELS]
        own.pop("k_step_gates", None)
        whole = (not calls % 2 and lists == [calls // 2] * len(REFRESH_KERNELS)
                 and sum(own.values()) == per_step * steps)
        if whole or attempt == 2:
            break
        print(f"profile_phases, {scene_name}: the trace lost records (refresh kernels "
              f"{lists}, {dict(own)}); tracing again")
    if calls % 2 or lists != [calls // 2] * len(REFRESH_KERNELS):
        fail(f"profile_phases, {scene_name} {warm} + {steps} steps: the refresh kernels "
             f"{REFRESH_KERNELS} traced {lists} times, the counters say {calls} refreshes in "
             "the untraced and traced blocks together")
    return r, dict(own), calls // 2


def trace_kernels(fn, reps: int) -> dict:
    """The port's kernels in a torch.profiler trace of ``reps`` calls of
    ``fn``: {name: (device us per call, launches per call)}."""
    import torch

    from avbd3d_tpu_torch.utils import profile_phases

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        # The profiler misses the first kernel of a session on some runs:
        # let that be a torch kernel of its own, which is not counted.
        torch.zeros(1, device="cuda")
        sync()
        for _ in range(reps):
            fn()
        sync()
    out = {}
    for e in prof.key_averages():
        if own_kernel(e.key):
            name = kernel_name(e.key)
            us, count = out.get(name, (0.0, 0.0))
            out[name] = (us + profile_phases.device_time_us(e) / reps, count + e.count / reps)
    return out


def joint_step_trace(card, label, step_fn, args, n_steps: int, refreshed: bool):
    """``n_steps`` calls of ``step_fn`` (steps of a jointed world) traced:
    the port's kernels per step must be the sweep plan's
    ``step_kernel_count``, one of them the resident joint kernel, and none
    of the launch-per-sub-pass kernels; besides them the gates kernel once a
    call and the refresh kernels, one each a call when the step refreshes
    (``refreshed``)."""
    from avbd3d_tpu_torch import solver_cuda

    b, j, sp = args[4], args[11], args[12]
    dj, ds = (j.dj if j is not None else 0), (sp.ds if sp is not None else 0)
    plan = solver_cuda.sweep_plan(b.n, args[0].other.shape[0], None, dj, ds)
    iters = args[8] + int(args[7].post_stabilize)
    per_step = solver_cuda.step_kernel_count(plan, iters, dj, ds)
    # A trace that lost records (see one_kernel_times) is taken again, up
    # to twice.
    for attempt in range(3):
        t = trace_kernels(step_fn, n_steps)
        gates = t.pop("k_step_gates", (0.0, 0.0))[1]
        lists = [t.pop(k, (0.0, 0.0))[1] for k in REFRESH_KERNELS]
        total = sum(c for _us, c in t.values())
        if (gates, total) == (1, per_step) or attempt == 2:
            break
        print(f"{label}: the trace lost records (gates {gates}, {t}); tracing again")
    if gates != 1:
        fail(f"{label}: the gates kernel ran {gates} times a step")
    lists = [round(c) for c in lists]
    if lists != [int(refreshed)] * len(REFRESH_KERNELS):
        fail(f"{label}: the refresh kernels {REFRESH_KERNELS} ran {lists} times a step, the "
             f"step {'refreshes' if refreshed else 'reuses its lists'}")
    resident = sum(c for name, (_us, c) in t.items() if name.startswith("k_joint_sweeps"))
    if total != per_step or resident != 1 or any(k in t for k in ("k_subpass", "k_contact_acc")):
        fail(f"{label}: the trace shows {total} of the port's kernels a step ({t}), the plan "
             f"({plan.route}) says {per_step} with one resident joint launch")
    print(f"[{card}] {label}, traced: {total:.0f} kernels a step (the sweep plan's {per_step}, "
          f"route {plan.route}); device us a step: "
          + ", ".join(f"{k} {us:.1f}" for k, (us, _c) in sorted(t.items())))
    return t


def jointed_phases(card) -> dict:
    """RodJointed, SoftGrid, the spring and world-joint worlds and the
    20-sheet world through K1's joint branch, then K1 with joints against
    its plain version at a state of each of the three scenes, on the route
    ``sweep_plan`` gives each (one cluster at 128 bodies, the cooperative
    grid barrier at 2048), and the traced kernels of a jointed step held to
    ``step_kernel_count``."""
    from avbd3d_tpu_torch import solver, solver_cuda
    from avbd3d_tpu_torch.utils import profile_phases

    rod_scene, rod_state, rod_world = rod_jointed_phase(card)
    soft_scene, soft_state = soft_grid_phase()
    small_worlds_phase()
    sheets = sheets_phase(card)
    states = {"RodJointed step 30": k1_inputs(rod_state, rod_scene),
              "SoftGrid step 5": k1_inputs(soft_state, soft_scene),
              "20 sheets step 100": k1_inputs(sheets["state"], sheets["scene"])}
    err = 0.0
    for (label, args), route in zip(states.items(), ("cluster", "cluster", "grid")):
        plan = solver_cuda.sweep_plan(args[4].n, args[0].other.shape[0], None, args[11].dj)
        if plan.route != route:
            fail(f"{label}: the joint branch's plan is {plan}, expected the {route} route")
        err = max(err, compare_k1(args, f"{label}, {plan.route} route"))
    cw, cp, ccap = narrow_cache_rod()
    cargs = k1_inputs(solver.run_steps(cw, cp, ccap, 20), types.SimpleNamespace(params=cp, cap=ccap))
    plan = solver_cuda.sweep_plan(cargs[4].n, cargs[0].other.shape[0], None, cargs[11].dj)
    if (plan.route, cargs[0].other.shape[0], cargs[11].dj, ccap.joint_colors) != ("cluster", 1, 2, 2):
        fail(f"narrow-cache rod: plan {plan}, DC {cargs[0].other.shape[0]}, DJ {cargs[11].dj}, "
             f"{ccap.joint_colors} colours; expected one cluster at DC = 1, DJ = 2, 2 colours")
    err = max(err, compare_k1(cargs, "narrow-cache rod step 20, DC = 1, cluster route"))
    # profile_phases on a named jointed scene, and a trace of sheet steps.
    rod_args = states["RodJointed step 30"]
    per_step = solver_cuda.step_kernel_count(
        solver_cuda.sweep_plan(128, rod_args[0].other.shape[0], None, 2), 20, 2)
    _r, own, rod_refreshes = profiled_kernels("RodJointed", 30, 20, per_step)
    resident = sum(c for name, c in own.items() if name.startswith("k_joint_sweeps"))
    if sum(own.values()) != 20 * per_step or resident != 20:
        fail(f"profile_phases, 20 RodJointed steps: {own}, the plan says {per_step} a step")
    print(f"profile_phases, 20 RodJointed steps: {sum(own.values()) / 20:.0f} of the port's kernels "
          f"a step (the plan's {per_step}): {own}; and the refresh kernels once each on its "
          f"{rod_refreshes} refresh steps")
    w, p, cap = sheets["state"], sheets["scene"].params, sheets["scene"].cap
    solver.step(w, p, cap)
    trace = joint_step_trace(card, "20 sheets, 5 steps from step 100",
                             lambda: solver.step(w, p, cap), states["20 sheets step 100"], 5,
                             solver.step.last_gates["refreshed"])
    return {**sheets, "err": err, "states": states, "trace": trace,
            "rod": (rod_scene, rod_world)}


def compare_k3(a3, label: str):
    """K3 (``collide_and_init``) against ``collide_half`` on the same
    operands: integers identical, floats difference 0 (a NaN matching a
    NaN).  Returns the kernel's cache, its kept count and the difference."""
    from avbd3d_tpu_torch import solver_cuda

    cp, kp, dp = solver_cuda.collide_half(*a3)
    ck, kk, dk = solver_cuda.collide_and_init(*a3)
    sync()
    err3 = 0.0
    for f in solver_cuda.CACHE_FIELDS:
        a, b = getattr(cp, f), getattr(ck, f)
        if a.dtype.is_floating_point:
            err3 = max(err3, float_diff(a, b))
        elif bool((a != b).any()):
            fail(f"K3 ({label}): cache.{f} differs in {int((a != b).sum())} entries")
    if err3 != 0.0:
        fail(f"K3 ({label}): cache floats differ from the plain version by up to {err3}")
    if (int(kp), int(dp)) != (int(kk), int(dk)):
        fail(f"K3 ({label}): kept/dropped {int(kp)}/{int(dp)} vs {int(kk)}/{int(dk)}")
    print(f"K3 vs plain ({label}): integers identical, kept {int(kk)}, float difference "
          f"{err3:.1e}")
    return ck, kk, err3


def profiler_phase(w, scene, card) -> dict:
    """K3 and K4 against their plain versions at the settled Stress1000
    state ``w``, then utils/profile_cuda's table (its K3/K4 launches
    counted), and each kernel's time."""
    from avbd3d_tpu_torch import solver_cuda
    from avbd3d_tpu_torch.ops.broadphase import build_bp_cache
    from avbd3d_tpu_torch.utils import profile_cuda

    p, cap = scene.params, scene.cap
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, cap.max_degree, p.bp_margin))
    a3 = (w.contacts, w.bp.nb, w.bp.key, w.bp.thr, w.bodies, p)
    ck, kk, err3 = compare_k3(a3, "settled Stress1000")
    for comp, axis in ((1, "y"), (0, "x")):
        compare_k3((*a3[:4], nan_pose(w, comp).bodies, p), f"settled Stress1000, a NaN pos.{axis}")
    a4 = (ck, w.bodies, p)
    op = solver_cuda.solve_loop_plain(*a4)
    ok = solver_cuda.solve_loop(*a4)
    sync()
    if bool((op[3] != ok[3]).any()) or not bool((op[4][0, 5:9] == ok[4][0, 5:9]).all()):
        fail("K4: stick latches or count lanes differ")
    err4 = max(float((getattr(op[0], f) - getattr(ok[0], f)).abs().max())
               for f in ("pos", "quat", "linvel", "angvel"))
    for x, y, name in ((op[1], ok[1], "lam"), (op[2], ok[2], "penalty"), (op[4], ok[4], "diag")):
        if float(((x - y).abs() / (x.abs() + 1.0)).max()) > 1e-5:
            fail(f"K4: {name} differs")
    if err4 > 1e-5:
        fail(f"K4: body outputs max abs err {err4}")
    print(f"K4 vs plain ({p.iterations} iterations): stick identical, body max abs err "
          f"{err4:.3e}")
    reset_counts()
    rows = profile_cuda.profile("Stress1000", 300, "cuda")
    launches = read_counts()
    if launches["collide_and_init"] == 0 or launches["solve_loop"] == 0:
        fail(f"the profiler did not launch K3 and K4: {launches}")
    ms3 = event_ms(lambda: solver_cuda.collide_and_init(*a3), 20)
    plain3 = event_ms(lambda: solver_cuda.collide_half(*a3), 3)
    ms4 = event_ms(lambda: solver_cuda.solve_loop(*a4), 20)
    plain4 = event_ms(lambda: solver_cuda.solve_loop_plain(*a4), 2)
    print(f"[{card}] collide kernel (K3): {ms3:.3f} ms, plain {plain3:.3f} ms; solve-loop "
          f"kernel (K4, {p.iterations} iterations): {ms4:.3f} ms, plain {plain4:.3f} ms; "
          f"profiler launches K3 {launches['collide_and_init']}, K4 {launches['solve_loop']}")
    return {"rows": rows, "launches": launches, "err3": err3, "err4": err4, "ms3": ms3,
            "plain3": plain3, "ms4": ms4, "plain4": plain4, "a3": a3, "a4": a4}


# ---------------------------------------------------------------------------
# K7 (the broadphase probe) with the refined gate, and the application layer
# ---------------------------------------------------------------------------

def compare_k7(world, params, label: str):
    """K7 kernel vs plain on the cached slots and poses of ``world``: min,
    or and an integer sum do not depend on order and every float statement
    repeats the plain version's, so all three outputs must be equal, bit
    for bit.  Returns |min_sep difference| (0.0 or the run has failed)."""
    import torch

    from avbd3d_tpu_torch import solver_cuda

    nb, b = world.bp.nb, world.bodies
    sp, np_, nearp = solver_cuda.bp_probe_plain(nb, b, params)
    sk, nk, neark = solver_cuda.bp_probe(nb, b, params)
    sync()
    if int(np_) != int(nk):
        fail(f"K7 {label}: n_slots {int(np_)} vs {int(nk)}")
    if not torch.equal(nearp, neark):
        fail(f"K7 {label}: near differs at {int((nearp != neark).sum())} bodies")
    if not same_bits(sp, sk):
        fail(f"K7 {label}: min_sep {float(sp)!r} vs {float(sk)!r}")
    print(f"K7 vs plain ({label}, N = {b.n}, D = {nb.shape[0]}): n_slots {int(nk)}, near "
          f"{int(neark.sum())} bodies, min_sep {float(sk):.6f}: all identical")
    return float((sp - sk).abs())


def probe_phase(card, scene, states) -> dict:
    """Phase 10.  ``states``: {label: (world, params)} for the comparisons."""
    import torch

    from avbd3d_tpu_torch import load_scene, solver, solver_cuda

    p, cap = scene.params, scene.cap
    w = load_scene("Stress1000", device="cuda").world
    n_steps = 300
    rows = []
    reset_counts()
    solver.step.host_reads = 0
    for _ in range(n_steps):
        before = solver_cuda.bp_probe.launches
        refined = solver.stale_lhs_ok(w.bodies, w.bp, p)
        if solver_cuda.bp_probe.launches != before + 1:
            fail("the refined gate did not launch K7 exactly once")
        unrefined = solver.stale_lhs_ok(w.bodies, w.bp, p, refine=False)
        nxt = solver.step(w, p, cap)
        # The slots this step used (its refreshed cache) at the pre-step poses.
        min_sep, n_slots, _near = solver_cuda.bp_probe(nxt.bp.nb, w.bodies, p)
        rows.append(torch.stack([refined.float(), unrefined.float(), min_sep, n_slots.float(),
                                 nxt.bp.cand.float(), nxt.diagnostics.vec[5]]))
        w = nxt
    sync()
    launches = read_counts()
    if solver.step.host_reads != n_steps:
        fail(f"the gates added host reads: {solver.step.host_reads} in {n_steps} steps")
    if launches["bp_probe"] != 2 * n_steps:
        fail(f"K7 launches {launches['bp_probe']}, expected {n_steps} through the gate and "
             f"{n_steps} direct")
    t = torch.stack(rows).cpu()
    refined, unrefined = t[:, 0] > 0.5, t[:, 1] > 0.5
    if bool((unrefined & ~refined).any()):
        fail("the refined gate is False at a step where the unrefined gate is True")
    proven = (t[:, 2] > p.collision_margin) & (t[:, 3] == t[:, 4])
    if bool((proven & (t[:, 5] != 0)).any()):
        fail("K7 proved a step contact-free that found contacts")
    print(f"refined gate, Stress1000 steps 1-{n_steps}: K7 launches {launches['bp_probe']} "
          f"({n_steps} through stale_lhs_ok, {n_steps} direct), host reads {n_steps} (the "
          f"step's own); unrefined True at {int(unrefined.sum())} steps, refined at "
          f"{int(refined.sum())}: they differ at {int((refined != unrefined).sum())} steps; "
          f"K7 proved {int(proven.sum())} steps contact-free, all with 0 contacts "
          f"({int((t[:, 5] > 0).sum())} steps had contacts)")

    err = max(compare_k7(wd, pr, label) for label, (wd, pr) in states.items())
    times = {}
    for label in ("Stress1000 settled", "Stress4096 settled"):
        wd, pr = states[label]
        nb, b = wd.bp.nb, wd.bodies
        times[label] = one_kernel_times(
            card, f"broadphase probe kernel (K7, {label}, N = {b.n}, D = {nb.shape[0]})",
            "k_probe", lambda: solver_cuda.bp_probe(nb, b, pr),
            lambda: solver_cuda.bp_probe_plain(nb, b, pr))
        outs = solver_cuda.bp_probe(nb, b, pr)
        times[label]["bound"] = bound(
            nbytes(nb, [getattr(b, f) for f in ("pos", "quat", "size", "radius", "linvel",
                                                "angvel")], outs),
            int(outs[1]) * OPS_PROBE_SLOT)
        print(f"    bound {times[label]['bound'][0]:.7f} ms ({times[label]['bound'][1]})")
    t = times["Stress1000 settled"]
    return {"launches": launches["bp_probe"], "err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound": t["bound"], "device_us": t["device_us"], "grid": times["Stress4096 settled"]}


def leaves(world):
    """Every body and contact-cache leaf of ``world``, by name."""
    out = {}
    for group in ("bodies", "contacts"):
        obj = getattr(world, group)
        for f in obj.__dataclass_fields__:
            out[f"{group}.{f}"] = getattr(obj, f)
    return out


def app_phase(card, scene, landing, settled):
    """Phase 11: the CLI, checkpoint/resume, pick, the viewer's Sim and
    profile_phases on the card.  ``landing`` / ``settled``: Stress1000 at
    steps 150 / 700."""
    import torch

    from avbd3d_tpu_torch import pick, solver, solver_cuda
    from avbd3d_tpu_torch.maths import quat_rotate
    from avbd3d_tpu_torch.utils import profile_phases
    from avbd3d_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from avbd3d_tpu_torch.viewer import Sim

    p, cap, n_real = scene.params, scene.cap, scene.n_real
    here = os.path.dirname(os.path.abspath(__file__))
    kind = torch.cuda.get_device_name(0)

    # The headless CLI, as a user starts it (no --device: the card).
    cli = [sys.executable, "-m", "avbd3d_tpu_torch.cli", "--nogfx", "--scene", "Stress1000"]
    t0 = time.perf_counter()
    run = subprocess.run(cli + ["--steps", "20"], cwd=here, capture_output=True, text=True,
                         timeout=300)
    t_cli = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"the CLI exited {run.returncode}: {run.stderr[-2000:]}")
    lines = run.stdout.splitlines()
    if not lines[0].startswith("Running in headless mode: scene 'Stress1000', steps=20"):
        fail(f"CLI first line: {lines[0]!r}")
    counts = {k: sum(ln.startswith(k) for ln in lines)
              for k in ("[Physics] step", "Step ", "  Body ", "  Diagnostics:")}
    want = {"[Physics] step": 20, "Step ": 20, "  Body ": 20 * n_real, "  Diagnostics:": 20}
    if counts != want or len(lines) != 1 + sum(want.values()):
        fail(f"CLI trace has {counts} in {len(lines)} lines, expected {want}")
    if not (lines[1].startswith("[Physics] step 1 |") and lines[2] == "Step 0:"
            and lines[3].startswith(f"  Body {n_real}: Pos(")):
        fail(f"CLI trace does not open with [Physics], Step 0 and body {n_real}: {lines[1:4]}")
    run = subprocess.run(cli + ["--steps", "50", "--bench"], cwd=here, capture_output=True,
                         text=True, timeout=300)
    if run.returncode != 0 or kind not in run.stdout.splitlines()[-1]:
        fail(f"the CLI's --bench run: exit {run.returncode}, {run.stdout[-300:]!r}")
    print(f"CLI on the card: 20 traced Stress1000 steps, {len(lines)} lines, body {n_real} "
          f"first, {t_cli:.1f} s with start-up; --bench: {run.stdout.splitlines()[-1]}")

    # Checkpoint at the landing state, resumed on the card.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "landing.npz")
        save_checkpoint(path, landing, p, cap)
        size_kb = os.path.getsize(path) / 1024
        loaded, lp, lcap = load_checkpoint(path, "cuda")
    if (lp, lcap, loaded.step_index) != (p, cap, 150):
        fail("the checkpoint did not restore params, cap and the step index")
    straight = solver.run_steps(landing, p, cap, 50)
    resumed = solver.run_steps(loaded, lp, lcap, 50)
    sync()
    a, b = leaves(straight), leaves(resumed)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ or not torch.equal(straight.diagnostics.vec, resumed.diagnostics.vec):
        fail(f"the resumed run differs from the uninterrupted one in {differ}")
    print(f"checkpoint: landing state (step 150, {size_kb:.0f} KiB) loaded onto the card; 50 "
          f"steps from it and from the live state: {len(a)} body and cache leaves bitwise equal")

    # pick straight down onto the settled pile.
    origin = torch.tensor([0.0, 100.0, 0.0], device="cuda")
    idx, t_hit, local = pick(settled.bodies, origin, (0.0, -1.0, 0.0))
    i = int(idx)
    b = settled.bodies
    if i < 1 or not bool(b.dynamic.reshape(-1)[i]):
        fail(f"pick returned body {i}, not a dynamic one")
    half = b.size.reshape(3, -1)[:, i] * 0.5
    on_face = float((local.abs() / half).max())
    hit = origin + t_hit * torch.tensor([0.0, -1.0, 0.0], device="cuda")
    off = float((b.pos_n3[i] + quat_rotate(b.quat_n4[i], local) - hit).abs().max())
    if abs(on_face - 1.0) > 1e-3 or off > 1e-3 or not 0.0 < float(hit[1]) < 100.0:
        fail(f"pick: max |local| / half = {on_face}, body point off the ray by {off}")
    print(f"pick straight down at the pile's centre: body {i + 1}, t {float(t_hit):.4f} (hit at "
          f"y = {float(hit[1]):.4f}), the local point lies on a face of that body (max |local| / "
          f"half = {on_face:.6f}) and maps back onto the ray within {off:.1e}")

    # The viewer's simulation object.
    sim = Sim("Stress1000", device="cuda")
    with sim.lock:
        st = sim.state(5)
        if (st["step"], len(st["bodies"]["pos"]), len(st["bodies"]["quat"][0])) != (5, n_real, 4):
            fail("Sim.state(5) is not well formed")
        if not sim.spawn([0.0, 60.0, 0.0]) or sim.n_real != n_real + 1:
            fail("Sim.spawn did not fill a padding slot")
        st = sim.state(1)
        gates = dict(solver.step.last_gates)
        st = sim.state(4)
    y = st["bodies"]["pos"][n_real][1]
    if not gates["refreshed"] or gates["ballistic"]:
        fail(f"the step after a spawn did not refresh: {gates}")
    if st["diag"]["sanitized"] != 0 or not y < 60.0 or len(st["bodies"]["pos"]) != n_real + 1:
        fail(f"after the spawn: sanitized {st['diag']['sanitized']}, y {y}")
    print(f"viewer Sim on the card: state(5) well formed ({n_real} bodies), spawn filled slot "
          f"{n_real}, next step's gates {gates}, body at y = {y:.4f} after 5 steps, sanitized 0")

    # Every settled step is a contact step, so the trace must hold the
    # kernels the sweep plan says K1 queues, 50 times over, and besides them
    # the refresh kernels once each a refresh step (profiled_kernels).
    plan = solver_cuda.sweep_plan(settled.bodies.n, settled.contacts.other.shape[0])
    n_main, _k = solver_cuda.select_variant(p, True, True)
    per_step = solver_cuda.step_kernel_count(plan, n_main + int(p.post_stabilize))
    r, own, refreshes = profiled_kernels("Stress1000", 700, 50, per_step)
    step_kernels = sum(own.values())
    if not (r["device_us"] > 0.0 and 0.0 < r["busy"] <= 1.0):
        fail(f"profile_phases traced no device work: device_us {r['device_us']}, launches "
             f"{r['launches']}, busy {r['busy']}")
    if step_kernels != per_step * 50 or r["launches"] < step_kernels:
        fail(f"profile_phases traced {step_kernels} of the port's kernels in 50 steps "
             f"({r['launches']} launches in all), the plan ({plan.route}) says {per_step} a step")
    print(f"[{card}] profile_phases, 50 settled Stress1000 steps: busy share "
          f"{100 * r['busy']:.1f}%, {r['launches'] / 50:.1f} launches/step "
          f"({step_kernels / 50:.1f} of them the port's step kernels, the sweep plan's "
          f"{per_step}, and the refresh kernels on its {refreshes} refresh steps); device "
          f"{r['device_us'] / 50:.1f} us/step: "
          + ", ".join(f"{kernel_name(name)} {us / 50:.1f}"
                      for name, us, _c in r["kernels"] if own_kernel(name)))
    return {"device_us_per_step": r["device_us"] / 50, "busy": r["busy"],
            "launches_per_step": r["launches"] / 50,
            "own_per_step": (step_kernels + len(REFRESH_KERNELS) * refreshes) / 50}


# ---------------------------------------------------------------------------
# The portable path (phases 14-16): backend="xla" on Stress1000, a jointed
# world above 2048 bodies under "auto", and a batch of 16 worlds
# ---------------------------------------------------------------------------

# The reference's bound between two backends of the same solver
# (tests/test_pallas_backend.py): one step from one state.
BACKEND_BOUND = 2e-3
BATCH = 16


def device_launches(fn, reps: int) -> tuple:
    """(kernels launched on the card, their device us) per call of ``fn``,
    from a torch.profiler trace of ``reps`` calls (copies and memsets not
    counted)."""
    import torch
    from torch.autograd import DeviceType

    from avbd3d_tpu_torch.utils import profile_phases

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and profile_phases.device_time_us(e) > 0.0
            and not e.key.startswith(("Memcpy", "Memset"))]
    return (sum(e.count for e in rows) / reps,
            sum(profile_phases.device_time_us(e) for e in rows) / reps)


def expect_only_k2(label, launches, n_steps, refreshes, gates=0, ballistic=0):
    """The portable path launches K2 once a step, the refresh kernels once
    a refresh (``refreshes``), the gates kernel ``gates`` times (once a
    step through ``solver.step``; ``batched_step`` has gates of its own),
    the ballistic step's kernel ``ballistic`` times, and no other kernel."""
    want = dict.fromkeys(launches, 0)
    want["control_lanes"] = n_steps
    want["step_gates"] = gates
    want["ballistic_step"] = ballistic
    want["candidate_lists"] = refreshes
    if launches != want:
        fail(f"{label}: launch counts {launches}, expected {want}")


def portable_phase(card, settled) -> dict:
    """Phase 14: Stress1000 on the portable path (``backend="xla"``) from
    step 0 through the landing, 300 steps, counters reset before and read
    after: sanitized 0, pair and degree overflow 0, finite poses, one host
    read, one gates launch and one K2 launch a step (the ballistic steps'
    lanes and ``attach_control``'s), the ballistic kernel once a ballistic
    step, no other kernel.  Then one step from its landing
    state (step 150) and from the fused path's settled state (step 700) on
    both paths: candidate lists, contact counts and manifold counts
    identical, poses within BACKEND_BOUND."""
    import torch

    from avbd3d_tpu_torch import load_scene, solver

    scene = load_scene("Stress1000", device="cuda")
    p, cap = scene.params, scene.cap.replace(backend="xla")
    w = scene.world
    reset_counts()
    solver.step.host_reads = 0
    gates = {"ballistic": 0, "full": 0, "refreshed": 0}
    worst = torch.zeros(16, device="cuda")
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    saved = {}
    sync()
    t0 = time.perf_counter()
    for i in range(300):
        w = solver.step(w, p, cap)
        if solver.step.last_path != "xla":
            fail(f"portable path: step {i + 1} took {solver.step.last_path}")
        g = solver.step.last_gates
        gates["ballistic" if g["ballistic"] else "full"] += 1
        gates["refreshed"] += int(g["refreshed"])
        worst = torch.maximum(worst, w.diagnostics.vec)
        finite &= torch.isfinite(w.bodies.pos).all() & torch.isfinite(w.bodies.quat).all()
        if i + 1 == 150:
            saved["landing"] = w
    sync()
    t_run = time.perf_counter() - t0
    launches, reads = read_counts(), solver.step.host_reads
    expect_only_k2("portable path", launches, 300, gates["refreshed"], 300, gates["ballistic"])
    if reads != 300:
        fail(f"portable path: {reads} host reads in 300 steps")
    worst = worst.tolist()
    if not bool(finite) or worst[8] != 0.0 or worst[9] + worst[10] != 0.0:
        fail(f"portable path: finite {bool(finite)}, sanitized {worst[8]}, overflow pair "
             f"{worst[9]} degree {worst[10]}")
    d = w.diagnostics.as_dict()
    print(f"[{card}] portable path (backend='xla'), Stress1000 steps 1-300: {t_run:.2f} s = "
          f"{1000 * t_run / 300:.1f} ms/step; gates {gates}; K2 launches "
          f"{launches['control_lanes']}, host reads {reads} (one a step); sanitized 0, "
          f"overflow 0; max penetration {worst[0]:.6f} over the landing cascade; step 300: "
          f"{int(d['active_manifolds'])} manifolds, max_pen {d['max_penetration']:.6f}")

    worst_d = 0.0
    for label, state in (("landing (portable step 150)", saved["landing"]),
                         ("settled (fused step 700)", settled)):
        wx = solver.step(state, p, cap)
        wf = solver.step(state, p, scene.cap)
        if solver.step.last_path != "fused":
            fail(f"{label}: the fused step took {solver.step.last_path}")
        same = (torch.equal(wx.bp.nb, wf.bp.nb) and torch.equal(wx.contacts.count, wf.contacts.count)
                and torch.equal(wx.contacts.other, wf.contacts.other)
                and torch.equal(wx.diagnostics.vec[5:7], wf.diagnostics.vec[5:7]))
        dpos = float_diff(wx.bodies.pos, wf.bodies.pos)
        worst_d = max(worst_d, dpos)
        print(f"portable vs fused, one step from {label}: candidate lists and contact counts "
              f"{'identical' if same else 'DIFFER'}; max |pos difference| {dpos:.3e} m "
              f"(bound {BACKEND_BOUND})")
        if not same or not dpos < BACKEND_BOUND:
            fail(f"portable vs fused from {label}: identical {same}, |dpos| {dpos}")

    landing = saved["landing"]
    ms = event_ms(lambda: solver.step(landing, p, cap), 5)
    per_step, device_us = device_launches(lambda: solver.step(landing, p, cap), 2)
    print(f"[{card}] portable step at the landing state: {ms:.2f} ms a step, {per_step:.0f} "
          f"kernel launches a step ({device_us:.0f} us on the card, "
          f"{100 * device_us / (1000 * ms):.1f}% busy)")
    return {"landing": landing, "launches": launches["control_lanes"], "steps": 300,
            "ms_per_step": 1000 * t_run / 300, "landing_ms": ms, "launches_per_step": per_step,
            "max_abs_err_vs_fused": worst_d}


def chains_world(n_chains=150, segments=15, device="cuda"):
    """``n_chains`` copies of RodJointed's chain (a static top segment and
    14 hard-welded 0.25 x 1 x 0.25 segments below it) in a 15-wide grid at
    1 m pitch: 2250 bodies, N = 3072, 2100 hard welds, 2 colours; built as
    ``sheets_world`` is, with the default SolverParams: 10 iterations (20
    on impact steps), half RodJointed's 20, so that the whole script stays
    within its time limit on a slow host; the welds still close far inside
    the gate (PERF.md)."""
    from avbd3d_tpu_torch import SceneBuilder, SolverParams
    from avbd3d_tpu_torch.convert import world_from_arrays

    sb = SceneBuilder()
    for c in range(n_chains):
        x, z = float(c % 15), float(c // 15)
        prev = None
        for i in range(segments):
            cur = sb.add_body((0.25, 1, 0.25), 0.0 if i == 0 else 1.0, 0.5, (x, 10.0 - i, z))
            if prev is not None:
                sb.add_joint(prev, cur, (0, -0.5, 0), (0, 0.5, 0))
            prev = cur
    arrays, p, cap, n_real = sb.build(SolverParams())
    return world_from_arrays(arrays, device), p, cap, n_real


def chains_phase(card) -> dict:
    """Phase 15: a jointed world above 2048 bodies under ``"auto"`` takes
    the portable path.  150 RodJointed chains, 200 steps, counters reset
    before and read after: every step "xla", K2 once a step, sanitized 0,
    degree overflow 0, finite poses, and RodJointed's weld gates at step
    200 (static tops in place, every welded anchor gap < 0.02)."""
    import numpy as np
    import torch

    from avbd3d_tpu_torch import solver

    w, p, cap, n_real = chains_world()
    shape = (n_real, w.bodies.n, w.joints.dj, int((w.joints.other >= 0).sum()) // 2,
             cap.joint_colors)
    if shape != (2250, 3072, 2, 2100, 2) or solver.select_path(w, cap) != "xla":
        fail(f"chains: not N = 3072 / 2100 welds / 2 colours on the portable path: {shape}, "
             f"{solver.select_path(w, cap)}")
    top0 = w.bodies.pos_n3[0:n_real:15].clone()
    reset_counts()
    solver.step.host_reads = 0
    worst = torch.zeros(16, device="cuda")
    refreshes = 0
    sync()
    t0 = time.perf_counter()
    for i in range(200):
        w = solver.step(w, p, cap)
        if solver.step.last_path != "xla":
            fail(f"chains: step {i + 1} took {solver.step.last_path}")
        refreshes += int(solver.step.last_gates["refreshed"])
        worst = torch.maximum(worst, w.diagnostics.vec)
    sync()
    t_run = time.perf_counter() - t0
    launches, reads = read_counts(), solver.step.host_reads
    expect_only_k2("chains", launches, 200, refreshes, 200)
    worst = worst.tolist()
    finite = bool(torch.isfinite(w.bodies.pos).all() & torch.isfinite(w.bodies.quat).all())
    if reads != 200 or not finite or worst[8] != 0.0 or worst[10] != 0.0:
        fail(f"chains: host reads {reads}, finite {finite}, sanitized {worst[8]}, degree "
             f"overflow {worst[10]}")
    top_move = float((w.bodies.pos_n3[0:n_real:15] - top0).abs().max())
    pos = w.bodies.pos_n3[:n_real].double().cpu().numpy()
    quat = w.bodies.quat_n4[:n_real].double().cpu().numpy()

    def anchors(local):
        v = np.asarray(local, np.float64)
        qv, qw = quat[:, :3], quat[:, 3:]
        t = 2.0 * np.cross(qv, v)
        return pos + v + qw * t + np.cross(qv, t)

    below, above = anchors((0.0, -0.5, 0.0)), anchors((0.0, 0.5, 0.0))
    link = np.arange(n_real).reshape(150, 15)
    gaps = np.linalg.norm(below[link[:, :-1]] - above[link[:, 1:]], axis=-1)
    if top_move > 1e-5 or not gaps.max() < 0.02:
        fail(f"chains: static tops moved {top_move}, worst welded anchor gap {gaps.max()}")
    d = w.diagnostics.as_dict()
    print(f"[{card}] 150 RodJointed chains (N = 3072, 2100 hard welds) under 'auto' -> "
          f"'xla': 200 steps in {t_run:.2f} s = {1000 * t_run / 200:.1f} ms/step; K2 launches "
          f"{launches['control_lanes']}, host reads {reads}; sanitized 0, degree overflow 0; "
          f"step 200: worst welded anchor gap {gaps.max():.2e}, static tops moved "
          f"{top_move:.1e}, max_lin {d['max_linear_speed']:.2e}")
    return {"launches": launches["control_lanes"], "ms_per_step": 1000 * t_run / 200,
            "gap": float(gaps.max())}


def kicked_batch(world, batch):
    """``batch`` copies of ``world``, copy i with its dynamic bodies' x
    velocity raised by 0.01 i m/s (tests/test_parallel.py's kick)."""
    import torch

    from avbd3d_tpu_torch.parallel import replicate_world

    worlds = replicate_world(world, batch)
    kick = torch.arange(batch, dtype=torch.float32, device="cuda") * 0.01
    dyn = (world.bodies.inv_mass > 0).to(torch.float32)
    vel = worlds.bodies.linvel.clone()
    vel[:, 0] += kick[:, None, None] * dyn[None]
    return worlds.replace(bodies=worlds.bodies.replace(linvel=vel))


def compare_k2_batch(worlds, params, label: str) -> float:
    """K2 on a batch (one launch, a world axis) against its plain version
    (vmapped) on the same inputs, lane by lane as ``compare_k2`` holds one
    world, and against one launch per world bit for bit.  Returns the
    largest difference (lane 3's)."""
    import torch

    from avbd3d_tpu_torch import solver_cuda
    from avbd3d_tpu_torch.parallel import world_at

    b, bp = worlds.bodies, worlds.bp
    lp = solver_cuda.control_lanes_plain(bp.nb, b, bp.anchor, bp.anchor_quat, params)
    lk = solver_cuda.control_lanes(bp.nb, b, bp.anchor, bp.anchor_quat, params)
    ones = torch.stack([solver_cuda.control_lanes(wi.bp.nb, wi.bodies, wi.bp.anchor,
                                                  wi.bp.anchor_quat, params)
                        for wi in (world_at(worlds, i) for i in range(lk.shape[0]))])
    sync()
    exact = [0, 1, 2, 4]
    if lk.shape != (BATCH, 5) or not same_bits(lp[:, exact], lk[:, exact]):
        fail(f"K2 batch {label}: lanes 0, 1, 2, 4 differ in bits from the plain version")
    err = float((lp[:, 3] - lk[:, 3]).abs().max())
    if not bool(((lp[:, 3] - lk[:, 3]).abs() <= 1e-6 + 1e-5 * lp[:, 3].abs()).all()):
        fail(f"K2 batch {label}: lane 3 plain {lp[:, 3].tolist()} vs kernel {lk[:, 3].tolist()}")
    if not same_bits(lk, ones):
        fail(f"K2 batch {label}: a world's lanes differ from its own launch")
    print(f"K2 vs plain, a batch of {lk.shape[0]} worlds in one launch ({label}, N = "
          f"{bp.nb.shape[-2] * 128}, D = {bp.nb.shape[-3]}): lanes 0, 1, 2, 4 bit-identical, "
          f"lane 3 abs err {err:.3e}; every world bit-identical to its own launch")
    return err


def bench_phase(card: str) -> dict:
    """Phase 18: ``python -m avbd3d_tpu_torch.bench --quick`` as a
    subprocess, its JSON line (the last) held to the bench's own checks and
    to the counts the code promises.  Returns the line and the seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "avbd3d_tpu_torch.bench", "--quick"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"bench --quick exited {proc.returncode}: {lines[-1:]} {proc.stderr[-3000:]}")
    line = json.loads(lines[-1])
    extra, regimes = line["extra"], line["extra"]["regimes"]
    if line["correct"] is not True or line["failed"] or line["quick"] is not True:
        fail(f"bench --quick: correct {line['correct']}, failed {line['failed']}")
    if extra["device"] != card:
        fail(f"bench --quick ran on {extra['device']!r}, phase 1 printed {card!r}")
    stress1000 = [regimes[k]["counts"]["launches"] for k in regimes if k.startswith("stress1000")]
    k1, k2 = (sum(c[k] for c in stress1000) for k in ("step_kernel", "control_lanes"))
    if not (k1 and k2):
        fail(f"bench --quick: Stress1000 launched K1 {k1} and K2 {k2} times")
    grid = regimes["stress4096"]["counts"]
    if (grid["paths"] != {"grid": grid["steps"]} or grid["launches_per_step"]["collide_grid"] != 1
            or grid["launches_per_step"]["iterblock_grid"] != 5):
        fail(f"bench --quick, Stress4096: paths {grid['paths']}, launches a step "
             f"{grid['launches_per_step']}; expected the grid tier, K5 1 and K6 5")
    for name, r in regimes.items():
        c = r["counts"]
        if c["paths"].get("fused") == c["steps"] and c["host_reads_per_step"] != 1.0:
            fail(f"bench --quick, {name}: {c['host_reads_per_step']} host reads a fused step")
    split = host_split_holds(line)
    settled = regimes["stress1000_settled"]
    print(f"[{card}] bench --quick: {seconds:.1f} s, correct; settled Stress1000 "
          f"{settled['best']:.1f} steps/s (one block of {settled['window_steps']}), falling "
          f"{extra['falling_steps_per_sec']:.1f}, Stress2048 "
          f"{extra['stress2048']['steps_per_sec']:.1f}, Stress4096 "
          f"{extra['stress4096']['steps_per_sec']:.1f}; K1 {k1}, K2 {k2} launches on Stress1000, "
          f"K5 / K6 1 / 5 a grid step; one host read a step")
    print(f"[{card}] bench --quick, the host's timed step by span (us a step; "
          f"utils/host_spans): {json.dumps(split)}")
    return {"seconds": seconds, "line": line, "k1": k1, "k2": k2, "grid": grid}


# The most of a timed step that no span of solver.step covers, over the
# bench's short windows (``step_other``, the step's own calls and the path's
# choice).
STEP_OTHER_SHARE = 0.10


def host_split_holds(line: dict) -> dict:
    """Phase 18's holds on the host spans of each regime of a bench line:
    every ``<id>.call`` a step equal to that kernel's launches a step
    (``bench.span_calls_planned``), ``step_other`` at most STEP_OTHER_SHARE
    of ``step``, the steps' spans within the windows' wall time (``loop``
    >= 0), the allocator's counts read, and the traced window's span ranges
    mirrored on the device left out of its device figures (no kernel of
    that name among them; the count left out is printed).  Returns each
    regime's split, us a step."""
    from avbd3d_tpu_torch import bench
    from avbd3d_tpu_torch.utils import host_spans

    out = {}
    for name, r in line["extra"]["regimes"].items():
        lay = line["layers"][name]
        us, calls = lay["host_span_us_per_step"], lay["host_span_calls_per_step"]
        planned = bench.span_calls_planned(r["counts"]["launches_per_step"])
        got = {k: v for k, v in calls.items() if k.endswith(".call")}
        if got != planned:
            fail(f"bench --quick, {name}: span calls a step {got}, the launches give {planned}")
        if not us["step_other"] <= STEP_OTHER_SHARE * us["step"]:
            fail(f"bench --quick, {name}: step_other {us['step_other']:.2f} us of a "
                 f"{us['step']:.2f} us step, more than {STEP_OTHER_SHARE:.0%}")
        if not us["loop"] >= 0.0:
            fail(f"bench --quick, {name}: the steps' spans exceed the windows' wall time "
                 f"(loop {us['loop']:.2f} us a step)")
        if "not measured" in (lay["device_allocs_per_step"], lay["device_frees_per_step"],
                              lay["alloc_retries"]):
            fail(f"bench --quick, {name}: the allocator's counts were not read")
        traced = line["extra"]["traced"][name]
        mirrored = [k["name"] for k in traced["top_kernels"]
                    if k["name"].startswith(host_spans.PREFIX)]
        if mirrored or any(k.startswith(host_spans.PREFIX) for k in traced["kernel_us_per_step"]):
            fail(f"bench --quick, {name}: span ranges counted as device work: {mirrored}")
        out[name] = {k: round(v, 2) for k, v in us.items()}
        out[name].update(allocs=lay["device_allocs_per_step"], frees=lay["device_frees_per_step"],
                         retries=lay["alloc_retries"],
                         between_ops=lay["idle_between_ops_share"],
                         mirrors_left_out=traced["span_mirrors_left_out"])
    return out


def cells_phase(card: str) -> dict:
    """Phase 18, the benchmark's cells: each cell's command in
    BENCHMARK.json with ``--quick``, as a subprocess, its last line held to
    the bench's checks.  Returns each cell's line and seconds."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "BENCHMARK.json")) as f:
        cells = json.load(f)["workloads"]
    out = {}
    for cell in cells:
        name, argv = cell["name"], shlex.split(cell["command"]) + ["--quick"]
        if argv[0] == "python":
            argv[0] = sys.executable
        seed = int(argv[argv.index("--seed") + 1])
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=here, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            fail(f"cell {name}: {cell['command']} --quick exited {proc.returncode}: {lines[-1:]} "
                 f"{proc.stderr[-3000:]}")
        line = json.loads(lines[-1])
        plain, lay = line["plain_check"][name], line["layers"][name]
        if (line["correct"] is not True or line["seed"] != seed
                or not all(q["ok"] and q["control"]["fails"] for q in plain)
                or line["failed_steps"] != 0 or line["extra"]["device"] != card
                or line["steps_per_sec_n"] < 1):
            fail(f"cell {name}: correct {line['correct']}, seed {line['seed']} (asked {seed}), "
                 f"plain check {plain}, failed_steps {line['failed_steps']}, device "
                 f"{line['extra']['device']!r}, failed {line['failed']}")
        gap = lay["idle_gaps"][0] if isinstance(lay["idle_gaps"], list) and lay["idle_gaps"] \
            else None
        points = "; ".join(
            f"from step {q['from_step']}: pos {q['max_abs_diff']['pos']:.3g} m (control "
            f"{q['control']['max_abs_diff']['pos']:.3g}, one ulp "
            f"{q['one_ulp']['max_abs_diff']['pos']:.3g}), the CPU's step {q['cpu_step_s']:.2f} s"
            for q in plain)
        print(f"[{card}] cell {name} (--quick, seed {seed}): {seconds:.1f} s, correct; "
              f"steps_per_sec {line['steps_per_sec']:.1f} (over {line['steps_per_sec_n']} "
              f"steps); failed_steps 0 of {line['steps_run']}; plain check, integers identical, "
              f"within {plain[0]['tolerance']['pos']} m, {points}; idle share "
              f"{lay['idle_share']}, longest gap {json.dumps(gap)}; peak memory "
              f"{lay['peak_bytes']} B, the world {lay['world_bytes']} B")
        out[name] = {"seconds": seconds, "line": line}
    return out


def batched_refreshed() -> int:
    """1 when some world of the last ``batched_step`` refreshed its lists
    (the batch's lists then come from one call of the refresh kernels), else
    0."""
    from avbd3d_tpu_torch.parallel import batched_step

    return int(any(any(g["refresh"]) for g in batched_step.last_gates))


def batched_phase(card, landing) -> dict:
    """Phase 16: ``batched_step`` over BATCH Stress1000 worlds that differ
    by a kick, counters reset before each run and read after.  From the
    initial state, 3 steps, each world against its own single run on the
    portable path: integers identical, control lanes within K2's lane
    bounds, poses within the CPU tests' bound (rtol 1e-5, atol 1e-6); K2
    launched once a batched step (the whole batch's lanes, after the vmapped
    step) and no other kernel.  K2's batched lanes against its plain version
    at the batch's shapes.  Then 100 batched steps from the kicked landing
    state (step 150) timed: world-steps/s, kernel launches a step, host
    reads a step (one), K2 launches (100)."""
    import numpy as np
    import torch

    from avbd3d_tpu_torch import load_scene, solver
    from avbd3d_tpu_torch.parallel import batched_step, world_at

    scene = load_scene("Stress1000", device="cuda")
    p, cap = scene.params, scene.cap.replace(backend="xla")
    worlds = kicked_batch(scene.world, BATCH)
    starts = [world_at(worlds, i) for i in range(BATCH)]
    reset_counts()
    refreshes = 0
    for _ in range(3):
        worlds = batched_step(worlds, p, cap)
        refreshes += batched_refreshed()
    sync()
    expect_only_k2("batched_step, 3 steps", read_counts(), 3, refreshes)

    singles = []
    for w in starts:
        for _ in range(3):
            w = solver.step(w, p, cap)
        singles.append(w)
    worst = 0.0
    for i in range(BATCH):
        wb, single = world_at(worlds, i), singles[i]
        ints = all(torch.equal(getattr(wb.contacts, k), getattr(single.contacts, k))
                   for k in ("other", "count", "feature")) and all(
            torch.equal(getattr(wb.bp, k), getattr(single.bp, k)) for k in ("nb", "key", "thr"))
        ints = ints and torch.equal(wb.diagnostics.vec[5:11], single.diagnostics.vec[5:11])
        lanes = bool(torch.allclose(wb.diagnostics.vec[11:], single.diagnostics.vec[11:],
                                    rtol=1e-5, atol=1e-6))
        close = all(bool(torch.allclose(getattr(wb.bodies, k), getattr(single.bodies, k),
                                        rtol=1e-5, atol=1e-6))
                    for k in ("pos", "quat", "linvel", "angvel"))
        d = float_diff(wb.bodies.pos, single.bodies.pos)
        worst = max(worst, d)
        if not (ints and lanes and close):
            fail(f"batched world {i}: integers identical {ints}, control lanes within the "
                 f"bound {lanes}, poses within the bound {close} (|dpos| {d})")
    if np.allclose(world_at(worlds, 0).bodies.pos.cpu().numpy(),
                   world_at(worlds, BATCH - 1).bodies.pos.cpu().numpy()):
        fail("batched: the kick was lost")
    print(f"batched_step, {BATCH} kicked Stress1000 worlds, 3 steps from the initial state: K2 "
          f"launched 3 times (once a batched step), no other kernel; every world equals its own "
          f"single run (integers identical, control lanes and poses within the bound, max "
          f"|dpos| {worst:.2e})")
    k2_err = compare_k2_batch(worlds, p, "3 steps from the kicked initial state")

    worlds = kicked_batch(landing, BATCH)
    worlds = batched_step(worlds, p, cap)
    k2_err = max(k2_err, compare_k2_batch(worlds, p, "the kicked landing state"))
    from avbd3d_tpu_torch import solver_cuda

    bb, bbp = worlds.bodies, worlds.bp
    a2 = (bbp.nb, bb, bbp.anchor, bbp.anchor_quat, p)
    k2_times = one_kernel_times(
        card, f"control-lanes kernel (K2, {BATCH} kicked Stress1000 worlds after the landing, "
        "one launch)", "k_control_lanes", lambda: solver_cuda.control_lanes(*a2),
        lambda: solver_cuda.control_lanes_plain(*a2))
    k2_bnd = bound(nbytes(bbp.nb, [getattr(bb, f) for f in ("pos", "quat", "size", "radius",
                                                             "linvel", "angvel", "inv_mass")],
                          bbp.anchor, bbp.anchor_quat) + BATCH * 5 * 4,
                   int((bbp.nb >= 0).sum()) * OPS_CTRL_SLOT)
    reads0 = batched_step.host_reads
    sync()
    reset_counts()
    refreshes = 0
    t0 = time.perf_counter()
    for _ in range(100):
        worlds = batched_step(worlds, p, cap)
        refreshes += batched_refreshed()
    sync()
    t_run = time.perf_counter() - t0
    launches = read_counts()
    expect_only_k2("batched_step, 100 steps", launches, 100, refreshes)
    reads = (batched_step.host_reads - reads0) / 100
    vec = worlds.diagnostics.vec
    finite = bool(torch.isfinite(worlds.bodies.pos).all())
    if reads != 1 or not finite or float(vec[:, 8].max()) != 0.0:
        fail(f"batched: host reads a step {reads}, finite {finite}, sanitized "
             f"{float(vec[:, 8].max())}")
    per_step, device_us = device_launches(lambda: batched_step(worlds, p, cap), 2)
    wsps = BATCH * 100 / t_run
    print(f"[{card}] batched_step, {BATCH} kicked Stress1000 worlds from the landing state, "
          f"100 steps: {t_run:.2f} s = {wsps:.1f} world-steps/s ({1000 * t_run / 100:.1f} ms a "
          f"batched step); {per_step:.0f} kernel launches a step ({device_us:.0f} us on the "
          f"card); K2 launches {launches['control_lanes']}; host reads a step {reads:.0f}; "
          f"sanitized 0; manifolds per world at the end {int(vec[:, 6].min())}-"
          f"{int(vec[:, 6].max())}")
    return {"world_steps_per_s": wsps, "launches_per_step": per_step,
            "ms_per_step": 1000 * t_run / 100, "max_abs_err": worst, "k2_err": k2_err,
            "launches": 3 + launches["control_lanes"], "steps": 103, "k2": {
                **k2_times, "bound_ms": k2_bnd[0], "bound_by": k2_bnd[1]}}


# ---------------------------------------------------------------------------
# The swept broadphase (phase 17): cap.bp_window > 0 on the fused path and
# the grid tier
# ---------------------------------------------------------------------------

# The windows of phase 17: for each scene the smallest that takes the sweep
# at its states (utils/sweep_bench.py; PERF.md section 5).
SWEPT_WINDOWS = {"Stress1000": 504, "Stress4096": 1016, "pile": 4088}


def swept_refresh(card, label, world, scene, window) -> dict:
    """One refresh at ``world``: the sweep on the card against the matrix on
    the card (lists identical, slack at most the matrix's) and against the
    sweep's plain run on CPU copies of the same inputs (lists identical);
    both refreshes' ms (CUDA events), kernels and device us (trace)."""
    import torch

    from avbd3d_tpu_torch.convert import world_from_arrays, world_to_arrays
    from avbd3d_tpu_torch.ops.broadphase import build_bp_cache
    from avbd3d_tpu_torch.utils import sweep_bench

    deg, margin = scene.cap.max_degree, scene.params.bp_margin
    r = sweep_bench.refresh_pair(world, deg, margin, window, "cuda")
    host = world_from_arrays(world_to_arrays(world), "cpu")
    plain = build_bp_cache(host.bodies, host.exclusions, deg, margin, window=window)
    same_cpu = all(torch.equal(getattr(r["cache"], f).cpu(), getattr(plain, f))
                   for f in ("nb", "key", "thr", "cand"))
    print(f"[{card}] swept refresh, {label} (N = {world.bodies.n}, window {window}): "
          f"{'fell back' if r['fallback'] else 'swept'}; lists vs the matrix on the card "
          f"{'identical' if r['identical'] else 'DIFFER'}, vs the sweep on the CPU "
          f"{'identical' if same_cpu else 'DIFFER'}; slack {r['slack']:.6g} (matrix "
          f"{r['matrix_slack']:.6g}); a refresh: swept {r['swept_ms']:.3f} ms, "
          f"{r['swept']['launches']:.0f} kernels, {r['swept']['device_us']:.1f} us on the card; "
          f"matrix {r['matrix_ms']:.3f} ms, {r['matrix']['launches']:.0f} kernels, "
          f"{r['matrix']['device_us']:.1f} us")
    if not (r["identical"] and same_cpu and r["slack_ok"]):
        fail(f"swept refresh, {label}: identical {r['identical']}, vs CPU {same_cpu}, "
             f"slack {r['slack']} vs {r['matrix_slack']}")
    return {k: v for k, v in r.items() if k != "cache"}


def swept_run(label, scene, window, n_steps, hold_from, most: bool):
    """``n_steps`` steps of ``scene`` from step 0 with ``bp_window`` =
    ``window``, counters reset before and read after: the launches, paths,
    refresh steps and the sweep's calls and fallbacks, the envelope held
    from ``hold_from`` (none when it is ``n_steps``).  The sweep must be
    taken on most refreshes (``most``) or on some."""
    from avbd3d_tpu_torch import solver
    from avbd3d_tpu_torch.ops.broadphase import candidate_lists_swept as c

    p, cap = scene.params, scene.cap.replace(bp_window=window)
    w = scene.world
    watch = Watch(hold_from)
    paths, refreshes, base = set(), 0, (c.swept, c.fallbacks)
    reset_counts()
    sync()
    t0 = time.perf_counter()
    for i in range(n_steps):
        w = solver.step(w, p, cap)
        paths.add(solver.step.last_path)
        refreshes += int(solver.step.last_gates["refreshed"])
        watch.add(i, w)
    sync()
    out = {"seconds": time.perf_counter() - t0, "launches": read_counts(), "paths": paths,
           "refresh_steps": refreshes, "swept": c.swept - base[0],
           "fallbacks": c.fallbacks - base[1], "world": w}
    # The matrix runs on the card where the sweep falls back; the grid tier
    # reads its refresh predicate every step (the gates kernel).
    want = (out["fallbacks"], n_steps if paths == {"grid"} else 0)
    if (out["launches"]["candidate_lists"], out["launches"]["grid_gates"]) != want:
        fail(f"{label}, swept: refresh kernel launches {out['launches']}, expected "
             f"candidate_lists {want[0]} (the fallbacks), grid_gates {want[1]}")
    print(f"{label}, bp_window {window}: {n_steps} steps in {out['seconds']:.2f} s; paths "
          f"{sorted(paths)}; refresh steps {refreshes}: {out['swept']} swept, "
          f"{out['fallbacks']} fell back; launches {out['launches']}")
    if out["swept"] <= (out["fallbacks"] if most else 0):
        fail(f"{label}: the sweep was taken on {out['swept']} of {refreshes} refreshes")
    watch.check(f"{label}, swept", n_steps)
    return out


def swept_phase(card, landing, settled, grid) -> dict:
    """Phase 17: the swept broadphase.  One refresh at Stress1000's landing
    (step 150) and settled (step 700) states and at Stress4096's settled
    state (step 1000), held by ``swept_refresh``; Stress1000 for 700 steps
    from step 0 with its window (K1 and K2 launched, the sweep taken on
    most refreshes, the main path's envelope); Stress4096 for 200 steps
    from step 0 on the grid tier (K5 once and K6 five times a step,
    sanitized 0, overflow 0, finite poses, the sweep taken on some
    refreshes), then 20 steps from its settled
    state with and without the window: there the sweep runs along x, where
    the ground is fat and the only static body, so its slack is exact and
    the steps are the matrix's bit for bit; one refresh of a pile of 31 x 17
    x 31 cubes (N = 16384) at its spawn poses, timed."""
    import torch

    from avbd3d_tpu_torch import load_scene, solver
    from avbd3d_tpu_torch.convert import world_from_arrays
    from avbd3d_tpu_torch.models.scenes import Scene, _scene_stress_n
    from avbd3d_tpu_torch.ops.broadphase import candidate_lists_swept
    from avbd3d_tpu_torch.parallel.batched import world_tensors

    s1000, s4096 = load_scene("Stress1000", "cuda"), load_scene("Stress4096", "cuda")
    w1, w4 = SWEPT_WINDOWS["Stress1000"], SWEPT_WINDOWS["Stress4096"]
    refresh = {label: swept_refresh(card, label, w, sc, win) for label, w, sc, win in (
        ("Stress1000 landing (step 150)", landing, s1000, w1),
        ("Stress1000 settled (step 700)", settled, s1000, w1),
        ("Stress4096 settled (step 1000)", grid["settled"], s4096, w4))}

    fused = swept_run("Stress1000", s1000, w1, 700, 300, most=True)
    if fused["paths"] != {"fused"}:
        fail(f"Stress1000 with the sweep took {fused['paths']}")
    lf = fused["launches"]
    if lf["step_kernel"] == 0 or lf["control_lanes"] == 0:
        fail(f"Stress1000 with the sweep: a kernel of its path never launched: {lf}")
    # While it falls the pile sweeps along y, where its layers need more
    # than this window (sweep_bench: the fallbacks of Stress4096's 1000
    # steps all fall in its first 200), so here the sweep is held to "some".
    gridded = swept_run("Stress4096", s4096, w4, 200, 200, most=False)
    lg = gridded["launches"]
    if gridded["paths"] != {"grid"} or (
            lg["collide_grid"], lg["iterblock_grid"], lg["grid_gates"], lg["grid_predict"],
            lg["grid_finalize"]) != (200, 1000, 200, 200, 200):
        fail(f"Stress4096 with the sweep: paths {gridded['paths']}, launches {lg}")

    p4 = s4096.params
    ws, wm = grid["settled"], grid["settled"]
    swept0 = candidate_lists_swept.swept
    for _ in range(20):
        ws = solver.step(ws, p4, s4096.cap.replace(bp_window=w4))
        wm = solver.step(wm, p4, s4096.cap)
    ta, tb = world_tensors(ws), world_tensors(wm)
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    settled_swept = candidate_lists_swept.swept - swept0
    print(f"Stress4096 steps 1001-1020 from the settled state, window {w4} against 0: "
          f"{'bit for bit' if not differ else 'DIFFER in ' + ', '.join(differ)}; "
          f"{settled_swept} refreshes swept")
    if differ or settled_swept == 0:
        fail(f"Stress4096 settled, swept against matrix: differ in {differ}, "
             f"{settled_swept} refreshes swept")

    arrays, p, cap, n_real = _scene_stress_n(31, 17, 31, max_degree=28, cache_degree=16)
    pile = Scene("pile", world_from_arrays(arrays, "cuda"), p, cap, n_real)
    refresh["pile 31x17x31 spawn"] = swept_refresh(card, "pile 31x17x31 at its spawn poses",
                                                   pile.world, pile, SWEPT_WINDOWS["pile"])
    return {"refresh": refresh, "fused": lf, "grid": lg, "pile": pile,
            "counts": {k: {f: r[f] for f in ("refresh_steps", "swept", "fallbacks", "seconds")}
                       for k, r in (("Stress1000 700 steps", fused),
                                    ("Stress4096 200 steps", gridded))}}


def kernel_name(key: str) -> str:
    """A traced kernel's name without its parameter list and, for a
    template (demangled with its return type in front), without ``void``:
    ``void k_joint_sweeps<512, true>(Dims, ...)`` -> ``k_joint_sweeps<512, true>``."""
    return key.split("(")[0].removeprefix("void ")


def own_kernel(name: str) -> bool:
    """A traced kernel of csrc/ (``k_...``)."""
    return kernel_name(name).startswith("k_")


# ---------------------------------------------------------------------------
# The broadphase refresh on the card (phase 19)
# ---------------------------------------------------------------------------

# Float operations a unit, from csrc/bp_refresh.cu's statements, rounded
# down: k_bp_lists' gap of a (dynamic row, column) pair (3 subtractions, 3
# abs, 3 additions, 3 subtractions, 2 maxes, the margin); k_bp_tables' world
# halves of a body; k_refresh_needed's anchor terms, partials and deviation
# pass of a body.
OPS_BP_PAIR = 15
OPS_BP_BODY = 55
OPS_ANCHOR_BODY = 60


def plain_cache(b, exclusions, degree, margin):
    """The refresh's plain version (``candidate_lists_plain`` and
    ``cache_from_lists``) on the same tensors."""
    from avbd3d_tpu_torch.ops import broadphase as bpm

    half = tuple(b.size[k] * 0.5 for k in range(3))
    return bpm.cache_from_lists(b, bpm.candidate_lists_plain(
        b.pos, b.quat, half, b.radius, b.dynamic, exclusions, degree, margin))


def compare_lists(label, world, degree, margin) -> dict:
    """The refresh kernels (``build_bp_cache`` on the card: k_bp_tables,
    k_bp_lists) against the plain version on the same card tensors: nb,
    key, thr, cand and dropped identical, slack bit for bit."""
    import torch

    from avbd3d_tpu_torch.ops import broadphase as bpm

    b, ex = world.bodies, world.exclusions
    k = bpm.build_bp_cache(b, ex, degree, margin)
    pl = plain_cache(b, ex, degree, margin)
    sync()
    differ = [f for f in ("nb", "key", "thr", "cand", "dropped")
              if not torch.equal(getattr(k, f), getattr(pl, f))]
    if not same_bits(k.slack, pl.slack):
        differ.append("slack")
    out = {"cand": int(k.cand), "dropped": int(k.dropped), "slack": float(k.slack),
           "full_rows": int((k.thr != bpm.INT32_MAX).sum()),
           "dynamic": int(b.dynamic.sum())}
    verdict = "identical (slack bit for bit)" if not differ else "DIFFER in " + ", ".join(differ)
    print(f"refresh lists vs plain ({label}, N = {b.n}, D = {degree}, {ex.shape[0]} exclusion "
          f"columns): {verdict}; "
          f"cand {out['cand']}, dropped {out['dropped']}, rows at the width {out['full_rows']}, "
          f"dynamic rows {out['dynamic']}, slack {out['slack']:.6g}")
    if differ:
        fail(f"refresh lists, {label}: the kernels differ from the plain version in {differ}")
    return out


def compare_predicate(label, world, params) -> float:
    """k_refresh_needed against ``refresh_needed_plain`` on the same state:
    the bool equal, dev_raw bit for bit, dev_mm (through world-wide sums in
    another order than torch.sum's) within 1e-5 relative, 1e-6 absolute;
    and both deviations the bits of K2's lanes 3 and 4 on the same state
    (the shared fold).  Returns dev_mm's difference."""
    from avbd3d_tpu_torch import kernels, solver_cuda
    from avbd3d_tpu_torch.ops import broadphase as bpm

    b, bp, margin = world.bodies, world.bp, params.bp_margin
    need, devs = kernels.launch_refresh_needed(b, bp.anchor, bp.anchor_quat, bp.slack, margin)
    need_p = bpm.refresh_needed_plain(bp, b, margin)
    mm, raw = bpm.anchor_deviation(b.pos, b.quat, b.radius, b.dynamic, bp.anchor, bp.anchor_quat)
    lanes = solver_cuda.control_lanes(bp.nb, b, bp.anchor, bp.anchor_quat, params)
    sync()
    err = abs(float(devs[0]) - float(mm))
    ok = (bool(need) == bool(need_p), same_bits(devs[1], raw),
          err <= 1e-6 + 1e-5 * abs(float(mm)), same_bits(devs, lanes[3:5]))
    print(f"refresh predicate vs plain ({label}, N = {b.n}): need {bool(need)} (plain "
          f"{bool(need_p)}); dev_raw {float(devs[1]):.6g} {'bit for bit' if ok[1] else 'DIFFERS'}; "
          f"dev_mm {float(devs[0]):.6g}, abs err {err:.3e}; both the bits of K2's lanes 3 and 4: "
          f"{ok[3]}")
    if not all(ok):
        fail(f"refresh predicate, {label}: need equal, dev_raw bits, dev_mm bound, K2's bits: {ok}")
    return err


def row_split_check(label, world, degree, margin) -> None:
    """The lists kernel on two halves of the rows (their global offset
    ``row0``) against every column, as a body-sharded world calls it: each
    half's slots, keys and thresholds are the whole launch's rows, the
    halves' counts sum and their slacks take the min to the whole's."""
    import torch

    from avbd3d_tpu_torch import kernels

    b, ex = world.bodies, world.exclusions
    table, max_wh = kernels.launch_bp_tables(b.pos, b.quat, b.size, 0.5, b.radius, b.inv_mass)
    whole = kernels.launch_bp_lists(table, table, max_wh, ex, degree, margin)
    half = b.g // 2
    parts = [kernels.launch_bp_lists(table[g0 * 128:(g0 + half) * 128], table, max_wh,
                                     ex[:, g0:g0 + half].contiguous(), degree, margin, g0 * 128)
             for g0 in (0, half)]
    sync()
    same = [torch.equal(whole[k], torch.cat([p[k] for p in parts], dim=-2)) for k in range(2)]
    same.append(torch.equal(whole[2], torch.cat([p[2] for p in parts])))
    same += [int(whole[k]) == sum(int(p[k]) for p in parts) for k in (3, 5)]
    same.append(same_bits(whole[4], torch.minimum(parts[0][4], parts[1][4])))
    print(f"refresh lists by halves of the rows ({label}, rows 0-{half * 128 - 1} and "
          f"{half * 128}-{b.n - 1} against all {b.n} columns): nb, key, thr, cand, kept, slack "
          f"{'the whole launch' + chr(39) + 's' if all(same) else 'DIFFER: ' + str(same)}")
    if not all(same):
        fail(f"refresh lists by halves, {label}: {same}")


def compressed(world, params, cap, scale=0.9):
    """``world`` with every dynamic body's position scaled by ``scale``
    about the origin (the ground's top face is y = 0), so that a spawn's
    layers overlap, and its lists anchored at the scaled poses; and the
    lists anchored at the poses as they were."""
    import torch

    from avbd3d_tpu_torch.ops.broadphase import build_bp_cache

    b = world.bodies
    before = build_bp_cache(b, world.exclusions, cap.max_degree, params.bp_margin)
    b = b.replace(pos=torch.where((b.inv_mass > 0.0)[None], b.pos * scale, b.pos))
    return world.replace(bodies=b, bp=build_bp_cache(b, world.exclusions, cap.max_degree,
                                                     params.bp_margin)), before


def refresh_bounds(world, degree) -> dict:
    """The least time for a refresh and for the predicate at ``world``
    (bytes: each input read once and each output written once; operations:
    the dynamic rows' pairs and the bodies' terms)."""
    b, ex, bp = world.bodies, world.exclusions, world.bp
    n = b.n
    lists_bytes = (nbytes([getattr(b, f) for f in ("pos", "quat", "size", "radius", "inv_mass")],
                          ex) + 4 * (2 * degree * n + n + 4))
    lists_ops = int(b.dynamic.sum()) * n * OPS_BP_PAIR + n * OPS_BP_BODY
    pred_bytes = nbytes([getattr(b, f) for f in ("pos", "quat", "radius", "inv_mass")],
                        bp.anchor, bp.anchor_quat, bp.slack) + 1
    return {"lists": bound(lists_bytes, lists_ops), "predicate": bound(pred_bytes,
                                                                       n * OPS_ANCHOR_BODY)}


def refresh_times(card, label, world, degree, params) -> dict:
    """At ``world``: a refresh on the card (both kernels) and the predicate,
    each against its plain version (CUDA events back to back, traced and
    held to its kernels, once each a call), the plain versions' launches a
    call (a trace), and the bounds."""
    from avbd3d_tpu_torch.ops import broadphase as bpm

    b, ex, bp, margin = world.bodies, world.exclusions, world.bp, params.bp_margin
    reps = 100 if b.n <= 5120 else 20
    lists = one_kernel_times(
        card, f"refresh lists ({label}, N = {b.n}, D = {degree})", REFRESH_KERNELS,
        lambda: bpm.build_bp_cache(b, ex, degree, margin),
        lambda: plain_cache(b, ex, degree, margin), reps)
    lists["plain_launches"], lists["plain_device_us"] = device_launches(
        lambda: plain_cache(b, ex, degree, margin), 2)
    pred = one_kernel_times(
        card, f"refresh predicate ({label}, N = {b.n})", PREDICATE_KERNEL,
        lambda: bpm.refresh_needed(bp, b, margin), lambda: bpm.refresh_needed_plain(bp, b, margin),
        reps)
    pred["plain_launches"], pred["plain_device_us"] = device_launches(
        lambda: bpm.refresh_needed_plain(bp, b, margin), 2)
    bnd = refresh_bounds(world, degree)
    for what, t in (("lists", lists), ("predicate", pred)):
        t["bound_ms"], t["bound_by"] = bnd[what]
        print(f"[{card}] refresh {what} ({label}): kernels {t['ms']:.4f} ms a call "
              f"({t['device_us']:.1f} us on the card), the torch version {t['plain_ms']:.4f} ms "
              f"({t['plain_launches']:.0f} launches, {t['plain_device_us']:.1f} us on the card); "
              f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
    return {"lists": lists, "predicate": pred}


# The state at which rows hold more masked columns than k_bp_lists' per-row
# buffer (its cut to the D smallest keys runs): settled Stress4096 with a
# 2.5 m margin, every interior cube within reach of its 7^3 - 1 nearest.
OVER_BUFFER = "Stress4096 step 2800, margin 2.5 (rows past the per-row buffer)"


def masked_per_row(world, degree, margin):
    """Each row's masked columns (``candidate_lists_plain``'s mask, rows in
    blocks of 1024) on the card."""
    import torch

    from avbd3d_tpu_torch.ops import broadphase as bpm

    b = world.bodies
    n = b.n
    c = b.pos.reshape(3, n)
    wh = bpm.world_halves_rows(b.quat, tuple(b.size[k] * 0.5 for k in range(3))).reshape(3, n)
    radius, dyn = b.radius.reshape(n), b.dynamic.reshape(n)
    jj = torch.arange(n, device=c.device)[None]
    out = []
    for r0 in range(0, n, 1024):
        sl = slice(r0, r0 + 1024)
        gap = bpm._cheb_gap(c[:, sl, None], wh[:, sl, None], c[:, None], wh[:, None], margin)
        mask = ((gap <= 0.0) & bpm._real_pair(radius[sl, None], radius[None], margin)
                & (torch.arange(r0, min(r0 + 1024, n), device=c.device)[:, None] != jj)
                & dyn[sl, None])
        out.append(mask.sum(1))
    return torch.cat(out)


def refresh_phase_states(card, scene, saved, init, w2048, s2048, grid, jointed, pile) -> dict:
    """Phase 19 at this run's states: Stress1000 (N = 1024, D = 24) at its
    initial, landing (150) and settled (700) states, settled also at D = 4
    (rows beyond the width: the bisection) and D = 40, and with every body
    static; Stress2048 (N = 2048, D = 24) at steps 700 and 800 (100 and 200
    steps on from phase 7's state); Stress4096 (N = 5120, D = 28) at steps
    800 and 2800 (1800 grid steps on from phase 5's state); RodJointed at
    step 600 (exclusion columns); the 16384-body pile of phase 17 with its
    spawn's positions scaled by 0.9 (overlapping layers).  The predicate at
    those states with their own lists and at three against older lists (the
    refresh due)."""
    from avbd3d_tpu_torch import solver

    p, deg = scene.params, scene.cap.max_degree
    p48, c48 = s2048.params, s2048.cap
    s700 = solver.run_steps(w2048, p48, c48, 100)
    s800 = solver.run_steps(s700, p48, c48, 100)
    p4, c4 = grid["params"], grid["scene"].cap
    g800 = grid["step 800"]
    g2800 = solver.run_steps(grid["settled"], p4, c4, 1800)
    rod_scene, rod = jointed["rod"]
    pr, ppile = rod_scene.params, pile.params
    big, spawn_lists = compressed(pile.world, ppile, pile.cap)
    settled = saved["settled"]
    lists = {
        "Stress1000 initial": (init, deg, p.bp_margin),
        "Stress1000 landing (step 150)": (saved["landing"], deg, p.bp_margin),
        "Stress1000 settled (step 700)": (settled, deg, p.bp_margin),
        "Stress1000 settled, D = 4 (rows beyond the width)": (settled, 4, p.bp_margin),
        "Stress1000 settled, D = 40": (settled, 40, p.bp_margin),
        "Stress1000 initial, every body static": (unmoved_world(init), deg, p.bp_margin),
        "Stress2048 step 700": (s700, c48.max_degree, p48.bp_margin),
        "Stress2048 step 800": (s800, c48.max_degree, p48.bp_margin),
        "Stress4096 step 800": (g800, c4.max_degree, p4.bp_margin),
        "Stress4096 step 2800": (g2800, c4.max_degree, p4.bp_margin),
        OVER_BUFFER: (g2800, c4.max_degree, 2.5),
        "RodJointed step 600 (exclusions)": (rod, rod_scene.cap.max_degree, pr.bp_margin),
        "pile 31x17x31, spawn compressed to 0.9": (big, pile.cap.max_degree, ppile.bp_margin)}
    predicate = {
        "Stress1000 landing (step 150)": (saved["landing"], p),
        "Stress1000 settled (step 700)": (settled, p),
        "Stress1000 settled against the landing's lists": (
            settled.replace(bp=saved["landing"].bp), p),
        "Stress1000 initial, every body static": (unmoved_world(init), p),
        "Stress2048 step 700": (s700, p48), "Stress2048 step 800": (s800, p48),
        "Stress4096 step 800": (g800, p4), "Stress4096 step 2800": (g2800, p4),
        "Stress4096 step 2800 against step 800's lists": (g2800.replace(bp=g800.bp), p4),
        "RodJointed step 600": (rod, pr),
        "pile 31x17x31, spawn compressed to 0.9": (big, ppile),
        "pile 31x17x31 compressed, against its spawn's lists": (
            big.replace(bp=spawn_lists), ppile)}
    timed = {"Stress1000 settled": (settled, deg, p),
             "Stress2048 step 800": (s800, c48.max_degree, p48),
             "Stress4096 step 2800": (g2800, c4.max_degree, p4),
             "pile 31x17x31 compressed": (big, pile.cap.max_degree, ppile)}
    return {**refresh_phase(card, lists, predicate, timed), "g2800": g2800}


def refresh_phase(card, lists: dict, predicate: dict, timed: dict) -> dict:
    """Phase 19: the refresh kernels against their plain versions at every
    state of ``lists`` ({label: (world, degree, margin)}, compare_lists) and
    the predicate at every state of ``predicate`` ({label: (world,
    params)}, compare_predicate), the row split of a sharded call at the
    first Stress4096 state, and the times of both at the states of
    ``timed`` ({label: (world, degree, params)})."""
    out = {label: compare_lists(label, *args) for label, args in lists.items()}
    if OVER_BUFFER in lists:
        over = masked_per_row(*lists[OVER_BUFFER])
        from avbd3d_tpu_torch import kernels

        full = int((over > kernels.BP_ROW_BUFFER).sum())
        print(f"refresh lists ({OVER_BUFFER}): {full} rows hold more masked columns than the "
              f"kernel's buffer of {kernels.BP_ROW_BUFFER} keys (most {int(over.max())})")
        if full == 0:
            fail(f"refresh lists, {OVER_BUFFER}: no row past the per-row buffer")
    from avbd3d_tpu_torch.ops import broadphase as bpm

    err = max(compare_predicate(label, *args) for label, args in predicate.items())
    needs = {bool(bpm.refresh_needed_plain(w.bp, w.bodies, p.bp_margin))
             for w, p in predicate.values()}
    if needs != {True, False}:
        fail(f"refresh predicate: the states took only {needs}")
    split = next(label for label in lists if label.startswith("Stress4096"))
    row_split_check(split, *lists[split])
    times = {label: refresh_times(card, label, *args) for label, args in timed.items()}
    return {"lists": out, "predicate_err": err, "times": times}


# ---------------------------------------------------------------------------
# The grid step's stage kernels on the card (phase 20)
# ---------------------------------------------------------------------------

# The kernels of csrc/grid_stages.cu by wrapper (solver_grid), once a call;
# what of the reference each replaces (no Pallas kernel: XLA stages of its
# jitted step), and the kernels line's note on each.
STAGE_KERNELS = {"grid_gates": "k_grid_gates", "grid_predict": "k_grid_predict",
                 "grid_finalize": "k_grid_finalize"}
STAGE_REPLACES = {"grid_gates": "avbd3d_tpu/solver.py:322",
                  "grid_predict": "avbd3d_tpu/solver.py:194",
                  "grid_finalize": "avbd3d_tpu/solver.py:234"}
STAGE_NOTES = {
    "grid_gates": "no Pallas kernel: the reference's fall-freeze (solver.py:322-330), "
                  "refresh_or_reuse's predicate (ops/broadphase.py:153-188) and "
                  "stale_lhs_ok(refine=False) (solver.py:73-112) in XLA; timed at Stress4096 "
                  "step 2800 (N = 5120); max_abs_err: dev_mm (flags, dev_raw, v^2 max and "
                  "frozen fields bit for bit at the eleven states of phase 20)",
    "grid_predict": "no Pallas kernel: the reference's predict (solver.py:194-231) in XLA; "
                    "a grid of at most two blocks an SM (avbd_grid_predict), eight latch warps "
                    "a block copying four latches a thread, a linear and an angular warp a "
                    "block (a lane a body's half), the count and the ticket in one 64-bit atomic "
                    "(a thread a latch and a thread a body on 1280 blocks took 4.92 us on the "
                    "card, PERF.md section 6); timed at Stress4096 step 2800 (N = 5120); every "
                    "output bit for bit at the eleven states of phase 20",
    "grid_finalize": "no Pallas kernel: the reference's pose sanitizes (solver_tpu.py:"
                     "1808-1817) and finalize (solver.py:234-317) in XLA; a grid of at most "
                     "two blocks an SM (avbd_grid_finalize), eight slot warps and two body "
                     "warps a block (a lane a body's linear or angular half), the lanes folded "
                     "by warp reductions and atomics into ten words (a thread a (slot, body) "
                     "and a one-warp tail took 15.5 us on the card, PERF.md section 6); timed "
                     "at Stress4096 step 2800 (N = "
                     "5120); max_abs_err: the speed lanes' relative difference (torch's "
                     "vector_norm), bodies, latches and the other lanes identical at the eleven "
                     "states of phase 20"}
# Float operations a unit, from csrc/grid_stages.cu's statements, rounded
# down: k_grid_gates' freeze, anchor terms, partials and deviation pass of
# a body; k_grid_predict's sanitizes, clamp, inertial pose, normalize and
# warm start of a body; k_grid_finalize's sanitizes, velocities and speeds
# of a body and its maxima of a contact slot (4 contacts).
OPS_GATES_BODY = 70
OPS_PREDICT_BODY = 110
OPS_FINALIZE_BODY = 70
OPS_FINALIZE_SLOT = 16


def stage_args(world, params, cap) -> dict:
    """The three stage kernels' operands at the next grid step of ``world``,
    prepared by the plain versions as ``solver._grid_step`` and
    ``solver_grid.step_grid`` prepare them (the refresh or reuse, K5, the
    step's launches of K6): {"gates": (world, params), "predict": (bodies,
    stick, params), "finalize": grid_finalize's arguments}."""
    from avbd3d_tpu_torch import solver_cuda, solver_grid
    from avbd3d_tpu_torch.ops.broadphase import refresh_or_reuse

    wf, gates = solver_grid.grid_gates_plain(world, params)
    b = wf.bodies
    flags = [bool(x) for x in gates[:3].tolist()]
    bp, _ = refresh_or_reuse(wf.bp, flags[0], b, wf.exclusions, cap.max_degree, params.bp_margin)
    lv, av, ip, iq, ps, stickf, san = solver_grid.grid_predict_plain(b, wf.contacts.stick, params)
    c, kept, once, dropped = solver_grid.collide_grid(wf.contacts, bp.nb, bp.key, bp.thr, b,
                                                      params, stickf=stickf)
    pos, quat, lam, pen, sf = ps, iq, c.lam, c.penalty, c.stick
    n_iters, k = solver_cuda.select_variant(params, flags[1], flags[2])
    for spec in solver_grid.grid_specs(params, n_iters, k, cap.grid_residency):
        pos, quat, lam, pen, sf, sep = solver_grid.iterblock_grid(
            params, solver_grid.pick_gb(b.g), spec, c, b, pos, quat, lam, pen, sf, ip, iq)
    c = c.replace(lam=lam, penalty=pen, stick=sf)
    return {"gates": (world, params), "predict": (b, wf.contacts.stick, params),
            "finalize": (wf.replace(bp=bp), b, c, pos, quat, lv, av, san, sep, once, kept,
                         bp.cand, dropped, params)}


def compare_stages(label, world, params, cap, nan_pose=False, sep=None) -> dict:
    """k_grid_gates, k_grid_predict and k_grid_finalize against their plain
    versions on the same card tensors at the next grid step of ``world``:
    the gates' flags, dev_raw, v^2 max and frozen fields bit for bit (a NaN
    matching a NaN), dev_mm (sums over the world in another order than
    torch.sum's) within 1e-5 relative, 1e-6 absolute; the prediction's
    outputs bit for bit; the finalize's bodies and latches bit for bit, its
    diagnostics lanes identical but the speeds (2, 3: torch's vector_norm)
    within 1e-6 relative; dev_mm and dev_raw also bit for bit those of
    k_refresh_needed on the frozen bodies.  ``nan_pose``: K6's last
    position of one body set to NaN (the finalize's sanitize).  ``sep``:
    "nan", one live slot's last separation NaN (lanes 0 and 1 NaN); "zero",
    every separation +0 (lane 0 folds the live slots' -0 against the +0
    start: +0, lane 1 the slop); the lanes compared with a NaN matching a
    NaN, and at ``sep`` lanes 0 and 1 to those values bit for bit.  Returns the flags and the largest dev_mm and speed-lane
    differences."""
    import torch

    from avbd3d_tpu_torch import kernels, solver_grid

    a = stage_args(world, params, cap)
    if nan_pose:
        a["finalize"][3].view(3, -1)[1, 11] = float("nan")
    contacts, seps = a["finalize"][2], a["finalize"][8]
    if sep == "nan":
        live = torch.nonzero(((contacts.count > 0) & (contacts.other >= 0)).reshape(-1))
        seps[0].view(-1)[int(live[len(live) // 2])] = float("nan")
    if sep == "zero":
        seps.zero_()
    wk, gk = solver_grid.grid_gates(*a["gates"])
    wp, gp = solver_grid.grid_gates_plain(*a["gates"])
    pk = solver_grid.grid_predict(*a["predict"])
    pp = solver_grid.grid_predict_plain(*a["predict"])
    fk = solver_grid.grid_finalize(*a["finalize"])
    fp = solver_grid.grid_finalize_plain(*a["finalize"])
    sync()
    bad = []
    if not same_bits_nan(gk[[0, 1, 2, 4, 5]], gp[[0, 1, 2, 4, 5]]):
        bad.append(f"gates {gk.tolist()} vs {gp.tolist()}")
    finite = math.isfinite(float(gp[3]))
    mm_err = abs(float(gk[3]) - float(gp[3])) if finite else (
        0.0 if same_bits_nan(gk[3:4], gp[3:4]) else math.inf)
    if not mm_err <= (1e-6 + 1e-5 * abs(float(gp[3])) if finite else 0.0):
        bad.append(f"dev_mm {float(gk[3])} vs {float(gp[3])}")
    # The deviations' bits are those of the fold k_refresh_needed and K2 run
    # (fold_parts_warp, dev_mm_block), the one the gates kernel ran alone in
    # one block before it spread its tail over the card.
    gw, gparams = a["gates"]
    _need, devs = kernels.launch_refresh_needed(wk.bodies, gw.bp.anchor, gw.bp.anchor_quat,
                                                gw.bp.slack, gparams.bp_margin)
    sync()
    if not same_bits_nan(gk[3:5], devs):
        bad.append(f"dev_mm, dev_raw {gk[3:5].tolist()} vs k_refresh_needed's {devs.tolist()}")
    bad += [f"frozen {f}" for f in ("linvel", "angvel", "inv_mass")
            if not same_bits_nan(getattr(wk.bodies, f), getattr(wp.bodies, f))]
    bad += [f"predict output {i}" for i, (x, y) in enumerate(zip(pk, pp))
            if not same_bits_nan(x, y)]
    bad += [f"finalize {f}" for f in ("pos", "quat", "linvel", "angvel", "prev_linvel",
                                      "prev_angvel")
            if not same_bits_nan(getattr(fk.bodies, f), getattr(fp.bodies, f))]
    if not torch.equal(fk.contacts.stick, fp.contacts.stick):
        bad.append("finalize stick")
    dk, dp = fk.diagnostics.vec, fp.diagnostics.vec
    lanes = [0, 1, 4] + list(range(5, 16))
    if not equal_nan(dk[lanes], dp[lanes]):
        bad.append(f"diagnostics {dk.tolist()} vs {dp.tolist()}")
    pinned = {"nan": [float("nan")] * 2, "zero": [0.0, params.penetration_slop]}.get(sep)
    if pinned is not None and not same_bits_nan(dk[:2], torch.tensor(pinned, device=dk.device)):
        bad.append(f"lanes 0, 1 {dk[:2].tolist()} at separations {sep}: expected {pinned} "
                   f"(a zero as +0)")
    speed_err = float(((dk[2:4] - dp[2:4]).abs() / dp[2:4].abs().clamp(min=1e-30)).max())
    if not speed_err <= 1e-6:
        bad.append(f"speed lanes {dk[2:4].tolist()} vs {dp[2:4].tolist()}")
    flags = [bool(x) for x in gk[:3].tolist()]
    d = dk.tolist()
    print(f"grid stages vs plain ({label}, N = {world.bodies.n}): need {flags[0]}, stale_ok "
          f"{flags[1]}, calm {flags[2]}; dev_mm abs err {mm_err:.3e}; frozen fields, "
          f"prediction, bodies and latches {'bit for bit' if not bad else 'DIFFER'}; "
          f"sanitized {int(pk[6])} + {int(d[8]) - int(pk[6])}, manifolds {int(d[6])}, "
          f"contacts {int(d[5])}, pair overflow {int(d[9])}; speed lanes rel err "
          f"{speed_err:.3e} (lin {d[2]:.6g}, ang {d[3]:.6g})")
    if bad:
        fail(f"grid stages, {label}: {bad}")
    return {"flags": flags, "mm_err": mm_err, "speed_err": speed_err, "args": a}


def same_bits_nan(a, b) -> bool:
    """``same_bits``, with a NaN matching a NaN (the sanitizes' inputs)."""
    import torch

    if a.dtype != torch.float32:
        return same_bits(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and same_bits(torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


def stage_bounds(a) -> dict:
    """The least time for each stage kernel at ``stage_args`` ``a``: its
    inputs read once and outputs written once, over 3.35 TB/s, against its
    float operations over 67 TFLOP/s."""
    from avbd3d_tpu_torch import solver_grid

    world, params = a["gates"]
    b, bp = world.bodies, world.bp
    n = b.n
    gates_in = nbytes([getattr(b, f) for f in ("pos", "quat", "linvel", "angvel", "inv_mass",
                                               "radius")], bp.anchor, bp.anchor_quat, bp.slack)
    gates_out = nbytes([getattr(b, f) for f in ("linvel", "angvel", "inv_mass")]) + 6 * 4
    pb, stick, _p = a["predict"]
    pred_in = nbytes([getattr(pb, f) for f in ("pos", "quat", "linvel", "angvel", "prev_linvel",
                                               "inv_mass")], stick)
    pred_out = nbytes(solver_grid.grid_predict_plain(*a["predict"]))
    _w, fb, c, pos, quat, lv, av, san, sep, once, kept, cand, dropped, _p = a["finalize"]
    fin_in = nbytes(pos, quat, [getattr(fb, f) for f in ("pos", "quat", "linvel", "angvel",
                                                         "prev_linvel", "prev_angvel",
                                                         "inv_mass")],
                    lv, av, san, c.count, c.other, sep, c.lam[0::3], once, c.stick, kept, cand,
                    dropped)
    fin_out = nbytes(pos, quat, lv, av, lv, av) + c.stick.numel() + 16 * 4
    slots = int((c.other >= 0).sum())
    return {"grid_gates": bound(gates_in + gates_out, n * OPS_GATES_BODY),
            "grid_predict": bound(pred_in + pred_out, n * OPS_PREDICT_BODY),
            "grid_finalize": bound(fin_in + fin_out,
                                   n * OPS_FINALIZE_BODY + slots * OPS_FINALIZE_SLOT)}


def stage_world(world, params, kind: str):
    """``world`` with three dynamic bodies below ``fall_freeze_y``
    ("fallen"), with a NaN linear and an infinite angular velocity ("nan"),
    with the 8th dynamic body's pos.y NaN ("nan pose") or with the first
    dynamic body at pos.x 3.4e38 and linvel.x 3e38 ("overflow": pos +
    linvel dt passes the largest float32, so its inertial position is
    infinite and its warm start sanitized)."""
    import torch

    if kind == "nan pose":
        return nan_pose(world, 1)
    b = world.bodies
    if kind == "overflow":
        i = int(torch.nonzero((b.inv_mass > 0).reshape(-1)).flatten()[0])
        pos, lv = b.pos.clone(), b.linvel.clone()
        pos.view(3, -1)[0, i] = 3.4e38
        lv.view(3, -1)[0, i] = 3.0e38
        return world.replace(bodies=b.replace(pos=pos, linvel=lv))
    ids = torch.nonzero((b.inv_mass > 0).reshape(-1)).flatten()[:3]
    if kind == "fallen":
        pos = b.pos.clone()
        pos.view(3, -1)[1, ids] = params.fall_freeze_y - 1.0
        return world.replace(bodies=b.replace(pos=pos))
    lv, av = b.linvel.clone(), b.angvel.clone()
    lv.view(3, -1)[0, ids[0]] = float("nan")
    av.view(3, -1)[2, ids[1]] = float("inf")
    return world.replace(bodies=b.replace(linvel=lv, angvel=av))


def stages_phase(card, grid, g2800, low_drop) -> dict:
    """Phase 20: the three stage kernels against their plain versions at
    Stress4096 steps 800 and 2800, step 2800 with its lists fresh at its
    poses (no refresh due), the low-drop 16^3 pile of phase 6, step 800
    with every body static, with three bodies below fall_freeze_y and with
    a NaN and an infinite velocity (and a NaN final pose), with a NaN pos.y
    and with a body whose inertial position overflows, and step 2800
    with one live slot's separation NaN and with every separation +0 (the
    finalize's fold); every flag takes both values.  Then each kernel's time at step 2800 beside its
    plain version's (traced, held to one kernel a call) and its bound."""
    from avbd3d_tpu_torch import solver_grid
    from avbd3d_tpu_torch.ops.broadphase import build_bp_cache

    p4, c4 = grid["params"], grid["scene"].cap
    g800 = grid["step 800"]
    wl, pl, cl = low_drop
    fresh = g2800.replace(bp=build_bp_cache(g2800.bodies, g2800.exclusions, c4.max_degree,
                                            p4.bp_margin))
    states = {"Stress4096 step 800": (g800, p4, c4, False),
              "Stress4096 step 2800": (g2800, p4, c4, False),
              "Stress4096 step 2800, lists fresh at its poses": (fresh, p4, c4, False),
              "low-drop 16^3, step 90": (wl, pl, cl, False),
              "Stress4096 step 800, every body static": (unmoved_world(g800), p4, c4, False),
              "Stress4096 step 800, three bodies fallen": (stage_world(g800, p4, "fallen"), p4,
                                                           c4, False),
              "Stress4096 step 800, NaN velocities and a NaN final pose": (
                  stage_world(g800, p4, "nan"), p4, c4, True),
              "Stress4096 step 800, a NaN pos.y": (stage_world(g800, p4, "nan pose"), p4, c4,
                                                   False),
              "Stress4096 step 800, a body at pos.x 3.4e38 moving at 3e38": (
                  stage_world(g800, p4, "overflow"), p4, c4, False),
              "Stress4096 step 2800, a live slot's separation NaN": (g2800, p4, c4, False,
                                                                      "nan"),
              "Stress4096 step 2800, every separation +0": (g2800, p4, c4, False, "zero")}
    out = {label: compare_stages(label, *args) for label, args in states.items()}
    seen = [{r["flags"][k] for r in out.values()} for k in range(3)]
    if any(s != {True, False} for s in seen):
        fail(f"grid stages: the flags (need, stale_ok, calm) took only {seen}")
    a = out["Stress4096 step 2800"]["args"]
    bounds = stage_bounds(a)
    times = {}
    calls = {"grid_gates": (solver_grid.grid_gates, solver_grid.grid_gates_plain, a["gates"]),
             "grid_predict": (solver_grid.grid_predict, solver_grid.grid_predict_plain,
                              a["predict"]),
             "grid_finalize": (solver_grid.grid_finalize, solver_grid.grid_finalize_plain,
                               a["finalize"])}
    for name, (kern, plain, args) in calls.items():
        t = one_kernel_times(card, f"{name} (Stress4096 step 2800, N = 5120)",
                             STAGE_KERNELS[name], lambda kern=kern, args=args: kern(*args),
                             lambda plain=plain, args=args: plain(*args))
        t["plain_launches"], t["plain_device_us"] = device_launches(
            lambda plain=plain, args=args: plain(*args), 2)
        t["bound_ms"], t["bound_by"] = bounds[name]
        print(f"[{card}] {name}: kernel {t['ms']:.4f} ms a call ({t['device_us']:.2f} us on the "
              f"card), plain {t['plain_ms']:.4f} ms ({t['plain_launches']:.0f} launches, "
              f"{t['plain_device_us']:.1f} us on the card); bound {t['bound_ms'] * 1e3:.3f} us "
              f"({t['bound_by']})")
        times[name] = t
    return {"states": {k: {f: v[f] for f in ("flags", "mm_err", "speed_err")}
                       for k, v in out.items()},
            "mm_err": max(v["mm_err"] for v in out.values()),
            "speed_err": max(v["speed_err"] for v in out.values()), "times": times,
            "args": a}


# ---------------------------------------------------------------------------
# The fused path's stage kernels on the card (phase 21)
# ---------------------------------------------------------------------------

# The kernels of csrc/fused_stages.cu by wrapper (solver), once a call; what
# of the reference each replaces (no Pallas kernel: XLA stages of its jitted
# step), and the kernels line's note on each.
FUSED_KERNELS = {"step_gates": "k_step_gates", "ballistic_step": "k_ballistic_step"}
FUSED_REPLACES = {"step_gates": "avbd3d_tpu/solver.py:325",
                  "ballistic_step": "avbd3d_tpu/solver.py:418"}
FUSED_NOTES = {
    "step_gates": "no Pallas kernel: the reference's fall-freeze (solver.py:325-333) in XLA and "
                  "the port's control vector (the step's one host read); a thread a float of "
                  "the 7 planes of frozen fields, its loads before its one store, the control "
                  "vector on a block of its own (a thread a body took 1.72 us on the card, "
                  "PERF.md section 6); timed at settled "
                  "Stress1000 (N = 1024) beside k_launch_floor at its grid and block, empty, "
                  "with a load and a store a thread and with the gates' own three loads before "
                  "its store (floor_us); the control vector and frozen fields bit for bit at "
                  "the states of phase 21",
    "ballistic_step": "no Pallas kernel: the reference's ballistic step (solver.py:418-447: "
                      "predict and finalize) in XLA, K2 writing lanes 11-15 into its vector; "
                      "a grid of at most two blocks an SM (avbd_ballistic_step), eight slot "
                      "warps and a linear and an angular warp a block (a lane a body's half of "
                      "the prediction and the finalize), the lanes by atomics into seven words "
                      "(a thread a (slot, body) and a last block folding the partials took 7.89 "
                      "us on the card, PERF.md section 6); "
                      "timed at the rain-in state (Stress1000 step 1, N = 1024, DC = 12), "
                      "its bound from the live contacts' normal duals there; "
                      "max_abs_err: the speed lanes' relative difference, bodies and the other "
                      "lanes identical at the states of phase 21"}
# Float operations a unit, from csrc/fused_stages.cu's statements, rounded
# down: k_step_gates' freeze test of a body; k_ballistic_step's prediction
# (OPS_PREDICT_BODY), finalize velocities and speeds of a body and its
# maxima of a live contact (s < count of a slot with a partner: a negation,
# a subtraction, an abs and three maxes).
OPS_STEP_GATES_BODY = 1
OPS_BALLISTIC_BODY = OPS_PREDICT_BODY + 60
OPS_BALLISTIC_CONTACT = 6
# The falling window phase 21 traces: steps 1-100 of Stress1000, the
# rain-in's ballistic steps and the first contact steps.
FALLING_TRACE_STEPS = 100


def fused_world(world, params, kind: str):
    """``world`` with a NaN ``pos.y`` ("nan pose") or ``pos.x`` ("nan pose
    x") on one dynamic body, or ``stage_world``'s fallen bodies,
    non-finite velocities (with a third body spinning above
    ``max_angular_speed``, the clamp) and overflowed body."""
    import torch

    if not kind.startswith("nan pose"):
        w = stage_world(world, params, kind)
        if kind == "nan":
            b = w.bodies
            ids = torch.nonzero((b.inv_mass > 0).reshape(-1)).flatten()[:3]
            av = b.angvel.clone()
            av.view(3, -1)[0, ids[2]] = 4.0 * params.max_angular_speed
            w = w.replace(bodies=b.replace(angvel=av))
        return w
    return nan_pose(world, 0 if kind == "nan pose x" else 1)


def nan_pose(world, comp: int = 1):
    """``world`` with the 8th dynamic body's ``pos[comp]`` NaN (its lists,
    cache and diagnostics those of the finite world)."""
    import torch

    b = world.bodies
    i = int(torch.nonzero((b.inv_mass > 0).reshape(-1)).flatten()[7])
    pos = b.pos.clone()
    pos.view(3, -1)[comp, i] = float("nan")
    return world.replace(bodies=b.replace(pos=pos))


def equal_nan(a, b) -> bool:
    """Equal values, a NaN matching a NaN (zeros of either sign equal)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


def rel_err_nan(a, b, floor: float = 1.0) -> float:
    """Largest |a - b| / (|b| + ``floor``); equal values (an infinity the
    same infinity) and NaN on both sides count 0, NaN on one side only inf."""
    import torch

    both = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(both, 0.0, (a - b).abs() / (b.abs() + floor))
    return float(torch.where(torch.isnan(d), float("inf"), d).max())


def compare_fused(label, world, params, cap) -> dict:
    """k_step_gates, k_ballistic_step, the ballistic step with K2's ``out=``
    and K1's new tail against their plain versions on the same card tensors
    at the next step of ``world``: the gates' control vector and frozen
    fields bit for bit (a NaN matching a NaN), ``world`` itself unchanged;
    the ballistic kernel's bodies bit for bit, its lanes 0, 1, 4-15
    identical and the speed lanes (2, 3) within 1e-6 relative; the whole
    ballistic step's bodies and lanes 0-10 those of ``_ballistic_step``, its
    lanes 11, 12, 13, 15 (K2's exact lanes) bit for bit and 14 within 1e-5
    relative, 1e-6 absolute, and lanes 11-15 the bits of K2's own call on
    the same bodies; K1: its cache (the bool latches among
    it), bodies and row 1 in the state layout against ``step_kernel_plain``'s
    (integers identical, floats difference 0, the control lanes 11-15
    within 1e-5 relative as ``compare_k1`` holds them), lane 9 both cand -
    kept in int32 and float(cand) - float(kept); at a NaN pose too, a NaN
    matching a NaN.  Returns the largest speed-lane and control-lane
    differences and the ballistic kernel's operands."""
    import torch

    from avbd3d_tpu_torch import kernels, solver, solver_cuda

    bad = []
    before = {f: getattr(world.bodies, f).clone() for f in ("linvel", "angvel", "inv_mass")}
    wk, gk = solver.step_gates(world, params)
    wp, gp = solver.step_gates_plain(world, params)
    sync()
    if not same_bits_nan(gk, gp):
        bad.append(f"control vector {gk.tolist()} vs {gp.tolist()}")
    bad += [f"frozen {f}" for f in before
            if not same_bits_nan(getattr(wk.bodies, f), getattr(wp.bodies, f))]
    bad += [f"the given world's {f} changed" for f, t in before.items()
            if not same_bits_nan(getattr(world.bodies, f), t)]
    frozen = int((world.bodies.inv_mass > 0).sum() - (wk.bodies.inv_mass > 0).sum())

    # The ballistic step's kernel alone, then with K2 (out=), on the frozen world.
    b = wp.bodies
    out = kernels.launch_ballistic_step(b, wp.contacts, params)
    ref = solver._ballistic_body(wp, params)
    names = ("pos", "quat", "linvel", "angvel", "prev_linvel", "prev_angvel")
    bad += [f"ballistic {f}" for f, t in zip(names, out[:6])
            if not same_bits_nan(t, getattr(ref.bodies, f))]
    dk, dp = out[6], ref.diagnostics.vec
    lanes = [0, 1, 4] + list(range(5, 16))
    if not equal_nan(dk[lanes], dp[lanes]) or not torch.equal(torch.signbit(dk[:2]),
                                                             torch.signbit(dp[:2])):
        bad.append(f"ballistic lanes {dk.tolist()} vs {dp.tolist()} (lanes 0, 1 sign bits "
                   f"{torch.signbit(dk[:2]).tolist()} vs {torch.signbit(dp[:2]).tolist()})")
    speed_err = float(((dk[2:4] - dp[2:4]).abs() / dp[2:4].abs().clamp(min=1e-30)).max())
    if not speed_err <= 1e-6:
        bad.append(f"ballistic speed lanes {dk[2:4].tolist()} vs {dp[2:4].tolist()}")
    full = solver.ballistic_step(wp, params)
    full_p = solver._ballistic_step(wp, params)
    own = solver_cuda.control_lanes(wp.bp.nb, full.bodies, wp.bp.anchor, wp.bp.anchor_quat,
                                    params)
    sync()
    vk, vp = full.diagnostics.vec, full_p.diagnostics.vec
    if not equal_nan(vk[:11], vp[:11]) or not same_bits_nan(vk[[11, 12, 13, 15]],
                                                            vp[[11, 12, 13, 15]]):
        bad.append(f"ballistic step lanes {vk.tolist()} vs {vp.tolist()}")
    lane14 = float_diff(vk[14:15], vp[14:15])
    if not lane14 <= 1e-6 + 1e-5 * abs(float(vp[14].nan_to_num())):
        bad.append(f"ballistic step lane 14 {float(vk[14])} vs {float(vp[14])}")
    if not same_bits(vk[11:], own):
        bad.append(f"K2 with out= {vk[11:].tolist()} vs its own call {own.tolist()}")
    bad += [f"ballistic step {f}" for f in names
            if not same_bits_nan(getattr(full.bodies, f), getattr(full_p.bodies, f))]

    # K1's state layout and latches.
    args = k1_inputs(world, types.SimpleNamespace(params=params, cap=cap))
    cand = args[10]
    cp, bp_, rp, _ = solver_cuda.step_kernel_plain(*args)
    ck, bk, rk, _ = solver_cuda.step_kernel(*args)
    sync()
    k1_differ = []
    for f in solver_cuda.CACHE_FIELDS:
        a, c = getattr(cp, f), getattr(ck, f)
        if not (float_diff(a, c) == 0.0 if a.dtype.is_floating_point else same_bits(a, c)):
            k1_differ.append(f"cache.{f}")
    k1_differ += [f"body output {i}" for i, (x, y) in enumerate(zip(bp_, bk))
                  if float_diff(x, y)]
    if ck.stick.dtype != torch.bool:
        bad.append(f"K1 latches of dtype {ck.stick.dtype}")
    sk, sp = rk[1, :16], rp[1, :16]
    bad += [f"K1 {x}" for x in k1_differ]
    if not equal_nan(sk[:11], sp[:11]) or not equal_nan(sk[:9], rk[0, :9]):
        bad.append(f"K1 state row {sk.tolist()} vs {sp.tolist()}")
    kept = int(rk[0, 9])
    if not (float(sk[9]) == float(cand.cpu() - kept) == float(cand.float() - rk[0, 9])
            and float(sk[10]) == float(rk[0, 15])):
        bad.append(f"K1 pair overflow {float(sk[9])}, cand {int(cand)}, kept {kept}")
    ctrl_err = rel_err_nan(sk[11:], rp[1, 11:16])
    if not ctrl_err <= 1e-5 or not same_bits(sk[11:], rk[0, 10:15]) or (
            rk[1, 16:].any()):
        bad.append(f"K1 state row control lanes {sk[11:].tolist()} vs {sp[11:].tolist()}")
    d = vk.tolist()
    print(f"fused stages vs plain ({label}, N = {world.bodies.n}): control vector, frozen "
          f"fields ({frozen} frozen), ballistic bodies, K1's state row and latches "
          f"{'bit for bit' if not bad else 'DIFFER'}; ballistic lanes: sanitized {int(d[8])}, "
          f"dynamic {int(d[7])}, speeds {d[2]:.6g} / {d[3]:.6g} (rel err {speed_err:.1e}), "
          f"K2's lane 14 abs err {lane14:.1e}; K1 row 1: contacts {int(sk[5])}, pair "
          f"overflow {int(sk[9])}, control lanes rel err {ctrl_err:.1e}")
    if bad:
        fail(f"fused stages, {label}: {bad}")
    return {"speed_err": speed_err, "ctrl_err": max(ctrl_err, lane14),
            "k1_differ": k1_differ, "frozen": frozen,
            "sanitized": int(d[8]), "args": (wp, b, params)}


def fused_bounds(gates_world, wp, b, params) -> dict:
    """The least time for each fused stage kernel: its inputs read once and
    outputs written once, over 3.35 TB/s, against its float operations
    over 67 TFLOP/s; the gates at ``gates_world``, the ballistic step at
    the frozen world ``wp`` (bodies ``b``).  The ballistic step needs every
    slot's count and partner, but the normal dual and the maxima only of
    the live contacts (s < count where the slot has a partner), which this
    state's cache gives."""
    import torch

    gb, gbp = gates_world.bodies, gates_world.bp
    gates_in = nbytes([getattr(gb, f) for f in ("pos", "linvel", "angvel", "inv_mass")],
                      gates_world.diagnostics.vec, gbp.slack, gbp.dropped)
    gates_out = nbytes([getattr(gb, f) for f in ("linvel", "angvel", "inv_mass")]) + 18 * 4
    c = wp.contacts
    s = torch.arange(4, device=c.count.device).view(4, *([1] * c.count.dim()))
    live = int(((s < c.count) & (c.other >= 0)).sum())
    bal_in = nbytes([getattr(b, f) for f in ("pos", "quat", "linvel", "angvel", "prev_linvel",
                                             "prev_angvel", "inv_mass")],
                    c.count, c.other) + live * c.lam.element_size()
    bal_out = nbytes([getattr(b, f) for f in ("pos", "quat", "linvel", "angvel", "prev_linvel",
                                              "prev_angvel")]) + 16 * 4
    return {"step_gates": bound(gates_in + gates_out, gb.n * OPS_STEP_GATES_BODY),
            "ballistic_step": bound(bal_in + bal_out,
                                    b.n * OPS_BALLISTIC_BODY + live * OPS_BALLISTIC_CONTACT),
            "live_contacts": live}


def block_kernels(w, p, cap, steps: int) -> dict:
    """The port's kernels, by name without template arguments, in a
    ``torch.profiler`` trace of ``steps`` steps from ``w``.  The session
    opens with two launches of K7 (``k_probe``, which no step launches),
    each synchronized, and leaves them out of the count: on the H100 the
    profiler drops one of the first records of the port's kernels in a
    session, whatever torch ran before it (seen: a fused block's first
    ``k_step_gates``, with one K7 launch before it)."""
    import torch

    from avbd3d_tpu_torch import solver, solver_cuda

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            solver_cuda.bp_probe(w.bp.nb, w.bodies, p)
            sync()
        solver.run_steps(w, p, cap, steps)
        sync()
    got = collections.Counter()
    for e in prof.key_averages():
        name = kernel_name(e.key).split("<")[0]
        if own_kernel(e.key) and name != "k_probe":
            got[name] += e.count
    return dict(got)


def fused_step_trace(card, label, w, p, cap, steps: int, want_ballistic: bool) -> dict:
    """``steps`` steps of the fused path from ``w`` traced
    (utils/profile_phases.trace, which runs the block untraced and then
    traced from the same state), with the launch counters reset before:
    the gates kernel once a step, K1 once a contact step, the ballistic
    kernel and K2 once a ballistic step (some when ``want_ballistic``, none
    otherwise), the refresh kernels on refresh steps, by the counters; in
    the trace no kernel but the port's (the host read's copy and K1's
    counter memset aside).  The port's kernels of the same block, traced
    again in a session of their own (``block_kernels``), must be what the
    counters give, kernel by kernel: ``k_step_gates`` a step,
    ``k_ballistic_step`` and ``k_control_lanes`` a ballistic step, the two
    refresh kernels a refresh, and K1's ``step_kernel_count`` kernels a
    contact step; a trace that lost records is taken again, up to twice.
    Returns the launches a step, a contact and a ballistic step as that
    trace counted them, device us and idle share."""
    from avbd3d_tpu_torch import solver, solver_cuda
    from avbd3d_tpu_torch.utils import profile_phases

    plan = solver_cuda.sweep_plan(w.bodies.n, w.contacts.other.shape[0])
    per_contact = solver_cuda.step_kernel_count(plan, p.iterations + int(p.post_stabilize))
    reset_counts()
    r = profile_phases.trace(w, p, cap, steps)
    c = {k: v // 2 for k, v in read_counts().items()}   # the untraced and the traced block
    gates, contact, ballistic = c["step_gates"], c["step_kernel"], c["ballistic_step"]
    refresh = c["candidate_lists"]
    other = {kernel_name(name)[:60]: n for name, _us, n in r["kernels"]
             if not own_kernel(name) and not name.startswith(("Memcpy", "Memset"))}
    if not (gates == steps and contact + ballistic == steps and c["control_lanes"] == ballistic
            and (ballistic > 0) == want_ballistic and not other and not c["bp_probe"]):
        fail(f"{label}: counters {c}, torch's {other}; expected the gates {steps}, a contact or "
             "a ballistic step each step, K2 a ballistic step, no K7 and no torch kernel")
    want = {"k_step_gates": gates, "k_ballistic_step": ballistic, "k_control_lanes": ballistic,
            "k_bp_tables": refresh, "k_bp_lists": refresh}
    for attempt in range(3):
        got = collections.Counter(block_kernels(w, p, cap, steps))
        k1 = sum(n for name, n in got.items() if name not in want)
        ok = {k: got[k] for k in want} == want and k1 == per_contact * contact
        if ok or attempt == 2:
            break
        print(f"{label}: the trace lost records ({dict(got)}); tracing again")
    if not ok:
        fail(f"{label}: the trace shows {dict(got)} (K1's {k1}); the counters give {want} and "
             f"K1's {per_contact} kernels in each of {contact} contact steps")
    traced = sum(got.values())
    per_gates = got["k_step_gates"] / steps
    per_contact_step = per_gates + k1 / contact if contact else None
    per_ballistic_step = (per_gates + (got["k_ballistic_step"] + got["k_control_lanes"])
                          / ballistic) if ballistic else None
    each = {k: "-" if v is None else f"{v:.2f}" for k, v in (("contact", per_contact_step),
                                                            ("ballistic", per_ballistic_step))}
    print(f"[{card}] {label}, traced ({steps} steps): {traced / steps:.2f} launches a step "
          f"({contact} contact steps: {each['contact']} each; {ballistic} ballistic: "
          f"{each['ballistic']} each; {refresh} refreshes: the 2 refresh kernels each), "
          f"{r['launches'] / steps:.2f} in the timed trace, torch's {other}; device "
          f"{r['device_us'] / steps:.1f} us a step, idle share "
          f"{100.0 * (1.0 - r['busy']):.1f}%, {r['wall_s'] * 1e3 / steps:.3f} ms a step traced, "
          f"{r['untraced_s'] * 1e3 / steps:.3f} untraced")
    return {"launches_per_step": traced / steps, "by_kernel": dict(got),
            "contact_steps": contact, "ballistic_steps": ballistic, "refresh_steps": refresh,
            "launches_per_contact_step": per_contact_step,
            "launches_per_ballistic_step": per_ballistic_step,
            "device_us_per_step": r["device_us"] / steps, "idle_share": 1.0 - r["busy"],
            "ms_per_step": r["wall_s"] * 1e3 / steps,
            "untraced_ms_per_step": r["untraced_s"] * 1e3 / steps, "torch": other}


# k_launch_floor's cases (kernels.launch_floor's ``loads``), each at
# k_step_gates' grid and block.
FLOOR_CASES = {"empty": 0, "a load and a store a thread": 1,
               "the gates' three loads before a store": 3}


def launch_floors(card, w, freeze_y: float) -> dict:
    """k_launch_floor timed as ``one_kernel_times`` times a kernel, at
    k_step_gates' grid and block for the world ``w``'s bodies, in each of
    FLOOR_CASES: {case: the kernel's own us a call}."""
    import torch

    from avbd3d_tpu_torch import kernels

    b = w.bodies
    src = torch.arange(7 * b.n, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    out = {}
    for label, loads in FLOOR_CASES.items():
        t = one_kernel_times(card, f"k_launch_floor ({label})", "k_launch_floor",
                             lambda loads=loads: kernels.launch_floor(b, src, dst, loads,
                                                                      freeze_y),
                             lambda: None)
        out[label] = t["device_us"]
    return out


def fused_phase(card, scene, saved, jointed) -> dict:
    """Phase 21: the fused path's stage kernels and K1's new tail against
    their plain versions at Stress1000 steps 0, 1 (its next step ballistic)
    and 700, step 700 with three bodies below fall_freeze_y, with NaN / inf
    velocities and a spin above the clamp, with a NaN pose, with a body
    whose inertial position overflows, with every body static, and RodJointed at step 600 (K1's joint branch); each kernel's
    time beside its plain version's and its bound; the traced launches of
    settled steps and of the falling window."""
    from avbd3d_tpu_torch import kernels, solver

    p, cap = scene.params, scene.cap
    settled = saved["settled"]
    rain = solver.step(scene.world, p, cap)
    nxt = solver.step(rain, p, cap)
    if not solver.step.last_gates["ballistic"]:
        fail(f"Stress1000 step 2 is not ballistic: {solver.step.last_gates}")
    rod_scene, rod_world = jointed["rod"]
    states = {"Stress1000 step 0": (scene.world, p, cap),
              "Stress1000 step 1 (its next step ballistic)": (rain, p, cap),
              "Stress1000 step 700": (settled, p, cap),
              "Stress1000 step 700, three bodies fallen": (
                  fused_world(settled, p, "fallen"), p, cap),
              "Stress1000 step 700, NaN / inf velocities and a spin above the clamp": (
                  fused_world(settled, p, "nan"), p, cap),
              "Stress1000 step 700, a NaN pos.y": (fused_world(settled, p, "nan pose"), p, cap),
              "Stress1000 step 700, a NaN pos.x": (fused_world(settled, p, "nan pose x"), p,
                                                   cap),
              "Stress1000 step 700, a body at pos.x 3.4e38 moving at 3e38": (
                  fused_world(settled, p, "overflow"), p, cap),
              "Stress1000 step 700, every body static": (unmoved_world(settled), p, cap),
              "RodJointed step 600 (K1's joint branch)": (rod_world, rod_scene.params,
                                                          rod_scene.cap)}
    out = {label: compare_fused(label, *args) for label, args in states.items()}
    if out["Stress1000 step 700, three bodies fallen"]["frozen"] != 3:
        fail("fused stages: the fallen state did not freeze three bodies")
    if out["Stress1000 step 700, NaN / inf velocities and a spin above the clamp"][
            "sanitized"] < 2:
        fail("fused stages: the non-finite velocities were not sanitized")
    for label in ("Stress1000 step 700, a NaN pos.y",
                  "Stress1000 step 700, a body at pos.x 3.4e38 moving at 3e38"):
        if out[label]["sanitized"] < 2:
            fail(f"fused stages, {label}: the ballistic step sanitized "
                 f"{out[label]['sanitized']} rows, not the warm start's and the velocity's")
    wp, b, _p = out["Stress1000 step 1 (its next step ballistic)"]["args"]
    bounds = fused_bounds(settled, wp, b, p)
    print(f"k_ballistic_step's bound at Stress1000 step 1: {bounds['live_contacts']} live "
          f"contacts of {4 * wp.contacts.other.numel()} slots' (their normal duals read)")
    times = {}
    calls = {"step_gates": (lambda: solver.step_gates(settled, p),
                            lambda: solver.step_gates_plain(settled, p),
                            "settled Stress1000, N = 1024"),
             "ballistic_step": (lambda: kernels.launch_ballistic_step(b, wp.contacts, p),
                                lambda: solver._ballistic_body(wp, p),
                                "Stress1000 step 1, N = 1024, DC = 12")}
    for name, (call, plain, where) in calls.items():
        t = one_kernel_times(card, f"{FUSED_KERNELS[name]} ({where})", FUSED_KERNELS[name],
                             call, plain)
        t["plain_launches"], t["plain_device_us"] = device_launches(plain, 2)
        t["bound_ms"], t["bound_by"] = bounds[name]
        if name == "ballistic_step":
            t["live_contacts"] = bounds["live_contacts"]
        if name == "step_gates":
            t["floor"] = launch_floors(card, settled, p.fall_freeze_y)
        print(f"[{card}] {name}: kernel {t['ms']:.4f} ms a call ({t['device_us']:.2f} us on the "
              f"card), plain {t['plain_ms']:.4f} ms ({t['plain_launches']:.0f} launches, "
              f"{t['plain_device_us']:.1f} us on the card); bound {t['bound_ms'] * 1e3:.3f} us "
              f"({t['bound_by']})")
        times[name] = t
    step_ms = event_ms(lambda: solver.ballistic_step(wp, p), 100)
    step_launches, step_us = device_launches(lambda: solver.ballistic_step(wp, p), 20)
    plain_step_launches, plain_step_us = device_launches(lambda: solver._ballistic_step(wp, p), 2)
    print(f"[{card}] the ballistic step with K2 (out=): {step_ms:.4f} ms a call, {step_launches:g} "
          f"launches, {step_us:.2f} us on the card; its plain version {plain_step_launches:g} "
          f"launches, {plain_step_us:.1f} us on the card")
    settled_trace = fused_step_trace(card, "settled Stress1000 (steps 701-720)", settled, p, cap,
                                     20, False)
    falling_trace = fused_step_trace(card, f"falling Stress1000 (steps 1-{FALLING_TRACE_STEPS})",
                                     scene.world, p, cap, FALLING_TRACE_STEPS, True)
    return {"states": {k: {f: v[f] for f in ("speed_err", "ctrl_err", "k1_differ", "frozen",
                                             "sanitized")}
                       for k, v in out.items()},
            "speed_err": max(v["speed_err"] for v in out.values()),
            "ctrl_err": max(v["ctrl_err"] for v in out.values()), "times": times,
            "ballistic_step": {"ms": step_ms, "launches": step_launches, "device_us": step_us,
                               "plain_launches": plain_step_launches,
                               "plain_device_us": plain_step_us},
            "settled_trace": settled_trace, "falling_trace": falling_trace,
            "race": {"Stress1000 step 1": (wp, p), "Stress1000 step 700": (settled, p)}}


# ---------------------------------------------------------------------------
# The sweep kernels' record (phase 13)
# ---------------------------------------------------------------------------

# The kernels whose ptxas usage the record prints: the tiled sweep kernels,
# the two collide kernels of K1, K3 and K5, K7's, K2's, the refresh's and
# the stage kernels of the grid step and of the fused path.
RECORD_KERNELS = ("k_sweeps", "k_primal", "k_joint_sweeps", "k_filter_cull", "k_collide",
                  "k_probe", "k_control_lanes", "k_bp_tables", "k_bp_lists", "k_refresh_needed",
                  "k_grid_gates", "k_grid_predict", "k_grid_finalize", "k_step_gates",
                  "k_ballistic_step")

# The last recorded times of these calls (this script's own event times, as
# PERF.md section 6 records them from one H100 80GB HBM3 at 700 W); printed
# beside this run's where no archive of the parent commit is at hand.
PARENT_RECORDED = {"k1_settled_ms": 0.823, "k1_sheets_ms": 0.910, "k4_ms": {"20": 0.760},
                   "k6_ms": 0.210}
# K2's and K7's parent (one block of 1024 threads; two kernels) as
# utils/time_sweeps.py traced them before their redesign, as PERF.md section
# 6 records it: CUDA-event ms a call and the kernels' own us a call.
PARENT_TRACED = {"K2, Stress1000 initial": {"ms": 0.0700, "device_us": 29.88},
                 "K2, Stress1000 settled": {"ms": 0.0898, "device_us": 32.22},
                 "K2, Stress2048 initial": {"ms": 0.1047, "device_us": 54.52},
                 "K7, Stress1000 settled": {"ms": 0.0911, "device_us": 19.42},
                 "K7, Stress4096 settled": {"ms": 0.0726, "device_us": 23.58}}
PARENT_DIR = os.path.join("_archive", "parent")

# (scene, N, DC, logical block, DJ, DS, sweeps of its usual step)
SWEEP_SCENES = (("Stress1000", 1024, 12, None, 0, 0, 20),
                ("7^3 pile", 384, 12, None, 0, 0, 20),
                ("Stress2048", 2048, 12, None, 0, 0, 20),
                ("RodJointed", 128, 16, None, 2, 0, 20),
                ("SoftGrid", 128, 16, None, 4, 0, 20),
                ("20 sheets", 2048, 32, None, 4, 0, 20),
                ("Stack", 128, 16, None, 0, 0, 10))


def time_sweeps(root: str, routes: bool = False) -> dict:
    """utils/time_sweeps.py on the tree ``root``, as a process of its own."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, os.path.join(here, "avbd3d_tpu_torch", "utils", "time_sweeps.py"),
           "--root", root] + (["--routes"] if routes else [])
    run = subprocess.run(cmd, cwd=here, capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        fail(f"time_sweeps on {root} exited {run.returncode}: {run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def sweep_record(card, lib, smoke_times) -> dict:
    """Routes and kernels per step by scene, ptxas usage of the tiled
    kernels, and parent-vs-change times of K1, K4 and K6.  ``smoke_times``:
    this run's own event times, printed beside the recorded parent where no
    parent tree is at hand."""
    from avbd3d_tpu_torch import kernels, solver_cuda

    if not lib.log:
        # A library built before build logs were kept beside it: build it
        # again here, for its log.
        print(f"{os.path.basename(lib.path)} was found built with no log beside it; "
              "rebuilding it for its ptxas log")
        lib = kernels.build(force=True)
    usage = {k: v for k, v in kernels.ptxas_usage(lib.log).items()
             if k.split("<")[0] in RECORD_KERNELS}
    if {k.split("<")[0] for k in usage} != set(RECORD_KERNELS):
        fail(f"the build log names no ptxas usage for some of {RECORD_KERNELS}: {sorted(usage)}")
    for name, u in sorted(usage.items()):
        print(f"ptxas {name}: {u['registers']} registers, {u['spill_bytes']} spill bytes")
    for name, n, dc, blk, dj, ds, its in SWEEP_SCENES:
        plan = solver_cuda.sweep_plan(n, dc, blk, dj, ds)
        print(f"sweep plan {name} (N = {n}, DC = {dc}): route {plan.route}, tile {plan.tile}, "
              f"{plan.threads} threads, {plan.smem_bytes} B shared, cluster {plan.cluster}; "
              f"{solver_cuda.step_kernel_count(plan, its, dj, ds)} kernels per K1 "
              f"step of {its} sweeps")
    plan6 = solver_cuda.sweep_plan(5120, 16, 1024)
    print(f"sweep plan Stress4096 (N = 5120, DC = 16, logical blocks of 1024): route "
          f"{plan6.route}, tile {plan6.tile}, {plan6.threads} threads, {plan6.smem_bytes} B "
          f"shared, cluster {plan6.cluster}; {solver_cuda.iterblock_kernel_count(plan6, 4)} "
          f"kernel per K6 launch of 4 iterations, 3 + 5 x that per grid step")

    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.join(here, PARENT_DIR)
    rows = (("K1 contact-only, settled Stress1000", lambda t: t["k1_settled_ms"]),
            ("K1 joint branch, 20 sheets", lambda t: t["k1_sheets_ms"]),
            ("K4, 20 iterations", lambda t: t["k4_ms"]["20"]),
            ("K6, one launch of 4 iterations", lambda t: t["k6_ms"]))
    if os.path.isdir(os.path.join(parent, "avbd3d_tpu_torch")):
        # parent, change, change, parent, each a process of its own.
        runs = [time_sweeps(parent), time_sweeps(here, routes=True), time_sweeps(here),
                time_sweeps(parent)]
        rows += (("K1 contact-only, settled Stress2048", lambda t: t["k1_2048_ms"]),
                 ("K4, 5 iterations", lambda t: t["k4_ms"]["5"]),
                 ("K4, 1 iteration", lambda t: t["k4_ms"]["1"]))
        for label, get in rows:
            print(f"[{card}] {label}: parent {get(runs[0]):.4f} / {get(runs[3]):.4f} ms, "
                  f"change {get(runs[1]):.4f} / {get(runs[2]):.4f} ms (one run, in turns)")
        # The same calls as CUDA-event time and as the kernels' own time in a
        # trace, with the kernels by name (time_sweeps' ``traced``).
        for label in runs[1]["traced"]:
            t = [r["traced"].get(label) for r in runs]
            if None in t:
                continue
            print(f"[{card}] {label}: parent {t[0]['ms']:.4f} / {t[3]['ms']:.4f} ms, "
                  f"{t[0]['device_us']:.1f} / {t[3]['device_us']:.1f} us on the card; change "
                  f"{t[1]['ms']:.4f} / {t[2]['ms']:.4f} ms, {t[1]['device_us']:.1f} / "
                  f"{t[2]['device_us']:.1f} us on the card (one run, in turns)")
            for who, r in (("parent", t[0]), ("change", t[1])):
                print(f"    {who} kernels, us and launches a call: " + ", ".join(
                    f"{k} {us:.1f} x{r['launches'][k]:g}" for k, us in r["kernels"].items())
                    + (f"; every kernel of the trace: {r['all_us']:.1f} us, "
                       f"{r['all_launches']:g} launches" if "all_us" in r else ""))
        for who, r in (("parent", runs[0]), ("change", runs[1])):
            print(f"[{card}] K2's lanes whose bits differ from the plain version ({who}): "
                  + json.dumps(r.get("k2_lanes_differ")))
        for key, r in runs[1]["routes"].items():
            print(f"[{card}] routes, {key}: " + json.dumps(r))
        return {"usage": usage, "ab": runs}
    for label, get in rows:
        print(f"[{card}] {label}: change {get(smoke_times):.4f} ms; parent {get(PARENT_RECORDED):.3f} "
              f"ms as recorded in PERF.md (no tree of the parent commit in {PARENT_DIR})")
    return {"usage": usage, "ab": None}


# ---------------------------------------------------------------------------
# The race gate (phase 12): every resident route, repeated and delayed
# ---------------------------------------------------------------------------

RACE_REPS = 50
# The race build's delay: odd thread blocks of the resident kernels sleep
# this long before each read of other blocks' poses and each pose write
# (csrc/step_kernel.cu AVBD_RACE_DELAY), several times a sweep's own length
# on the small worlds, so that a missing barrier changes the bits; those of
# K7, K2 and the refresh kernels before they write their partials and before
# they take the ticket (csrc/bp_probe.cu, control_lanes.cu, bp_refresh.cu),
# several times the kernels' own length, so that a fold that does not wait
# for every block shows.
RACE_DELAY_NS = 20000


def race_routes(states: dict) -> list:
    """(label, kernel call) for every resident route: K1's cluster route at
    clusters of 4, 12 and 16 blocks, K6 with 5 clusters, and K1's joint
    route at RodJointed, SoftGrid (one cluster each) and the 20 sheets (a
    cooperative launch), RodJointed also forced onto the grid barrier; and
    K7 and K2, whose blocks hand partials to the last one, the refresh and
    the stage kernels.  ``states``: this run's worlds and operands ("probe",
    "lanes" and "fused": {label: (world, params)} for K7, K2 and the fused
    path's stage kernels)."""
    import dataclasses

    from avbd3d_tpu_torch import kernels, load_scene, solver, solver_cuda, solver_grid
    from avbd3d_tpu_torch.ops import broadphase

    routes = []

    def k1(label, args, plan=None):
        want = solver_cuda.sweep_plan(args[4].n, args[0].other.shape[0], None,
                                      args[11].dj if args[11] is not None else 0,
                                      args[12].ds if args[12] is not None else 0)
        plan = plan or want
        old, rest = args[0], args[1:]

        def call():
            new, body, diag, rows = kernels.launch_step(solver_cuda.cache_leaves(old), *rest,
                                                        plan=plan)
            return [*new, *body, diag] + [r for r in rows if r is not None]
        routes.append((f"K1 {label} ({plan.route}, {plan.cluster or args[4].n // plan.tile} "
                       f"blocks of {plan.tile} bodies)", call))

    sc = load_scene("Stack", device="cuda")
    k1("Stack step 60", k1_inputs(solver.run_steps(sc.world, sc.params, sc.cap, 60), sc))
    k1("7^3 pile step 200", states["pile"])
    a1 = states["Stress1000 settled"]
    threads, spt, smem = solver_cuda._tile_shape(64, 12)
    k1("Stress1000 settled, 64-body tiles", a1, solver_cuda.SweepPlan(64, threads, spt, smem, 16))
    a6 = states["k6"]
    routes.append((f"K6 Stress4096 settled ({a6[4].n // (a6[1] * 128)} clusters)",
                   lambda: list(solver_grid.iterblock_grid(*a6))))
    for name in ("RodJointed step 30", "SoftGrid step 5", "20 sheets step 100"):
        k1(name, states[name])
    rod = states["RodJointed step 30"]
    plan = solver_cuda.sweep_plan(rod[4].n, rod[0].other.shape[0], None, rod[11].dj)
    k1("RodJointed step 30, forced", rod, dataclasses.replace(plan, cluster=0, grid=1))
    # K7 and K2: one launch each, whose last block folds every block's
    # partials after a ticket.
    for label, (w, p) in states["probe"].items():
        routes.append((f"K7 {label} (the last block folds)",
                       lambda w=w, p=p: list(solver_cuda.bp_probe(w.bp.nb, w.bodies, p))))
    for label, (w, p) in states["lanes"].items():
        routes.append((f"K2 {label} (the last block folds and runs the deviation pass)",
                       lambda w=w, p=p: [solver_cuda.control_lanes(w.bp.nb, w.bodies, w.bp.anchor,
                                                                   w.bp.anchor_quat, p)]))
    # The refresh kernels (a ticket fold each) and the predicate (K2's fold).
    for label, (w, degree, p) in states["refresh"].items():
        b = w.bodies
        routes.append((f"refresh lists {label} (k_bp_tables and k_bp_lists: the last block folds)",
                       lambda b=b, w=w, degree=degree, p=p: list(broadphase._lists_on_card(
                           b.pos, b.quat, b.size, 0.5, b.radius, b.inv_mass, w.exclusions,
                           degree, p.bp_margin))))
        routes.append((f"refresh predicate {label} (the last block folds and runs the deviation "
                       "pass)", lambda b=b, w=w, p=p: list(kernels.launch_refresh_needed(
                           b, w.bp.anchor, w.bp.anchor_quat, w.bp.slack, p.bp_margin))))
    # k_bp_lists with 32 rows a block (the 16384-body pile's choice), and
    # rows past the per-row buffer (its cut), whole and split over 4 warps
    # (the merge).
    w, degree, p = states["refresh"]["Stress4096 settled"]
    b = w.bodies
    table, max_wh = kernels.launch_bp_tables(b.pos, b.quat, b.size, 0.5, b.radius, b.inv_mass)
    for margin, rpb in ((p.bp_margin, 32), (2.5, 16), (2.5, 2)):
        routes.append((f"refresh lists Stress4096 settled, margin {margin:g}, {rpb} rows a block "
                       "(k_bp_lists: the last block folds)",
                       lambda margin=margin, rpb=rpb, table=table, max_wh=max_wh,
                       ex=w.exclusions, degree=degree: list(kernels.launch_bp_lists(
                           table, table, max_wh, ex, degree, margin, rows_per_block=rpb))))
    # The grid step's stage kernels: the gates' ticket fold (after its grid
    # barrier and the deviation pass), the prediction's and the finalize's
    # atomic folds.
    for label, a in states["stages"].items():
        world, p = a["gates"]
        b = world.bodies
        routes.append((f"k_grid_gates {label} (a grid barrier, every block folds the partials, "
                       "the last block folds the blocks' deviations)", lambda b=b, w=world, p=p: list(kernels.launch_grid_gates(
                           b, w.bp.anchor, w.bp.anchor_quat, w.bp.slack, p))))
        routes.append((f"k_grid_predict {label} (the count and the ticket in one 64-bit "
                       "atomic, the last block clears it)",
                       lambda a=a: list(kernels.launch_grid_predict(*a["predict"]))))
        fin = a["finalize"]
        routes.append((f"k_grid_finalize {label} (the lanes by atomics into ten words, the "
                       "last block reads and clears them)",
                       lambda f=fin: list(kernels.launch_grid_finalize(
                           f[1], *f[3:8], f[2], *f[8:]))))
    # The fused path's stage kernels: the ballistic step's atomic fold, and
    # the gates (no fold; a thread a float).
    for label, (w, p) in states["fused"].items():
        routes.append((f"k_ballistic_step {label} (the lanes by atomics into seven words, "
                       "the last block reads and clears them)",
                       lambda w=w, p=p: list(kernels.launch_ballistic_step(w.bodies, w.contacts,
                                                                           p))))
        b, bp = w.bodies, w.bp
        routes.append((f"k_step_gates {label}", lambda b=b, w=w, bp=bp, p=p: list(
            kernels.launch_step_gates(b, w.diagnostics.vec, bp.slack, bp.dropped, p))))
    return routes


def tickets_zero(label: str) -> None:
    """Every kernel's ticket (the counter by which its last block finds
    itself, held in ``kernels._SCRATCH``) and the atomic folds' words
    (``*_fold_ticket``) 0 after the launches."""
    from avbd3d_tpu_torch import kernels

    left = {k[2]: int(t.count_nonzero()) for k, t in kernels._SCRATCH.items() if "ticket" in k[2]}
    if any(left.values()):
        fail(f"race gate, {label}: tickets not 0 after the launches: {left}")


def race_phase(card, states: dict) -> dict:
    """Each resident route RACE_REPS times on one input, every output
    bit-identical each time; then the same calls through a build whose odd
    blocks sleep before pose reads and writes, bit-identical again; then
    compute-sanitizer's racecheck and synccheck (sanitizer_checks)."""
    from avbd3d_tpu_torch import kernels

    routes = race_routes(states)
    firsts = []
    for label, call in routes:
        first = call()
        differ = 0
        for _ in range(RACE_REPS):
            differ += sum(not same_bits(a, b) for a, b in zip(first, call()))
        sync()
        if differ:
            fail(f"race gate, {label}: {differ} outputs changed over {RACE_REPS} repetitions")
        tickets_zero(label)
        firsts.append(first)
        print(f"race gate, {label}: {RACE_REPS} repetitions bit-identical ({len(first)} outputs)")
    lib = kernels.build(defines=(f"AVBD_RACE_DELAY={RACE_DELAY_NS}",))
    print(f"race build ({RACE_DELAY_NS} ns delays in odd blocks) in {lib.build_seconds:.1f} s")
    with kernels.using(lib):
        for (label, call), first in zip(routes, firsts):
            got = call()
            sync()
            bad = [k for k, (a, b) in enumerate(zip(first, got)) if not same_bits(a, b)]
            if bad:
                fail(f"race gate, {label}: the delayed build differs in outputs {bad}")
            tickets_zero(label)
            print(f"race gate, {label}: delayed build bit-identical")
    return {"routes": len(routes), "sanitizer": sanitizer_checks()}


SANITIZE_SCRIPT = """
import dataclasses, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
from avbd3d_tpu_torch import kernels, load_scene, solver, solver_cuda
target = sys.argv[1]
sc = load_scene("Stack" if "Stack" in target else "RodJointed", device="cuda")
w = solver.run_steps(sc.world, sc.params, sc.cap, 3)
a = cs.k1_inputs(w, sc)
if target.startswith("K3"):
    solver_cuda.collide_and_init(*a[:5], a[7])
elif "grid" in target:
    plan = solver_cuda.sweep_plan(a[4].n, a[0].other.shape[0], None, a[11].dj)
    kernels.launch_step(solver_cuda.cache_leaves(a[0]), *a[1:],
                        plan=dataclasses.replace(plan, cluster=0, grid=1))
else:
    solver_cuda.step_kernel(*a)
torch.cuda.synchronize()
"""

# (target, the kernels compute-sanitizer instruments): the collide kernels
# on their own (a plain launch, the tool's control), then each resident
# kernel on a small world, on the cluster and on the grid barrier.
SANITIZE_TARGETS = (("K3 Stack", "k_filter_cull|k_collide"), ("K1 Stack", "k_sweeps"),
                    ("K1 RodJointed", "k_joint_sweeps"),
                    ("K1 RodJointed, grid barrier", "k_joint_sweeps"))


def sanitizer_checks() -> dict:
    """compute-sanitizer's racecheck (shared-memory hazards) and synccheck
    (barrier use) on SANITIZE_TARGETS, only the named kernels instrumented.
    A hazard or barrier error it reports fails the run.  Where the tool is
    missing, or the program under it cannot use the card (the tool does not
    run on every machine), that is printed with the tool's first error and
    no verdict is claimed."""
    import shutil

    from avbd3d_tpu_torch import kernels

    tool = shutil.which("compute-sanitizer")
    if tool is None:
        try:
            cand = os.path.join(os.path.dirname(kernels._nvcc()), "compute-sanitizer")
        except RuntimeError:
            cand = ""
        tool = cand if os.path.exists(cand) else None
    if tool is None:
        print("compute-sanitizer: skipped, not on PATH nor beside nvcc")
        return {"skipped": "not found"}
    here = os.path.dirname(os.path.abspath(__file__))
    verdicts = {}
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "sanitize_one.py")
        with open(script, "w") as f:
            f.write(SANITIZE_SCRIPT.format(root=here))
        for check in ("racecheck", "synccheck"):
            for target, names in SANITIZE_TARGETS:
                key = f"{check}, {target}"
                try:
                    run = subprocess.run([tool, "--tool", check, "--kernel-regex", f"kns={names}",
                                          sys.executable, script, target], cwd=here,
                                         capture_output=True, text=True, timeout=240)
                except subprocess.TimeoutExpired:
                    verdicts[key] = "timed out after 240 s: no verdict"
                    print(f"compute-sanitizer {key}: {verdicts[key]}")
                    continue
                lines = (run.stdout + run.stderr).splitlines()
                own = [ln.strip("= ").strip() for ln in lines if ln.startswith("=========")]
                found = [ln for ln in own if "SUMMARY" not in ln and (
                    "hazard" in ln.lower() or "race" in ln.lower() or "barrier" in ln.lower())]
                summary = [ln for ln in own if "SUMMARY" in ln]
                errors = [ln for ln in own if ln.startswith(("Error", "Program hit", "Invalid"))]
                if found:
                    fail(f"compute-sanitizer {key}: {found[:5]}")
                if run.returncode != 0:
                    # The program under the tool failed to use the card.
                    verdicts[key] = (f"could not run here (exit {run.returncode}): "
                                     + " | ".join((errors or own or lines)[:1] + summary[-1:]))
                elif summary and any(int(w) for ln in summary for w in ln.split() if w.isdigit()):
                    fail(f"compute-sanitizer {key}: {summary}")
                else:
                    verdicts[key] = summary[-1] if summary else "exit 0, no summary"
                print(f"compute-sanitizer {key}: {verdicts[key]}")
    return verdicts


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a call's work (the larger
# of its bytes over 3.35 TB/s and its float operations over 67 TFLOP/s, the
# H100 SXM's published fp32 rate outside the tensor cores).  Operation counts
# per unit are the float operations of the kernel source's statements,
# rounded down, times the units this call's data needs (occupied slots, not
# capacity).
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_SAT_PAIR = 2600          # filter, precull, 15-axis SAT, manifold, match, init
OPS_CONTACT_SLOT_SWEEP = 1000  # rows, force, Hessian share, geometry, dual
OPS_BODY_SWEEP = 350         # world inertia, solve66, pose update
OPS_BODY_STEP = 200          # prediction, velocities, sanitize, diagnostics
OPS_JOINT_SLOT_PASS = 180    # joint geometry, force, accumulate
OPS_JOINT_SLOT_DUAL = 150
OPS_SPRING_SLOT_PASS = 150
OPS_CTRL_SLOT = 40           # K2: world halves, gap, reach per candidate slot
OPS_PROBE_SLOT = 300         # K7: partner axes, six SAT axes, travel, reach


def nbytes(*ts) -> int:
    import torch

    total = 0
    for t in ts:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif hasattr(t, "__dataclass_fields__"):
            total += nbytes(*[getattr(t, f) for f in t.__dataclass_fields__])
    return total


def bound(n_bytes: float, ops: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_bound(args, outs) -> tuple:
    """K1 on ``args`` (k1_inputs): read once, written once; SAT per kept
    directed slot, sweeps over occupied cache slots, bodies and row slots."""
    old, nb, key, thr, b, anchor, anchor_q, p, n_main, _k, cand, j, sp, n_colors = args
    contacts, body_out, diag, rows = outs
    n, iters = b.n, n_main + (1 if p.post_stabilize else 0)
    slots = int((contacts.other >= 0).sum())
    ops = (float(diag[0, 9]) * OPS_SAT_PAIR + iters * (slots * OPS_CONTACT_SLOT_SWEEP
                                                       + n * OPS_BODY_SWEEP) + n * OPS_BODY_STEP)
    if j is not None:
        jslots = int((j.other >= 0).sum())
        ops += iters * jslots * (n_colors * OPS_JOINT_SLOT_PASS + OPS_JOINT_SLOT_DUAL)
    if sp is not None:
        ops += iters * int((sp.other >= 0).sum()) * OPS_SPRING_SLOT_PASS
    body_in = [getattr(b, f) for f in ("pos", "quat", "size", "radius", "linvel", "angvel",
                                       "prev_linvel", "mass", "inv_mass", "friction", "inertia",
                                       "inv_inertia")]
    rows_in = []
    if j is not None:
        rows_in += [getattr(j, f) for f in ("other", "world", "side", "anchor_a", "anchor_b",
                                            "rest", "stiff_lin", "stiff_ang", "rmotor", "lam",
                                            "penalty", "color")]
    if sp is not None:
        rows_in += [getattr(sp, f) for f in ("other", "world", "side", "anchor_a", "anchor_b",
                                             "rrest", "rstiff", "penalty")]
    return bound(nbytes(old, nb, key, thr, cand, body_in, anchor, anchor_q, rows_in, contacts,
                        body_out, diag, [r for r in rows if r is not None]), ops)


def sweep_extra(plan, sweeps: dict, rows: bool = False) -> dict:
    """The sweep route of a kernel entry and the ptxas usage of the tiled
    kernel it runs (the instance compiled for the plan's block size; with
    joint or spring rows the resident joint kernel with the plan's
    barrier)."""
    if rows:
        name = (f"k_joint_sweeps<{512 if plan.threads <= 512 else 1024}, "
                f"{'true' if plan.cluster else 'false'}>")
    else:
        kernel = "k_sweeps" if plan.cluster else "k_primal"
        ceiling = min(int(k.split("<")[1][:-1]) for k in sweeps["usage"]
                      if k.startswith(kernel + "<") and int(k.split("<")[1][:-1]) >= plan.threads)
        name = f"{kernel}<{ceiling}>"
    u = sweeps["usage"][name]
    return {"sweep_route": plan.route, "sweep_kernel": name,
            "registers": u["registers"], "spill_bytes": u["spill_bytes"]}


def collide_extra(sweeps: dict) -> dict:
    """The collide's kernels (K1's collide half, K3, K5: k_filter_cull and
    k_collide) with their ptxas usage; ``registers`` /
    ``spill_bytes`` are the largest of them."""
    usage = {k: u for k, u in sweeps["usage"].items()
             if k.split("<")[0] in ("k_filter_cull", "k_collide")}
    return {"collide_kernels": usage, "registers": max(u["registers"] for u in usage.values()),
            "spill_bytes": max(u["spill_bytes"] for u in usage.values())}


def parent_traced(sweeps: dict, label: str) -> dict | None:
    """The parent tree's CUDA-event ms and kernels' own us a call of
    time_sweeps' traced ``label`` from this run's two parent runs, or None
    where no archive of the parent commit is at hand (the recorded
    PARENT_TRACED values are then printed as text only, never in the
    ``kernels`` line)."""
    if sweeps["ab"] is None:
        return None
    runs = sweeps["ab"]
    return {"ms": [runs[k]["traced"][label]["ms"] for k in (0, 3)],
            "device_us": [runs[k]["traced"][label]["device_us"] for k in (0, 3)],
            "origin": f"this run, {PARENT_DIR}"}


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bnd, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None, **extra}


class Watch:
    """Per-step envelope of a run, accumulated on the card (no sync): the
    lane-wise max of the diagnostics over all steps and over a held window,
    and whether every pose stayed finite."""

    def __init__(self, hold_from: int):
        import torch

        self.hold_from = hold_from
        self.worst = torch.zeros(16, device="cuda")
        self.held = torch.zeros(16, device="cuda")
        self.finite = torch.ones((), dtype=torch.bool, device="cuda")

    def add(self, i: int, w):
        import torch

        v = w.diagnostics.vec
        self.worst = torch.maximum(self.worst, v)
        if i >= self.hold_from:
            self.held = torch.maximum(self.held, v)
        b = w.bodies
        self.finite &= torch.isfinite(b.pos).all() & torch.isfinite(b.quat).all()

    def check(self, label: str, n_steps: int):
        worst, held = self.worst.tolist(), self.held.tolist()
        if not bool(self.finite):
            fail(f"{label}: non-finite poses")
        if worst[8] != 0.0:
            fail(f"{label}: sanitized {worst[8]}")
        if worst[9] + worst[10] != 0.0:
            fail(f"{label}: overflow: pair {worst[9]}, degree {worst[10]}")
        after = (f", {held[0]:.6f} over steps {self.hold_from + 1}-{n_steps}"
                 if self.hold_from < n_steps else "")
        print(f"{label}: max penetration {worst[0]:.6f} over steps 1-{n_steps} (landing "
              f"cascade){after}; sanitized 0, overflow 0, poses finite")
        if not held[0] < PEN_LIMIT:
            fail(f"{label}: max penetration {held[0]} >= {PEN_LIMIT} after the landing")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from avbd3d_tpu_torch import kernels, load_scene, solver, solver_cuda
    from avbd3d_tpu_torch.ops.broadphase import build_bp_cache

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ----
    lib = kernels.build()
    print(f"kernels built in {lib.build_seconds:.1f} s ({os.path.basename(lib.path)}; "
          f"{'its build log' if lib.log else 'no build log'} beside it)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill stores" in line:
            print("  ptxas:", line.split(":", 1)[-1].strip())

    # Warm-up (allocator, lazy module loads); its launches are not counted.
    warm = load_scene("Stress1000", device="cuda")
    solver.run_steps(warm.world, warm.params, warm.cap, 2)
    sync()

    # ---- 2. main path ----
    scene = load_scene("Stress1000", device="cuda")
    p, cap = scene.params, scene.cap
    w = scene.world
    if (w.bodies.n, cap.max_degree, cap.cache_degree, p.iterations) != (1024, 24, 12, 20):
        fail("Stress1000 is not the N=1024, D=24, DC=12, 20-iteration configuration")
    reset_counts()
    solver.step.host_reads = 0
    gates = {"ballistic": 0, "contact": 0, "refreshed": 0}
    pen_after_landing = torch.zeros((), device="cuda")
    worst = torch.zeros(16, device="cuda")
    saved = {}
    sync()
    t0 = time.perf_counter()
    t_fall = None
    for i in range(700):
        w = solver.step(w, p, cap)
        g = solver.step.last_gates
        gates["ballistic" if g["ballistic"] else "contact"] += 1
        gates["refreshed"] += int(g["refreshed"])
        worst = torch.maximum(worst, w.diagnostics.vec)
        if i >= 300:
            pen_after_landing = torch.maximum(pen_after_landing, w.diagnostics.vec[0])
        if i + 1 == 150:
            saved["landing"] = w
        if i + 1 == 300:
            sync()
            t_fall = time.perf_counter() - t0
    sync()
    t_main = time.perf_counter() - t0
    main_kernels = ("step_gates", "step_kernel", "ballistic_step", "control_lanes",
                    "candidate_lists")
    launches = {k: v for k, v in read_counts().items() if k in main_kernels}
    host_reads = solver.step.host_reads
    worst = worst.tolist()
    diag = w.diagnostics.as_dict()
    print(f"main path: 700 steps in {t_main:.2f} s; gates {gates}; launches {launches}; "
          f"host reads {host_reads}")
    if 0 in launches.values():
        fail(f"a kernel of the main path never launched: {launches}")
    if tuple(launches[k] for k in main_kernels) != (
            700, gates["contact"], gates["ballistic"], gates["ballistic"], gates["refreshed"]):
        fail(f"launch counts {launches} do not match the steps taken {gates}")
    if worst[8] != 0.0:
        fail(f"sanitized {worst[8]}")
    if worst[9] + worst[10] != 0.0:
        fail(f"overflow: pair {worst[9]}, degree {worst[10]}")
    pen_settled = float(pen_after_landing)
    print(f"max penetration: {worst[0]:.6f} over steps 1-700 (landing cascade), "
          f"{pen_settled:.6f} over steps 301-700")
    if not pen_settled < PEN_LIMIT:
        fail(f"max penetration {pen_settled} >= {PEN_LIMIT} after the landing")
    for name in ("pos", "quat", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(w.bodies, name)).all()):
            fail(f"non-finite {name}")
    print(f"step 700: manifolds {int(diag['active_manifolds'])}, contacts "
          f"{int(diag['active_contacts'])}, max_pen {diag['max_penetration']:.6f}, "
          f"max_lin {diag['max_linear_speed']:.4f}")
    saved["settled"] = w

    # ---- 3. kernel vs plain ----
    k1_err = max(compare_k1(k1_inputs(saved[k], scene), k) for k in ("landing", "settled"))
    k1_small_err, pile_args = small_cluster_worlds()
    init = scene.world
    init = init.replace(bp=build_bp_cache(init.bodies, init.exclusions, cap.max_degree,
                                          p.bp_margin))
    s2048 = load_scene("Stress2048", device="cuda")
    init2048 = s2048.world.replace(bp=build_bp_cache(
        s2048.world.bodies, s2048.world.exclusions, s2048.cap.max_degree, s2048.params.bp_margin))
    k2_states = {"Stress1000 initial": (init, p), "Stress1000 settled": (w, p),
                 "Stress2048 initial": (init2048, s2048.params),
                 "Stress1000 initial, every body static (nm = 0)": (unmoved_world(init), p),
                 "Stress1000 settled, a NaN pos.y (NaN lanes 2-4)": (nan_pose(w, 1), p)}
    k2_err = max(compare_k2(wd, pr, label) for label, (wd, pr) in k2_states.items())

    # ---- 4. times ----
    fall_sps = 300 / t_fall
    t0 = time.perf_counter()
    w_set = solver.run_steps(w, p, cap, 300)
    sync()
    settled_sps = 300 / (time.perf_counter() - t0)
    with plain_wrappers():
        solver.run_steps(w, p, cap, 1)
        sync()
        t0 = time.perf_counter()
        solver.run_steps(w, p, cap, 3)
        sync()
        plain_sps = 3 / (time.perf_counter() - t0)
    d_set = w_set.diagnostics.as_dict()
    print(f"[{card}] falling window (steps 0-300, kernels): {fall_sps:.1f} steps/s")
    print(f"[{card}] settled block (steps 700-1000, kernels): {settled_sps:.1f} steps/s "
          f"(step 1000: max_pen {d_set['max_penetration']:.6f}, "
          f"manifolds {int(d_set['active_manifolds'])}); {PRIOR_SETTLED}")
    print(f"[{card}] settled, plain PyTorch path (3 steps): {plain_sps:.2f} steps/s")

    a1 = k1_inputs(w, scene)
    k1_ms = event_ms(lambda: solver_cuda.step_kernel(*a1), 20)
    k1_plain_ms = event_ms(lambda: solver_cuda.step_kernel_plain(*a1), 3)
    print(f"[{card}] step kernel (settled, {a1[8]} iterations): {k1_ms:.3f} ms, "
          f"plain {k1_plain_ms:.3f} ms")
    k2_times = {}
    for label in ("Stress1000 settled", "Stress1000 initial", "Stress2048 initial"):
        wd, pr = k2_states[label]
        a2 = (wd.bp.nb, wd.bodies, wd.bp.anchor, wd.bp.anchor_quat, pr)
        k2_times[label] = one_kernel_times(
            card, f"control-lanes kernel (K2, {label})", "k_control_lanes",
            lambda: solver_cuda.control_lanes(*a2), lambda: solver_cuda.control_lanes_plain(*a2))
    k2_ms, k2_plain_ms = (k2_times["Stress1000 settled"][k] for k in ("ms", "plain_ms"))
    b, bp = w.bodies, w.bp

    grid = grid_phase(card)
    low_drop = low_drop_gate()
    w2048, p2048, k1_2048_err = stress2048_phase(card)
    jointed = jointed_phases(card)
    prof = profiler_phase(w, scene, card)
    wide = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, 40, p.bp_margin))
    ground = load_scene("Ground", device="cuda")
    if (jointed["state"].bp.nb.shape[0], wide.bp.nb.shape[0]) != (32, 40):
        fail(f"K7's caches: the sheets' D = {jointed['state'].bp.nb.shape[0]}, the wide "
             f"lists' D = {wide.bp.nb.shape[0]}; expected 32 and 40")
    probe = probe_phase(card, scene, {
        "Stress1000 landing": (saved["landing"], p), "Stress1000 settled": (w, p),
        "Stress2048 settled": (w2048, p2048),
        "Stress4096 settled": (grid["settled"], grid["params"]),
        "20 sheets step 100": (jointed["state"], jointed["scene"].params),
        "Stress1000 settled, fresh lists of 40 slots": (wide, p),
        "Ground, no slots": (ground.world, ground.params)})
    swept = swept_phase(card, saved["landing"], w, grid)
    refresh = refresh_phase_states(card, scene, saved, init, w2048, s2048, grid, jointed,
                                   swept["pile"])
    stages = stages_phase(card, grid, refresh["g2800"], low_drop)
    fused = fused_phase(card, scene, saved, jointed)
    traced = app_phase(card, scene, saved["landing"], w)
    portable = portable_phase(card, w)
    chains = chains_phase(card)
    batched = batched_phase(card, portable["landing"])
    race = race_phase(card, {"pile": pile_args, "Stress1000 settled": k1_inputs(w, scene),
                             "k6": grid["k6_args"], **jointed["states"],
                             "probe": {"Stress1000 settled": (w, p),
                                       "Stress4096 settled": (grid["settled"], grid["params"])},
                             "lanes": {k: k2_states[k] for k in ("Stress1000 settled",
                                                                 "Stress2048 initial")},
                             "refresh": {"Stress1000 settled": (w, cap.max_degree, p),
                                         "Stress4096 settled": (grid["settled"],
                                                                grid["scene"].cap.max_degree,
                                                                grid["params"])},
                             "stages": {"Stress4096 step 2800": stages["args"]},
                             "fused": fused["race"]})
    sweeps = sweep_record(card, lib, {"k1_settled_ms": k1_ms, "k1_sheets_ms": jointed["ms"],
                                      "k4_ms": {"20": prof["ms4"]}, "k6_ms": grid["k6_ms"]})
    bench = bench_phase(card)
    cells_phase(card)
    bench_note = "python -m avbd3d_tpu_torch.bench --quick, phase 18: every Stress1000 regime"

    for label, t in [*((f"K2, {k}", v) for k, v in k2_times.items()),
                     ("K7, Stress1000 settled", probe), ("K7, Stress4096 settled", probe["grid"])]:
        par = parent_traced(sweeps, label) or {**PARENT_TRACED[label],
                                               "origin": "as PERF.md section 6 records it"}
        print(f"[{card}] {label}: parent {par['ms']} ms a call, {par['device_us']} us on the card "
              f"({par['origin']}); change {t['ms']:.4f} ms, {t['device_us']:.2f} us on the card "
              f"in one kernel")

    k1_bnd = k1_bound(a1, solver_cuda.step_kernel(*a1))
    jb_bnd = k1_bound(jointed["args"], solver_cuda.step_kernel(*jointed["args"]))
    k2_bnd = bound(nbytes(bp.nb, [getattr(b, f) for f in ("pos", "quat", "size", "radius", "linvel",
                                                          "angvel", "inv_mass")],
                          bp.anchor, bp.anchor_quat) + 5 * 4,
                   int((bp.nb >= 0).sum()) * OPS_CTRL_SLOT)
    a3, a4 = prof["a3"], prof["a4"]
    out3 = solver_cuda.collide_and_init(*a3)
    k3_bnd = bound(nbytes(a3[:4], [getattr(a3[4], f) for f in ("pos", "quat", "size", "inv_mass")],
                          out3), float(out3[1]) * OPS_SAT_PAIR)
    out4 = solver_cuda.solve_loop(*a4)
    n4, it4 = a4[1].n, p.iterations + (1 if p.post_stabilize else 0)
    k4_bnd = bound(
        nbytes(a4[0], [getattr(a4[1], f) for f in ("pos", "quat", "linvel", "angvel",
                                                   "prev_linvel", "mass", "inv_mass", "friction",
                                                   "inertia", "inv_inertia")],
               [getattr(out4[0], f) for f in ("pos", "quat", "linvel", "angvel", "prev_linvel",
                                              "prev_angvel")], out4[1:]),
        it4 * (int((a4[0].other >= 0).sum()) * OPS_CONTACT_SLOT_SWEEP + n4 * OPS_BODY_SWEEP)
        + n4 * OPS_BODY_STEP)
    sync()
    csrc = "avbd3d_tpu_torch/csrc/"
    t4 = refresh["times"]["Stress4096 step 2800"]
    report = {"kernels": [
        kernel_entry("step_kernel", csrc + "step_kernel.cu", "avbd3d_tpu/solver_tpu.py:864",
                     launches["step_kernel"], max(k1_err, k1_small_err, k1_2048_err, jointed["err"]),
                     k1_ms, k1_plain_ms,
                     k1_bnd, **sweep_extra(solver_cuda.sweep_plan(1024, 12), sweeps),
                     cluster_route={
                         "note": "contact-only worlds up to 512 bodies: all sweeps in one "
                                 "cluster-resident launch; compared on Pyramid (N = 128, cluster "
                                 "of 4) and a 7^3 pile (N = 384, cluster of 12)",
                         "max_abs_err": k1_small_err,
                         **sweep_extra(solver_cuda.sweep_plan(128, 16), sweeps)},
                     stress2048={
                         "note": "N = 2048 contact-only, compared at the settled Stress2048 state",
                         "max_abs_err": k1_2048_err,
                         **sweep_extra(solver_cuda.sweep_plan(2048, 12), sweeps)},
                     joint_branch={
                         "note": "dj/ds > 0: every sweep and colour sub-pass in one resident "
                                 "launch; 20 SoftGrid sheets, N = 2048, 3600 soft joints, a "
                                 "cooperative launch of 128 blocks (RodJointed and SoftGrid: "
                                 "one cluster of 4, compared too)",
                         "launches": jointed["launches"], "max_abs_err": jointed["err"],
                         "ms": jointed["ms"], "plain_ms": jointed["plain_ms"],
                         "bound_ms": jb_bnd[0], "bound_by": jb_bnd[1],
                         "kernels_per_step": sum(c for _us, c in jointed["trace"].values()),
                         "device_us_per_step": sum(us for us, _c in jointed["trace"].values()),
                         **sweep_extra(solver_cuda.sweep_plan(2048, 32, None, 4), sweeps,
                                       rows=True),
                         "cluster_route": sweep_extra(solver_cuda.sweep_plan(128, 16, None, 2),
                                                      sweeps, rows=True)},
                     **{"collide": collide_extra(sweeps)},
                     state_layout={
                         "note": "diag row 1: the step's 16 lanes in the state layout (pair "
                                 "overflow cand - kept in int32) and the bool stick latches, "
                                 "against step_kernel_plain at the states of phase 21; "
                                 "max_abs_err: the control lanes' relative difference",
                         "max_abs_err": fused["ctrl_err"]},
                     paths={"swept broadphase": {
                         "launches": swept["fused"]["step_kernel"], "steps": 700,
                         "note": f"Stress1000 with bp_window {SWEPT_WINDOWS['Stress1000']}, "
                                 "phase 17"},
                         "bench": {"launches": bench["k1"], "note": bench_note}}),
        kernel_entry("control_lanes", csrc + "control_lanes.cu", "avbd3d_tpu/solver_tpu.py:262",
                     launches["control_lanes"], max(k2_err, batched["k2_err"]), k2_ms,
                     k2_plain_ms, k2_bnd,
                     kernel="k_control_lanes", kernels_per_call=1,
                     out_view={"note": "the fused path's ballistic step: K2 writes lanes 11-15 "
                                       "into k_ballistic_step's vector (out=), phase 21",
                               **fused["ballistic_step"]},
                     paths={"fused path": "the ballistic steps (phase 2)",
                            "portable path": {"launches": portable["launches"],
                                              "steps": portable["steps"],
                                              "note": "Stress1000 on backend='xla', phase 14: "
                                                      "one launch a step"},
                            "portable path, jointed N = 3072": {
                                "launches": chains["launches"], "steps": 200},
                            "batched_step": {
                                "launches": batched["launches"], "steps": batched["steps"],
                                "note": f"{BATCH} Stress1000 worlds, phase 16: one launch a "
                                        "batched step (grid.y = worlds); times at the kicked "
                                        "landing state",
                                "max_abs_err": batched["k2_err"], **batched["k2"]},
                            "swept broadphase": {
                                "launches": swept["fused"]["control_lanes"], "steps": 700,
                                "note": "Stress1000 with bp_window "
                                        f"{SWEPT_WINDOWS['Stress1000']}, phase 17: the ballistic "
                                        "steps"},
                            "bench": {"launches": bench["k2"], "note": bench_note}},
                     device_us={k: t["device_us"] for k, t in k2_times.items()},
                     ms_by_state={k: t["ms"] for k, t in k2_times.items()},
                     parent=None if sweeps["ab"] is None else {
                         k: parent_traced(sweeps, f"K2, {k}") for k in k2_times},
                     **sweeps["usage"]["k_control_lanes"]),
        kernel_entry("collide_and_init", csrc + "step_kernel.cu", "avbd3d_tpu/solver_tpu.py:152",
                     prof["launches"]["collide_and_init"], prof["err3"], prof["ms3"],
                     prof["plain3"], k3_bnd, **collide_extra(sweeps)),
        kernel_entry("solve_loop", csrc + "step_kernel.cu", "avbd3d_tpu/solver_tpu.py:922",
                     prof["launches"]["solve_loop"], prof["err4"], prof["ms4"], prof["plain4"],
                     k4_bnd, **sweep_extra(solver_cuda.sweep_plan(1024, 12), sweeps)),
        kernel_entry("collide_grid", csrc + "grid_kernels.cu", "avbd3d_tpu/solver_tpu.py:1355",
                     grid["launches"]["collide_grid"], grid["k5_err"], grid["k5_ms"],
                     grid["k5_plain_ms"], grid["k5_bound"], **collide_extra(sweeps),
                     device_us={k: us for k, (us, _c) in grid["k5_trace"].items()},
                     paths={"swept broadphase": {
                         "launches": swept["grid"]["collide_grid"], "steps": 200,
                         "note": f"Stress4096 with bp_window {SWEPT_WINDOWS['Stress4096']}, "
                                 "phase 17"},
                         "bench": {"launches": bench["grid"]["launches"]["collide_grid"],
                                   "steps": bench["grid"]["steps"],
                                   "note": "bench --quick, phase 18: the stress4096 regime"}}),
        kernel_entry("iterblock_grid", csrc + "grid_kernels.cu", "avbd3d_tpu/solver_tpu.py:1614",
                     grid["launches"]["iterblock_grid"], grid["k6_err"], grid["k6_ms"],
                     grid["k6_plain_ms"], grid["k6_bound"],
                     **sweep_extra(solver_cuda.sweep_plan(5120, 16, 1024), sweeps),
                     paths={"swept broadphase": {
                         "launches": swept["grid"]["iterblock_grid"], "steps": 200,
                         "note": f"Stress4096 with bp_window {SWEPT_WINDOWS['Stress4096']}, "
                                 "phase 17"},
                         "bench": {"launches": bench["grid"]["launches"]["iterblock_grid"],
                                   "steps": bench["grid"]["steps"],
                                   "note": "bench --quick, phase 18: the stress4096 regime"}}),
        kernel_entry("bp_probe", csrc + "bp_probe.cu", "avbd3d_tpu/solver_tpu.py:207",
                     probe["launches"], probe["err"], probe["ms"], probe["plain_ms"],
                     probe["bound"], kernel="k_probe", kernels_per_call=1,
                     device_us=probe["device_us"],
                     parent=parent_traced(sweeps, "K7, Stress1000 settled"),
                     **sweeps["usage"]["k_probe"], stress4096={
                         "note": "the settled Stress4096 state, N = 5120, D = 28",
                         "ms": probe["grid"]["ms"], "plain_ms": probe["grid"]["plain_ms"],
                         "device_us": probe["grid"]["device_us"],
                         "parent": parent_traced(sweeps, "K7, Stress4096 settled"),
                         "bound_ms": probe["grid"]["bound"][0],
                         "bound_by": probe["grid"]["bound"][1]}),
        kernel_entry("candidate_lists", csrc + "bp_refresh.cu", "avbd3d_tpu/ops/broadphase.py:231",
                     launches["candidate_lists"], 0.0, t4["lists"]["ms"], t4["lists"]["plain_ms"],
                     (t4["lists"]["bound_ms"], t4["lists"]["bound_by"]),
                     note="no Pallas kernel: the reference's candidate_lists runs in XLA; timed "
                          "at Stress4096 step 2800 (N = 5120, D = 28); max_abs_err: the slack, "
                          "the integer outputs identical at every state of phase 19",
                     kernel=list(REFRESH_KERNELS), kernels_per_call=len(REFRESH_KERNELS),
                     device_us=t4["lists"]["device_us"],
                     plain_launches=t4["lists"]["plain_launches"],
                     by_state={k: {f: v["lists"][f] for f in ("ms", "plain_ms", "device_us",
                                                               "plain_launches", "bound_ms",
                                                               "bound_by")}
                               for k, v in refresh["times"].items()},
                     paths={"fused path": {"launches": launches["candidate_lists"], "steps": 700,
                                           "note": "Stress1000, phase 2: once a refresh step"},
                            "grid tier": {"launches": grid["launches"]["candidate_lists"],
                                          "steps": 1000, "refresh_steps": grid["refreshes"],
                                          "note": "Stress4096, phase 5"}},
                     **{k: sweeps["usage"][k] for k in REFRESH_KERNELS}),
        kernel_entry("refresh_needed", csrc + "bp_refresh.cu", "avbd3d_tpu/ops/broadphase.py:153",
                     grid["launches"]["refresh_needed"], refresh["predicate_err"],
                     t4["predicate"]["ms"], t4["predicate"]["plain_ms"],
                     (t4["predicate"]["bound_ms"], t4["predicate"]["bound_by"]),
                     note="no Pallas kernel: the reference's refresh_or_reuse computes its "
                          "predicate in XLA; on no main path since the grid step folds the same "
                          "predicate into k_grid_gates (launches: phase 5's count, 0), kept as "
                          "ops.broadphase.refresh_needed's one launch and compared in phase 19; "
                          "timed at Stress4096 step 2800 (N = 5120); max_abs_err: dev_mm, "
                          "dev_raw bit for bit",
                     kernel=PREDICATE_KERNEL, kernels_per_call=1,
                     device_us=t4["predicate"]["device_us"],
                     plain_launches=t4["predicate"]["plain_launches"],
                     by_state={k: {f: v["predicate"][f] for f in (
                         "ms", "plain_ms", "device_us", "plain_launches", "bound_ms", "bound_by")}
                               for k, v in refresh["times"].items()},
                     **sweeps["usage"][PREDICATE_KERNEL]),
        *(kernel_entry(name, csrc + "grid_stages.cu", STAGE_REPLACES[name],
                       grid["launches"][name],
                       stages["mm_err"] if name == "grid_gates" else (
                           stages["speed_err"] if name == "grid_finalize" else 0.0),
                       stages["times"][name]["ms"], stages["times"][name]["plain_ms"],
                       (stages["times"][name]["bound_ms"], stages["times"][name]["bound_by"]),
                       note=STAGE_NOTES[name], kernel=STAGE_KERNELS[name], kernels_per_call=1,
                       device_us=stages["times"][name]["device_us"],
                       plain_launches=stages["times"][name]["plain_launches"],
                       plain_device_us=stages["times"][name]["plain_device_us"],
                       paths={"grid tier": {"launches": grid["launches"][name], "steps": 1000,
                                            "note": "Stress4096, phase 5: once a step"},
                              "swept broadphase": {
                                  "launches": swept["grid"][name], "steps": 200,
                                  "note": f"Stress4096 with bp_window "
                                          f"{SWEPT_WINDOWS['Stress4096']}, phase 17"}},
                       states=stages["states"], **sweeps["usage"][STAGE_KERNELS[name]])
          for name in STAGE_KERNELS),
        *(kernel_entry(name, csrc + "fused_stages.cu", FUSED_REPLACES[name], launches[name],
                       fused["speed_err"] if name == "ballistic_step" else 0.0,
                       fused["times"][name]["ms"], fused["times"][name]["plain_ms"],
                       (fused["times"][name]["bound_ms"], fused["times"][name]["bound_by"]),
                       note=FUSED_NOTES[name], kernel=FUSED_KERNELS[name], kernels_per_call=1,
                       device_us=fused["times"][name]["device_us"],
                       plain_launches=fused["times"][name]["plain_launches"],
                       plain_device_us=fused["times"][name]["plain_device_us"],
                       **({"floor_us": fused["times"][name]["floor"]} if name == "step_gates"
                          else {}),
                       paths={"fused path": {"launches": launches[name], "steps": 700,
                                             "note": "Stress1000, phase 2"},
                              "traced": {k: fused[k] for k in ("settled_trace",
                                                               "falling_trace")}},
                       states=fused["states"], **sweeps["usage"][FUSED_KERNELS[name]])
          for name in FUSED_KERNELS),
    ]}
    print(f"race gate: {race['routes']} resident routes, {RACE_REPS} repetitions each and the "
          f"delayed build bit-identical; compute-sanitizer: {json.dumps(race['sanitizer'])}")
    print(f"[{card}] settled Stress1000 trace: device {traced['device_us_per_step']:.1f} us/step, "
          f"busy share {100 * traced['busy']:.1f}%, {traced['launches_per_step']:.1f} launches/step, "
          f"{traced['own_per_step']:.1f} of them the port's")
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
