"""Smoke run of the PyTorch + CUDA port (avbd3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card and the torch/CUDA versions, builds the kernels from
   avbd3d_tpu_torch/csrc/ (one nvcc per source, in parallel) and prints the
   build time.
2. Fused path: Stress1000 (1000 cubes + ground, N = 1024, 20 iterations,
   D = 24, DC = 12) through ``load_scene(..., device="cuda")`` and ``step``
   for 700 steps (the falling regime with the ballistic rain-in, the landing,
   the settling pile), with the launch counters reset before and read after.
   Checks: K1 and K2 launched, sanitized == 0, overflow 0, penetration below
   PEN_LIMIT at every step after the landing cascade, poses finite.
3. Kernel vs plain on the card: K1 for one step from a landing state and a
   settled state, K2 on the initial and the settled state.  Integer outputs
   must be identical; float tolerances are stated at the checks.
4. Times: steps/s of the falling window (steps 0-300) and of a settled block
   (steps 700-1000) with the kernels, steps/s of the plain path over a few
   settled steps, and each kernel's time beside its plain version's.
5. Grid tier: Stress4096 (16^3 cubes + ground, N = 5120, G = 40, D = 28,
   DC = 16, x-major order) for 1000 steps, the reference's validated window,
   counters reset before and read after.  Checks: every step took the grid
   tier, K5 launched once and K6 five times per step, sanitized 0, pair and
   degree overflow 0 and finite poses at every step, penetration below
   PEN_LIMIT over steps 901-1000.  Then K5 and K6 against their plain
   versions from a landing and a settled state, their times, and the
   falling (0-300) and settled (901-1000) steps/s.
6. The reference's large-N gate (tests/test_large_n_envelope.py): the
   low-drop 16^3 pile with Stress4096's plan, 60 landing + 30 settle steps,
   overflow 0, sanitized 0, and the worst settle penetration held to
   LOW_DROP_PEN_LIMIT (see there: the reference's own grid tier does not
   meet the slop bound on IEEE float32).
7. Stress2048 (N = 2048, fused path) for 600 steps: K1 launched, the same
   envelope (penetration below PEN_LIMIT over steps 401-600), and steps/s of
   the last 200 steps.

Exits non-zero on any failure, and without CUDA.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

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
    as ``solver.step`` prepares them (refresh, gates, variant)."""
    from avbd3d_tpu_torch import solver, solver_cuda
    from avbd3d_tpu_torch.ops.broadphase import refresh_scalar

    p, cap = scene.params, scene.cap
    dv = solver.read_control(world)
    bp, refreshed = refresh_scalar(world.bp, dv, world.bodies, world.exclusions,
                                   cap.max_degree, p.bp_margin)
    world = world.replace(bp=bp)
    n_main, k = solver_cuda.select_variant(p, *solver.control_gates(dv, refreshed, p))
    bp = world.bp
    return (world.contacts, bp.nb, bp.key, bp.thr, world.bodies, bp.anchor,
            bp.anchor_quat, p, n_main, k)


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


def compare_k1(args, label: str) -> float:
    """K1 kernel vs plain on the same operands.  Integers (slots, counts,
    feature ids, stick latches, kept/dropped lanes) must be identical.  Both
    sides run the same float32 operations in the same order (csrc/
    avbd_common.cuh), so floats are held to 1e-5 (absolute for poses and
    velocities, relative for lambda/penalty/diagnostics) — a margin for the
    control lanes' block-wide sums, whose order differs."""
    import torch

    from avbd3d_tpu_torch import solver_cuda

    cp, bp_, dp = solver_cuda.step_kernel_plain(*args)
    ck, bk, dk = solver_cuda.step_kernel(*args)
    sync()
    for f in solver_cuda.CACHE_FIELDS:
        a, b = getattr(cp, f), getattr(ck, f)
        if a.dtype in (torch.int32, torch.bool):
            bad = int((a != b).sum())
            if bad:
                fail(f"K1 {label}: cache.{f} differs in {bad} entries")
        else:
            rel = float(((a - b).abs() / (a.abs() + 1.0)).max())
            if rel > 1e-5:
                fail(f"K1 {label}: cache.{f} rel err {rel}")
    for lane in (5, 6, 7, 8, 9, 15):
        if float(dp[0, lane]) != float(dk[0, lane]):
            fail(f"K1 {label}: diag lane {lane} {float(dp[0, lane])} vs {float(dk[0, lane])}")
    drel = float(((dp - dk).abs() / (dp.abs() + 1.0)).max())
    if drel > 1e-5:
        fail(f"K1 {label}: diag rel err {drel}")
    err = max(float((a - b).abs().max()) for a, b in zip(bp_, bk))
    if err > 1e-5:
        fail(f"K1 {label}: body outputs max abs err {err}")
    print(f"K1 vs plain ({label}): integers identical, body max abs err {err:.3e}, "
          f"diag max rel err {drel:.3e}, contacts {int(dk[0, 5])}")
    return err


def compare_k2(world, params, label: str) -> float:
    """K2 kernel vs plain: min/max lanes are exact in any order; the anchor
    deviation lane uses block-wide sums, so all lanes are held to a 1e-5
    relative (1e-6 absolute) tolerance."""
    from avbd3d_tpu_torch import solver_cuda

    b, bp = world.bodies, world.bp
    lp = solver_cuda.control_lanes_plain(bp.nb, b, bp.anchor, bp.anchor_quat, params)
    lk = solver_cuda.control_lanes(bp.nb, b, bp.anchor, bp.anchor_quat, params)
    sync()
    err = float((lp - lk).abs().max())
    tol = (1e-6 + 1e-5 * lp.abs()).min()
    if bool(((lp - lk).abs() > 1e-6 + 1e-5 * lp.abs()).any()):
        fail(f"K2 {label}: plain {lp.tolist()} vs kernel {lk.tolist()}")
    print(f"K2 vs plain ({label}): lanes {[round(x, 6) for x in lk.tolist()]}, "
          f"max abs err {err:.3e} (tol >= {float(tol):.1e})")
    return err


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    from avbd3d_tpu_torch import solver_cuda, solver_grid

    solver_cuda.reset_launch_counts()
    solver_grid.reset_launch_counts()


def read_counts() -> dict:
    from avbd3d_tpu_torch import solver_cuda, solver_grid

    return {"step_kernel": solver_cuda.step_kernel.launches,
            "control_lanes": solver_cuda.control_lanes.launches,
            "collide_grid": solver_grid.collide_grid.launches,
            "iterblock_grid": solver_grid.iterblock_grid.launches}


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
        if i + 1 == 250:
            saved["landing"] = w
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
    want = {"step_kernel": 0, "control_lanes": 0, "collide_grid": n_steps,
            "iterblock_grid": 5 * n_steps}
    if launches != want:
        fail(f"Stress4096 launch counts {launches}, expected {want}")
    if host_reads != n_steps:
        fail(f"Stress4096 host reads {host_reads}, expected one per step")
    watch.check("Stress4096", n_steps)
    diag = w.diagnostics.as_dict()
    print(f"Stress4096 step {n_steps}: manifolds {int(diag['active_manifolds'])}, contacts "
          f"{int(diag['active_contacts'])}, max_pen {diag['max_penetration']:.6f}, "
          f"max_lin {diag['max_linear_speed']:.4f}")
    saved["settled"] = w

    k5_err, k6_err = 0.0, 0.0
    for label in ("landing", "settled"):
        wi = grid_inputs(saved[label], scene)
        e5, contacts = compare_k5(wi, scene, label)
        k5_err = max(k5_err, e5)
        k6_err = max(k6_err, compare_k6(k6_args(wi, scene, contacts), label))

    fall_sps = 300 / marks[300]
    settled_sps = (n_steps - hold_from) / (t_run - marks[hold_from])
    print(f"[{card}] Stress4096 falling window (steps 0-300): {fall_sps:.1f} steps/s")
    print(f"[{card}] Stress4096 settled block (steps {hold_from + 1}-{n_steps}): "
          f"{settled_sps:.1f} steps/s")
    wi = grid_inputs(w, scene)
    a5 = k5_args(wi, scene)
    k5_ms = event_ms(lambda: solver_grid.collide_grid(*a5), 20)
    k5_plain_ms = event_ms(lambda: solver_grid.collide_grid_plain(*a5), 3)
    a6 = k6_args(wi, scene, solver_grid.collide_grid(*a5)[0])
    k6_ms = event_ms(lambda: solver_grid.iterblock_grid(*a6), 20)
    k6_plain_ms = event_ms(lambda: solver_grid.iterblock_grid_plain(*a6), 3)
    print(f"[{card}] grid collide kernel (K5, settled Stress4096): {k5_ms:.3f} ms, "
          f"plain {k5_plain_ms:.3f} ms")
    print(f"[{card}] grid iteration kernel (K6, one launch of {len(a6[2])} iterations): "
          f"{k6_ms:.3f} ms, plain {k6_plain_ms:.3f} ms")
    return {"launches": launches, "k5_err": k5_err, "k6_err": k6_err, "k5_ms": k5_ms,
            "k5_plain_ms": k5_plain_ms, "k6_ms": k6_ms, "k6_plain_ms": k6_plain_ms}


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


def stress2048_phase(card: str):
    """Stress2048 on the fused path: 600 steps, the envelope after the
    landing, steps/s of the last 200 steps."""
    from avbd3d_tpu_torch import load_scene, solver

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
    latches, kept and once masks, dropped count) identical; floats held to
    1e-5 relative (same float32 operations in the same order on both
    sides).  Returns (max abs float error, the kernel's contacts)."""
    from avbd3d_tpu_torch import solver_cuda, solver_grid

    args = k5_args(world, scene)
    cp, kp, op, dp = solver_grid.collide_grid_plain(*args)
    ck, kk, ok, dk = solver_grid.collide_grid(*args)
    sync()
    err = 0.0
    for f in solver_cuda.CACHE_FIELDS:
        a, b = getattr(cp, f), getattr(ck, f)
        if a.dtype.is_floating_point:
            rel = float(((a - b).abs() / (a.abs() + 1.0)).max())
            if rel > 1e-5:
                fail(f"K5 {label}: cache.{f} rel err {rel}")
            err = max(err, float((a - b).abs().max()))
        elif bool((a != b).any()):
            fail(f"K5 {label}: cache.{f} differs in {int((a != b).sum())} entries")
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
    print(f"K6 vs plain ({label}, {len(args[2])} iterations, gb={args[1]}): stick "
          f"identical, pose/sep max abs err {err:.3e}")
    return err


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
        print(f"{label}: max penetration {worst[0]:.6f} over steps 1-{n_steps} (landing "
              f"cascade), {held[0]:.6f} over steps {self.hold_from + 1}-{n_steps}; "
              f"sanitized 0, overflow 0, poses finite")
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
    print(f"kernels built in {lib.build_seconds:.1f} s ({os.path.basename(lib.path)})")
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
    launches = {"step_kernel": solver_cuda.step_kernel.launches,
                "control_lanes": solver_cuda.control_lanes.launches}
    host_reads = solver.step.host_reads
    worst = worst.tolist()
    diag = w.diagnostics.as_dict()
    print(f"main path: 700 steps in {t_main:.2f} s; gates {gates}; launches {launches}; "
          f"host reads {host_reads}")
    if launches["step_kernel"] == 0 or launches["control_lanes"] == 0:
        fail(f"a kernel of the main path never launched: {launches}")
    if launches["step_kernel"] != gates["contact"] or launches["control_lanes"] != gates["ballistic"]:
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
    init = scene.world
    init = init.replace(bp=build_bp_cache(init.bodies, init.exclusions, cap.max_degree,
                                          p.bp_margin))
    k2_err = max(compare_k2(init, p, "initial"), compare_k2(w, p, "settled"))

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
          f"manifolds {int(d_set['active_manifolds'])})")
    print(f"[{card}] settled, plain PyTorch path (3 steps): {plain_sps:.2f} steps/s")

    a1 = k1_inputs(w, scene)
    k1_ms = event_ms(lambda: solver_cuda.step_kernel(*a1), 20)
    k1_plain_ms = event_ms(lambda: solver_cuda.step_kernel_plain(*a1), 3)
    b, bp = w.bodies, w.bp
    k2_ms = event_ms(lambda: solver_cuda.control_lanes(bp.nb, b, bp.anchor, bp.anchor_quat, p), 100)
    k2_plain_ms = event_ms(
        lambda: solver_cuda.control_lanes_plain(bp.nb, b, bp.anchor, bp.anchor_quat, p), 20)
    print(f"[{card}] step kernel (settled, {a1[8]} iterations): {k1_ms:.3f} ms, "
          f"plain {k1_plain_ms:.3f} ms")
    print(f"[{card}] control-lanes kernel: {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms")

    grid = grid_phase(card)
    low_drop_gate()
    stress2048_phase(card)

    report = {"kernels": [
        {"name": "step_kernel", "route": "cuda",
         "source": "avbd3d_tpu_torch/csrc/step_kernel.cu",
         "replaces": "avbd3d_tpu/solver_tpu.py:864",
         "launches": launches["step_kernel"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "control_lanes", "route": "cuda",
         "source": "avbd3d_tpu_torch/csrc/control_lanes.cu",
         "replaces": "avbd3d_tpu/solver_tpu.py:262",
         "launches": launches["control_lanes"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "collide_grid", "route": "cuda",
         "source": "avbd3d_tpu_torch/csrc/grid_kernels.cu",
         "replaces": "avbd3d_tpu/solver_tpu.py:1355",
         "launches": grid["launches"]["collide_grid"], "max_abs_err": grid["k5_err"],
         "ms": grid["k5_ms"], "plain_ms": grid["k5_plain_ms"]},
        {"name": "iterblock_grid", "route": "cuda",
         "source": "avbd3d_tpu_torch/csrc/grid_kernels.cu",
         "replaces": "avbd3d_tpu/solver_tpu.py:1614",
         "launches": grid["launches"]["iterblock_grid"], "max_abs_err": grid["k6_err"],
         "ms": grid["k6_ms"], "plain_ms": grid["k6_plain_ms"]},
    ]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
