"""Smoke run of the PyTorch + CUDA port (avbd3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card and the torch/CUDA versions, builds the kernels from
   avbd3d_tpu_torch/csrc/ and prints the build time.
2. Main path: Stress1000 (1000 cubes + ground, N = 1024, 20 iterations,
   D = 24, DC = 12) through ``load_scene(..., device="cuda")`` and ``step``
   for 700 steps (the falling regime with the ballistic rain-in, the landing,
   the settling pile), with both kernels' launch counters reset before and
   read after.  Checks: both kernels launched, sanitized == 0, overflow 0,
   penetration below PEN_LIMIT at every step after the landing cascade,
   poses finite.
3. Kernel vs plain on the card: the step kernel (K1) for one step from a
   landing state and a settled state, the control-lanes kernel (K2) on the
   initial and the settled state.  Integer outputs must be identical; float
   tolerances are stated at the checks.
4. Times: steps/s of the falling window (steps 0-300) and of a settled block
   (steps 700-1000) with the kernels, steps/s of the plain path over a few
   settled steps, and each kernel's time beside its plain version's.

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

# Penetration bound, held at every step after the landing cascade (steps
# 301-700).  During the cascade (steps ~115-300: 1000 cubes arriving at up
# to ~25 m/s) the reference itself penetrates transiently far deeper — its
# JAX CPU run of this scene reaches 0.22 at step 162 — so those steps are
# reported, not held to it.
PEN_LIMIT = 0.01


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
    solver_cuda.reset_launch_counts()
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
    ]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
