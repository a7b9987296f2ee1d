"""The stage kernels and the refresh lists in one tree: ptxas usage and times, on the card.

    python tools/grid_stage_ab.py [--root DIR] [--steps N] [--what stages,lists,fused,variants]

Builds the tree's kernels, prints the registers and spill bytes that ptxas
gave every stage kernel (``k_grid_*``, and ``k_step_gates`` /
``k_ballistic_step`` where the tree has them) and the refresh kernels
(``k_bp_*``), steps Stress4096 ``N`` steps (default 2800, the state
``chip_smoke.py`` phase 20 times at) and times each grid stage kernel at the
next step as phase 20 does (``chip_smoke.one_kernel_times``: CUDA-event ms
a call over 100 calls back to back, and the kernel's own us a call in a
trace).  ``lists``: a refresh (``build_bp_cache``: k_bp_tables and
k_bp_lists) timed the same way as phase 19 does, with its bound, at N =
1024 (Stress1000 step 700), 2048 (Stress2048 step 800), 5120 (that
Stress4096 state) and 16384 (the 31 x 17 x 31 pile's spawn compressed to
0.9).  ``fused``: ``k_step_gates`` at settled Stress1000 step 700 (phase
21's state) timed the same way and through its wrapper alone, and where
the tree has it (``kernels.launch_floor``) ``k_launch_floor`` at the
gates' grid and block in each of ``chip_smoke.FLOOR_CASES`` (the launch
floors); and ``k_ballistic_step`` at Stress1000 and Stress2048 step 1
(the rain-in, N = 1024 and 2048, DC = 12) against ``_ballistic_body``.
``variants``
(this tree's kernels only): builds with other geometry (``kernels.build``'s
defines ``AVBD_FIN_BLOCKS``, ``AVBD_PRED_BLOCKS``, ``AVBD_BAL_BLOCKS`` and
``AVBD_GATES_THREADS``), k_grid_finalize at one and four blocks an SM and
at one and two entries a slot thread, k_grid_predict at one and four blocks
an SM, at one group of 4 latches a latch thread and at a block for each 64
bodies, k_ballistic_step at one and four blocks an SM and at a block for
each 64 and each 16 bodies (Stress1000 step 1), and
k_step_gates at 32, 64 and 256 threads a block, each held bit for bit to
the default build's outputs and timed.  The last line is one JSON object.
``--root``: the tree whose package and ``chip_smoke.py`` are imported
(default: the tree this file lies in), e.g. an unpacked older commit; run
two trees in turns in one call (parent, change, change, parent) to compare
them on one card.
"""

import argparse
import json
import os
import sys

STAGES = (("grid_gates", "gates"), ("grid_predict", "predict"), ("grid_finalize", "finalize"))


def fused_world():
    """Settled Stress1000 at step 700 (phase 21's state) and its params."""
    from avbd3d_tpu_torch import load_scene, solver

    sc = load_scene("Stress1000", device="cuda")
    return solver.run_steps(sc.world, sc.params, sc.cap, 700), sc.params


def fused_times(cs, card) -> dict:
    """k_step_gates at settled Stress1000 step 700 against its plain
    version (through solver.step_gates, as phase 21 times it), then through
    its wrapper alone, called as the floors are; with the tree's floor
    kernel, the floors."""
    from avbd3d_tpu_torch import kernels, solver

    w, p = fused_world()
    out = {"step_gates": cs.one_kernel_times(
        card, "k_step_gates (settled Stress1000 step 700, N = 1024)", "k_step_gates",
        lambda: solver.step_gates(w, p), lambda: solver.step_gates_plain(w, p))}
    b, bp = w.bodies, w.bp
    out["step_gates_wrapper"] = cs.one_kernel_times(
        card, "k_step_gates through kernels.launch_step_gates, as the floors are launched",
        "k_step_gates",
        lambda: kernels.launch_step_gates(b, w.diagnostics.vec, bp.slack, bp.dropped, p),
        lambda: None)
    if hasattr(kernels, "launch_floor"):
        out["floor_us"] = cs.launch_floors(card, w, p.fall_freeze_y)
    for name, (wb, pb) in ballistic_worlds().items():
        out[f"ballistic_step {name}"] = cs.one_kernel_times(
            card, f"k_ballistic_step ({name}, N = {wb.bodies.n})", "k_ballistic_step",
            lambda wb=wb, pb=pb: kernels.launch_ballistic_step(wb.bodies, wb.contacts, pb),
            lambda wb=wb, pb=pb: solver._ballistic_body(wb, pb))
    return out


def ballistic_worlds() -> dict:
    """{label: (world, params)}: Stress1000 and Stress2048 at step 1 (the
    rain-in; phase 21 times the ballistic kernel at Stress1000's), frozen
    by the gates' plain version as phase 21 hands them to the kernel."""
    from avbd3d_tpu_torch import load_scene, solver

    out = {}
    for name in ("Stress1000", "Stress2048"):
        sc = load_scene(name, device="cuda")
        rain = solver.run_steps(sc.world, sc.params, sc.cap, 1)
        out[f"{name} step 1"] = (solver.step_gates_plain(rain, sc.params)[0], sc.params)
    return out


def variants(cs, card, a, steps) -> dict:
    """k_grid_finalize and k_grid_predict (Stress4096 step ``steps``, their
    operands ``a``), k_step_gates (settled Stress1000 step 700) and
    k_ballistic_step (Stress1000 step 1) through builds of other geometry,
    each output bit for bit the default build's: {label: the kernel's own
    us a call}."""
    import torch

    from avbd3d_tpu_torch import kernels

    f = a["finalize"]
    b, contacts, dc, d = f[1], f[2], f[2].other.shape[0], f[10].shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    entries = max(dc, d) * b.n
    groups = a["predict"][1].numel() // 4
    w, p = fused_world()
    gb, bp = w.bodies, w.bp
    wb, pb = ballistic_worlds()["Stress1000 step 1"]

    def fin():
        return list(kernels.launch_grid_finalize(b, *f[3:8], contacts, *f[8:]))

    def pred():
        return list(kernels.launch_grid_predict(*a["predict"]))

    def gates():
        return list(kernels.launch_step_gates(gb, w.diagnostics.vec, bp.slack, bp.dropped, p))

    def bal():
        return list(kernels.launch_ballistic_step(wb.bodies, wb.contacts, pb))

    calls = {"k_grid_finalize": fin, "k_grid_predict": pred, "k_step_gates": gates,
             "k_ballistic_step": bal}
    want = {k: call() for k, call in calls.items()}
    # (define, kernel, value, label) by build: four builds, each kernel at
    # another geometry in each.
    builds = (
        (("AVBD_FIN_BLOCKS", "k_grid_finalize", sms, "a block an SM"),
         ("AVBD_PRED_BLOCKS", "k_grid_predict", sms, "a block an SM"),
         ("AVBD_BAL_BLOCKS", "k_ballistic_step", sms, "a block an SM"),
         ("AVBD_GATES_THREADS", "k_step_gates", 32, "threads a block")),
        (("AVBD_FIN_BLOCKS", "k_grid_finalize", 4 * sms, "four blocks an SM"),
         ("AVBD_PRED_BLOCKS", "k_grid_predict", 4 * sms, "four blocks an SM"),
         ("AVBD_BAL_BLOCKS", "k_ballistic_step", 4 * sms, "four blocks an SM"),
         ("AVBD_GATES_THREADS", "k_step_gates", 64, "threads a block")),
        (("AVBD_FIN_BLOCKS", "k_grid_finalize", -(-entries // 256), "one entry a thread"),
         ("AVBD_PRED_BLOCKS", "k_grid_predict", -(-groups // 256), "one latch group a thread"),
         ("AVBD_BAL_BLOCKS", "k_ballistic_step", -(-wb.bodies.n // 64),
          "a block for each 64 bodies"),
         ("AVBD_GATES_THREADS", "k_step_gates", 256, "threads a block")),
        (("AVBD_FIN_BLOCKS", "k_grid_finalize", -(-entries // 512), "two entries a thread"),
         ("AVBD_PRED_BLOCKS", "k_grid_predict", -(-b.n // 64), "a block for each 64 bodies"),
         ("AVBD_BAL_BLOCKS", "k_ballistic_step", -(-wb.bodies.n // 16),
          "a block for each 16 bodies")),
    )
    out = {}
    for build in builds:
        lib = kernels.build(defines=tuple(f"{define}={value}" for define, _k, value, _l in build))
        with kernels.using(lib):
            for _define, name, value, what in build:
                label = (f"{value} threads a block" if name == "k_step_gates"
                         else f"{value} blocks ({what})")
                got = calls[name]()
                torch.cuda.synchronize()
                if not all(cs.same_bits_nan(x, y) for x, y in zip(got, want[name])):
                    raise SystemExit(f"{name} at {label} differs from the default build")
                t = cs.one_kernel_times(card, f"{name} at {label}", name, calls[name],
                                        lambda: None)
                out[f"{name} at {label}"] = t["device_us"]
    return out


def list_states(cs, g2800, s4096):
    """{label: (world, degree, margin)} at N = 1024, 2048, 5120 and 16384."""
    from avbd3d_tpu_torch import load_scene, solver
    from avbd3d_tpu_torch.convert import world_from_arrays
    from avbd3d_tpu_torch.models.scenes import _scene_stress_n

    out = {}
    for name, steps in (("Stress1000", 700), ("Stress2048", 800)):
        sc = load_scene(name, device="cuda")
        w = solver.run_steps(sc.world, sc.params, sc.cap, steps)
        out[f"{name} step {steps}"] = (w, sc.cap.max_degree, sc.params.bp_margin)
    out["Stress4096 step 2800"] = (g2800, s4096.cap.max_degree, s4096.params.bp_margin)
    arrays, p, cap, _n = _scene_stress_n(31, 17, 31, max_degree=28, cache_degree=16)
    big, _before = cs.compressed(world_from_arrays(arrays, "cuda"), p, cap)
    out["pile 31x17x31 compressed"] = (big, cap.max_degree, p.bp_margin)
    return out


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--steps", type=int, default=2800)
    ap.add_argument("--what", default="stages,lists,fused")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    what = set(args.what.split(","))
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs
    from avbd3d_tpu_torch import kernels, load_scene, solver, solver_grid
    from avbd3d_tpu_torch.ops import broadphase as bpm

    if not torch.cuda.is_available():
        print("grid_stage_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = cs.card_line()
    lib = kernels.build()
    usage = {k: v for k, v in kernels.ptxas_usage(lib.log).items()
             if k.startswith(("k_grid_", "k_step_gates", "k_ballistic_step", "k_bp_"))}
    for name, u in sorted(usage.items()):
        print(f"ptxas {name}: {u['registers']} registers, {u['spill_bytes']} spill bytes")
    times = {}
    if what & {"stages", "lists", "variants"}:
        sc = load_scene("Stress4096", device="cuda")
        w = solver.run_steps(sc.world, sc.params, sc.cap, args.steps)
    if "stages" in what:
        a = cs.stage_args(w, sc.params, sc.cap)
        for name, key in STAGES:
            kern, plain = getattr(solver_grid, name), getattr(solver_grid, name + "_plain")
            times[name] = cs.one_kernel_times(
                card, f"{name} (Stress4096 step {args.steps})", cs.STAGE_KERNELS[name],
                lambda kern=kern, key=key: kern(*a[key]),
                lambda plain=plain, key=key: plain(*a[key]))
    if "fused" in what:
        times["fused"] = fused_times(cs, card)
    if "variants" in what:
        times["variants"] = variants(cs, card, cs.stage_args(w, sc.params, sc.cap), args.steps)
    if "lists" in what:
        for label, (world, degree, margin) in list_states(cs, w, sc).items():
            b, ex = world.bodies, world.exclusions
            t = cs.one_kernel_times(
                card, f"refresh lists ({label}, N = {b.n}, D = {degree})", cs.REFRESH_KERNELS,
                lambda b=b, ex=ex, degree=degree, margin=margin: bpm.build_bp_cache(
                    b, ex, degree, margin),
                lambda b=b, ex=ex, degree=degree, margin=margin: cs.plain_cache(
                    b, ex, degree, margin), 100 if b.n <= 5120 else 20)
            t["bound_ms"], t["bound_by"] = cs.refresh_bounds(world, degree)["lists"]
            t["n"] = b.n
            times[f"lists {label}"] = t
    print(json.dumps({"tree": root, "card": card, "steps": args.steps, "ptxas": usage,
                      "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
