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
floors).  ``variants``
(this tree's kernels only): builds with other geometry (``kernels.build``'s
defines ``AVBD_FIN_BLOCKS`` and ``AVBD_GATES_THREADS``), k_grid_finalize at
one and four blocks an SM and at one and two entries a slot thread, and
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
    return out


def variants(cs, card, a, steps) -> dict:
    """k_grid_finalize (Stress4096 step ``steps``, its operands ``a``) and
    k_step_gates (settled Stress1000 step 700) through builds of other
    geometry, each output bit for bit the default build's: {label: the
    kernel's own us a call}."""
    import torch

    from avbd3d_tpu_torch import kernels

    f = a["finalize"]
    b, contacts, dc, d = f[1], f[2], f[2].other.shape[0], f[10].shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    entries = max(dc, d) * b.n
    w, p = fused_world()
    gb, bp = w.bodies, w.bp

    def fin():
        return list(kernels.launch_grid_finalize(b, *f[3:8], contacts, *f[8:]))

    def gates():
        return list(kernels.launch_step_gates(gb, w.diagnostics.vec, bp.slack, bp.dropped, p))

    want_fin, want_gates = fin(), gates()
    out = {}
    for (fin_label, blocks), threads in zip(
            (("a block an SM", sms), ("four blocks an SM", 4 * sms),
             ("one entry a thread", -(-entries // 256)),
             ("two entries a thread", -(-entries // 512))), (32, 64, 256, None)):
        defines = (f"AVBD_FIN_BLOCKS={blocks}",) + (
            (f"AVBD_GATES_THREADS={threads}",) if threads else ())
        lib = kernels.build(defines=defines)
        with kernels.using(lib):
            for name, call, want, label in (
                    ("k_grid_finalize", fin, want_fin, f"{blocks} blocks ({fin_label})"),
                    *((("k_step_gates", gates, want_gates, f"{threads} threads a block"),)
                      if threads else ())):
                got = call()
                torch.cuda.synchronize()
                if not all(cs.same_bits_nan(x, y) for x, y in zip(got, want)):
                    raise SystemExit(f"{name} at {label} differs from the default build")
                t = cs.one_kernel_times(card, f"{name} at {label}", name, call, lambda: None)
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
