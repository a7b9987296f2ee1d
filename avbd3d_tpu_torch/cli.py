"""Headless runner for the PyTorch port (the reference's --nogfx mode).

    python -m avbd3d_tpu_torch.cli --nogfx --scene Stress1000 --steps 600 \\
        --bench --device cuda

Prints the reference CLI's ``[Physics]`` and ``Diagnostics:`` lines
(avbd3d_tpu/cli.py) per step, or with ``--bench`` only the final
diagnostics and the steps/sec of the run.  The per-body trace dump of the
reference is not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .models.scenes import SCENE_NAMES, load_scene
from .solver import step


def _physics_line(step_index: int, d: dict, out) -> None:
    """The in-solver diagnostics line (solver.cpp:503-513)."""
    out.write(
        "[Physics] step %d | manifolds: %d | contacts: %d | dyn bodies: %d "
        "| maxPen: %.6f | maxDrift: %.6f | maxLin: %.3f | maxAng: %.3f "
        "| maxLambda: %.3f\n"
        % (step_index, int(d["active_manifolds"]), int(d["active_contacts"]),
           int(d["dynamic_bodies"]), d["max_penetration"],
           d["max_constraint_violation"], d["max_linear_speed"],
           d["max_angular_speed"], d["max_normal_impulse"]))


def _dump_diag(d: dict, out) -> None:
    out.write(
        "  Diagnostics: manifolds=%d contacts=%d dynBodies=%d maxPen=%.6f "
        "maxDrift=%.6f maxLin=%.3f maxAng=%.3f maxLambda=%.3f\n"
        % (int(d["active_manifolds"]), int(d["active_contacts"]),
           int(d["dynamic_bodies"]), d["max_penetration"],
           d["max_constraint_violation"], d["max_linear_speed"],
           d["max_angular_speed"], d["max_normal_impulse"]))
    overflow = int(d["pair_overflow"]) + int(d["degree_overflow"])
    if overflow:
        out.write(f"  WARNING: capacity overflow ({overflow} dropped slots)\n")
    if int(d["sanitized"]):
        out.write(f"  WARNING: sanitized {int(d['sanitized'])} non-finite states\n")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="AVBD 3D (PyTorch port) headless runner")
    parser.add_argument("--nogfx", "--headless", action="store_true", dest="headless")
    parser.add_argument("--scene", "-s", default="TwoBlockDrop", choices=SCENE_NAMES)
    parser.add_argument("--steps", "-n", type=int, default=300)
    parser.add_argument("--bench", action="store_true", help="time steps/sec")
    parser.add_argument("--device", default="cpu",
                        help="torch device to run on (cpu or cuda); default cpu")
    args = parser.parse_args(argv)

    scene = load_scene(args.scene, device=args.device)
    world, params, cap = scene.world, scene.params, scene.cap
    out = sys.stdout
    out.write(f"Running in headless mode: scene '{scene.name}', steps={args.steps}, "
              f"device={args.device}\n")

    if args.bench:
        world = step(world, params, cap)      # warm-up (kernel build on CUDA)
        _sync(args.device)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            world = step(world, params, cap)
        _sync(args.device)
        dt = time.perf_counter() - t0
        _dump_diag(world.diagnostics.as_dict(), out)
        kind = (torch.cuda.get_device_name(torch.device(args.device))
                if torch.device(args.device).type == "cuda" else "cpu")
        out.write(f"{args.steps} steps in {dt:.3f}s = {args.steps / dt:.1f} steps/sec "
                  f"({kind})\n")
        return 0

    for i in range(args.steps):
        world = step(world, params, cap)
        d = world.diagnostics.as_dict()
        _physics_line(i + 1, d, out)
        out.write(f"Step {i}:\n")
        _dump_diag(d, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
