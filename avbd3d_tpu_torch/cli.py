"""Headless CLI of the PyTorch port: the reference's --nogfx mode.

    python -m avbd3d_tpu_torch.cli --nogfx --scene Stress1000 --steps 600 --bench
    python -m avbd3d_tpu_torch.cli --nogfx --scene "Rod (WIP)" --steps 5 --device cpu

Port of ``avbd3d_tpu/cli.py`` (which mirrors main.cpp:189-248): flag parsing
(--nogfx/--headless, --scene/-s, --steps/-n), per step the in-solver
``[Physics]`` line, the dump of every body's position, orientation and
velocities (newest body first — the C++ body list is LIFO) and the
``Diagnostics:`` line.  The output after the first line is the reference's,
byte for byte where the floats agree.

Flags beyond the C++ program's:
  --quiet          only the diagnostics line per step
  --bench          no per-step host copy; prints steps/sec at the end
  --print-every    print every K steps instead of every step
  --log-frequency  cadence of the [Physics] line (0 disables)
  --device         cuda (the default; raises without CUDA) or cpu (the
                   kernels' plain versions)

The first line is the reference's up to ``steps=N``; the device follows it.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .models.scenes import SCENE_NAMES, load_scene
from .solver import step
from .utils.native import format_step


def _dump_step(step_idx: int, world, n_real: int, out) -> None:
    """The per-body dump, from ONE device-to-host copy of the four leaves."""
    b = world.bodies
    rows = torch.cat([b.pos, b.quat, b.linvel, b.angvel]).reshape(13, -1)[:, :n_real]
    host = rows.T.contiguous().cpu().numpy()
    out.write(format_step(step_idx, host[:, 0:3], host[:, 3:7], host[:, 7:10],
                          host[:, 10:13], n_real))


def _physics_line(step_index: int, d: dict, out) -> None:
    """The in-solver diagnostics line (solver.cpp:503-513): printed every
    ``logFrequency`` steps; headless mode forces frequency 1
    (main.cpp:207-208).  ``step_index`` is the solver's 1-based counter."""
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
    parser.add_argument("--quiet", action="store_true", help="diagnostics only")
    parser.add_argument("--bench", action="store_true", help="time steps/sec")
    parser.add_argument("--print-every", type=int, default=1)
    parser.add_argument(
        "--log-frequency", type=int, default=1,
        help="[Physics] line cadence (solver.logFrequency; headless forces "
        "diagnostics on with frequency 1, main.cpp:207-208); 0 disables")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on: cuda (the default; raises "
                             "without CUDA) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)
    if args.print_every < 1:
        parser.error("--print-every must be >= 1")

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
        # The solver's [Physics] line first (printed from inside
        # Solver::step in the C++ program), then main's per-body dump.
        log = args.log_frequency > 0 and (i + 1) % args.log_frequency == 0
        quiet_step = bool((i + 1) % args.print_every) and i != args.steps - 1
        if not log and quiet_step:
            continue
        d = world.diagnostics.as_dict()
        if log:
            _physics_line(i + 1, d, out)
        if quiet_step:
            continue
        if not args.quiet:
            _dump_step(i, world, scene.n_real, out)
        else:
            out.write(f"Step {i}:\n")
        _dump_diag(d, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
