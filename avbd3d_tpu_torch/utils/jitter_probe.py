"""Chaos or drift: Stress4096's late penetration under perturbed jitter.

    python -m avbd3d_tpu_torch.utils.jitter_probe [--seeds 4] [--steps 1000]
        [--amp 0.001] [--device cuda|cpu] [--scene Stress4096] [--out FILE]

Runs ``--scene`` (Stress4096: 16^3 cubes, N = 5120, the grid tier) for
``--steps`` steps as it is (seed 0) and from ``--seeds`` seeded
perturbations of its initial jitter: every dynamic body's spawn position
moved by a uniform draw in [-amp, amp] on each axis (numpy
``default_rng(seed)``), a small fraction of the scene's own hash jitter
(0.04 m in x and z, 0.25 m in y).  For each run it prints the largest
penetration of every block of 100 steps, the manifold and contact counts
at the last step, and the worst sanitized and overflow counts; the last line
is one JSON object (also written to ``--out``).  If the perturbed runs
spread over the reference's range, the port's late envelope is chaos; if
all stay above it, drift (ROADMAP Queue 3).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import load_scene, solver
from .profile_phases import card_line


def perturbed(world, seed: int, amp: float):
    """``world`` with every dynamic body's position moved by a seeded
    uniform draw in [-amp, amp] per axis (seed 0: unchanged)."""
    if seed == 0:
        return world
    b = world.bodies
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.uniform(-amp, amp, tuple(b.pos.shape)).astype(np.float32))
    noise = noise.to(b.pos.device) * b.dynamic.to(torch.float32)[None]
    return world.replace(bodies=b.replace(pos=b.pos + noise))


def run(scene, seed: int, steps: int, amp: float) -> dict:
    w, p, cap = perturbed(scene.world, seed, amp), scene.params, scene.cap
    blocks, worst = [], torch.zeros(16, device=w.bodies.pos.device)
    block = torch.zeros((), device=w.bodies.pos.device)
    t0 = time.perf_counter()
    for i in range(steps):
        w = solver.step(w, p, cap)
        v = w.diagnostics.vec
        block = torch.maximum(block, v[0])
        worst = torch.maximum(worst, v)
        if (i + 1) % 100 == 0 or i + 1 == steps:
            blocks.append(float(block))
            block = torch.zeros_like(block)
    d = w.diagnostics.as_dict()
    worst = worst.tolist()
    return {"seed": seed, "max_pen_per_100": blocks,
            "manifolds": int(d["active_manifolds"]), "contacts": int(d["active_contacts"]),
            "sanitized": worst[8], "pair_overflow": worst[9], "degree_overflow": worst[10],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="Stress4096")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--amp", type=float, default=0.001)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("jitter_probe: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line() if args.device == "cuda" else "cpu"
    print(f"card: {card}")
    scene = load_scene(args.scene, args.device)
    runs = []
    for seed in range(args.seeds + 1):
        r = run(scene, seed, args.steps, args.amp)
        runs.append(r)
        print(f"[{card}] {args.scene} seed {seed} (amp {args.amp} m), {args.steps} steps in "
              f"{r['seconds']:.1f} s: max penetration per 100 steps "
              + " ".join(f"{x:.4f}" for x in r["max_pen_per_100"])
              + f"; step {args.steps}: {r['manifolds']} manifolds, {r['contacts']} contacts; "
              f"worst sanitized {r['sanitized']:.0f}, overflow pair {r['pair_overflow']:.0f} "
              f"degree {r['degree_overflow']:.0f}")
    result = {"card": card, "scene": args.scene, "amp": args.amp, "steps": args.steps,
              "runs": runs}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
