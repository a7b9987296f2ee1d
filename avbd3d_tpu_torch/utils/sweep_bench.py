"""The swept broadphase against the matrix, refresh by refresh (ROADMAP R1).

    python -m avbd3d_tpu_torch.utils.sweep_bench [--device cuda|cpu] [--small]
        [--out FILE]

1. States, made by runs with the matrix broadphase (``bp_window`` 0), which
   also count their refresh steps: Stress1000 at step 100 (falling) and
   700 (settled), Stress2048 at step 600 (settled), Stress4096 at step 1000
   (settled, grid tier), and a contact-only pile of 31 x 17 x 31 cubes
   (N = 16384) at its spawn poses (no steps).
2. At each state, the windows of ``WINDOWS`` in turn until one takes the
   sweep (``sweep_lists``' guard passes); then one refresh
   (``build_bp_cache``) with that window against one with the matrix: the
   lists must be identical and the sweep's slack at most the matrix's; ms a
   refresh by CUDA events over ``REPS`` calls (the sweep's one host read
   included), and the kernels launched and their device time a refresh
   from a ``torch.profiler`` trace.
3. Stress1000 for 700 steps and Stress4096 for 1000 steps from step 0 with
   the window that took the sweep at every state of that scene: refresh
   steps, sweeps, fallbacks and wall time, beside the matrix run's.

Prints the card's name and power limit, a line per measurement and, last,
one JSON object (also written to ``--out``).  Exits 1 when a sweep's lists
differ from the matrix's.  ``--device cpu --small`` rehearses the control
flow on a few steps of Stress1000 with host-clock times (no device figure).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import load_scene, solver
from ..convert import world_from_arrays
from ..models.scenes import Scene, _scene_stress_n
from ..ops.broadphase import build_bp_cache, candidate_lists_swept, sweep_lists
from .profile_phases import card_line, device_time_us

WINDOWS = (248, 504, 1016, 2040, 4088)
REPS = 10


def _sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def ms_per_call(fn, reps: int, dev: str) -> float:
    """Mean ms a call: CUDA events on the card, the host clock on the CPU."""
    fn()
    _sync(dev)
    if dev != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1000 * (time.perf_counter() - t0) / reps
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def traced(fn, reps: int) -> dict:
    """Kernels launched and their device us a call, from a trace of
    ``reps`` calls (copies and memsets not counted)."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and device_time_us(e) > 0.0 and not e.key.startswith(("Memcpy", "Memset"))]
    return {"launches": sum(e.count for e in rows) / reps,
            "device_us": sum(device_time_us(e) for e in rows) / reps}


def first_window(world, degree: int, margin: float):
    """The smallest window of WINDOWS whose guard passes at ``world``, with
    its sweep axis and fat-body count; (None, None, None) if none does."""
    b = world.bodies
    half = tuple(b.size[k] * 0.5 for k in range(3))
    for w in WINDOWS:
        if w + 8 > b.n:
            break
        _lists, info = sweep_lists(b.pos, b.quat, half, b.radius, b.dynamic, world.exclusions,
                                   degree, margin, w)
        if not bool(info["need_fallback"]):
            return w, int(info["axis"]), int(info["fat"].sum())
    return None, None, None


def refresh_pair(world, degree: int, margin: float, window: int, dev: str) -> dict:
    """One refresh with ``window`` against one with the matrix at ``world``:
    whether the sweep fell back, identity of the lists, the swept cache
    (``cache``), and the cost of each."""
    b, ex = world.bodies, world.exclusions
    swept = build_bp_cache(b, ex, degree, margin, window=window)
    fallback = candidate_lists_swept.last["fallback"]
    matrix = build_bp_cache(b, ex, degree, margin)
    same = all(torch.equal(getattr(swept, f), getattr(matrix, f))
               for f in ("nb", "key", "thr", "cand"))
    out = {"identical": same, "fallback": fallback, "slack": float(swept.slack),
           "matrix_slack": float(matrix.slack),
           "slack_ok": float(swept.slack) <= float(matrix.slack), "cache": swept}
    for label, w in (("swept", window), ("matrix", 0)):
        def fn(w=w):
            return build_bp_cache(b, ex, degree, margin, window=w)
        out[f"{label}_ms"] = ms_per_call(fn, REPS, dev)
        if dev == "cuda":
            out[label] = traced(fn, 3)
    return out


def run(scene: Scene, n_steps: int, window: int, marks=()) -> dict:
    """``n_steps`` steps from step 0 with ``bp_window`` = ``window``: refresh
    steps, the sweep's calls and fallbacks, wall seconds, and the states at
    ``marks``."""
    w, p, cap = scene.world, scene.params, scene.cap.replace(bp_window=window)
    c = candidate_lists_swept
    base = (c.swept, c.fallbacks)
    dev = w.bodies.pos.device.type
    refreshes, states = 0, {}
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(n_steps):
        w = solver.step(w, p, cap)
        refreshes += int(solver.step.last_gates["refreshed"])
        if i + 1 in marks:
            states[i + 1] = w
    _sync(dev)
    return {"window": window, "steps": n_steps, "refresh_steps": refreshes,
            "swept": c.swept - base[0], "fallbacks": c.fallbacks - base[1],
            "seconds": time.perf_counter() - t0, "states": states,
            "max_penetration": float(w.diagnostics.vec[0])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="Stress1000 only, states at steps 3 and 6 (a rehearsal)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("sweep_bench: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line() if dev == "cuda" else "cpu (host clock; no device figure)"
    print(f"card: {card}")

    # (scene, steps of its matrix run, states to keep, steps of its swept run)
    plan = ([("Stress1000", 6, (3, 6), 6)] if args.small else
            [("Stress1000", 700, (100, 700), 700), ("Stress2048", 600, (600,), 0),
             ("Stress4096", 1000, (1000,), 1000)])
    result = {"card": card, "device": dev, "states": {}, "runs": {}}
    states = []
    for name, n_steps, marks, _ in plan:
        sc = load_scene(name, dev)
        r = run(sc, n_steps, 0, marks)
        result["runs"][f"{name} matrix"] = {k: v for k, v in r.items() if k != "states"}
        print(f"[{card}] {name} {n_steps} steps, matrix: {r['refresh_steps']} refresh steps, "
              f"{r['seconds']:.2f} s")
        states += [(f"{name} step {m}", sc, r["states"][m]) for m in marks]
    if not args.small:
        arrays, p, cap, n_real = _scene_stress_n(31, 17, 31, max_degree=28, cache_degree=16)
        pile = Scene("pile 31x17x31", world_from_arrays(arrays, dev), p, cap, n_real)
        states.append(("pile 31x17x31 spawn", pile, pile.world))

    ok = True
    windows = {}
    for label, sc, w in states:
        deg, margin = sc.cap.max_degree, sc.params.bp_margin
        window, axis, n_fat = first_window(w, deg, margin)
        entry = {"n": w.bodies.n, "window": window, "axis": axis, "fat": n_fat}
        if window is not None:
            entry.update(refresh_pair(w, deg, margin, window, dev))
            del entry["cache"]
            ok &= entry["identical"] and entry["slack_ok"]
            prof = "".join(
                f"; {k}: {entry[k]['launches']:.0f} kernels, {entry[k]['device_us']:.1f} us on "
                f"the card" for k in ("swept", "matrix") if k in entry)
            print(f"[{card}] {label} (N = {w.bodies.n}): window {window} (axis {axis}, "
                  f"{n_fat} fat), lists {'identical' if entry['identical'] else 'DIFFER'}, "
                  f"slack {entry['slack']:.6g} <= {entry['matrix_slack']:.6g}; refresh "
                  f"swept {entry['swept_ms']:.3f} ms, matrix {entry['matrix_ms']:.3f} ms{prof}")
        else:
            print(f"[{card}] {label} (N = {w.bodies.n}): no window of {WINDOWS} passes")
        result["states"][label] = entry
        windows.setdefault(sc.name, []).append(window)

    for name, _n, _marks, n_swept in plan:
        # The window that took the sweep at every state of the scene.
        if not n_swept or None in windows[name]:
            continue
        window = max(windows[name])
        r = run(load_scene(name, dev), n_swept, window)
        result["runs"][f"{name} swept"] = {k: v for k, v in r.items() if k != "states"}
        print(f"[{card}] {name} {n_swept} steps, window {window}: {r['refresh_steps']} refresh "
              f"steps ({r['swept']} swept, {r['fallbacks']} fallbacks), {r['seconds']:.2f} s")
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
