"""Where a step's launches come from: a block of steps traced with every
launch attributed to the stage of the step that queued it.

    python avbd3d_tpu_torch/utils/stage_trace.py [--root DIR] [--scene NAME]
        [--warm N] [--steps N] [--out FILE]

Run by path, not with ``-m``: the package is imported from ``--root``
(default: the tree this file lies in), so one call can trace two trees in
turns, e.g. an archive of an earlier commit unpacked beside the working
tree.  After ``--warm`` steps (default 1000; 0 traces from the built scene)
of ``--scene`` (default Stress4096, the grid tier; Stress1000 the fused
path: ``--warm 0`` its falling window with the ballistic steps, ``--warm
700`` a settled one) on the card, ``--steps`` steps (default 50) run under
``torch.profiler`` with the
step's stage functions wrapped in ``record_function`` ranges (those of
``STAGES`` that the tree has; a stage function called inside another
stage belongs to the inner one, but ``_sanitize`` counts as its own stage
only where ``step_grid`` calls it, not inside predict or finalize).  Each
kernel launch (a runtime launch call on the host) is attributed to the
innermost range around it; each kernel on the card to its launch call by
correlation id.  Prints, with the card's name and power limit, a table of
each stage's launches, kernels' device time, copies and host time a step,
the kernels by name within each stage, the block's launches and device time
a step and its idle share, the ballistic and refresh steps among them, and
one JSON line last (``--out`` also writes it to a file).
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import subprocess
import sys
import time

# (module, function, stage label, labels inside which it opens no range of
# its own).  Listed outer to inner: a step's remainder is "step (other)".
STAGES = (
    ("solver", "step", "step (other)", ()),
    ("solver", "freeze_fallen", "freeze", ()),
    ("solver", "read_control", "control read", ()),
    ("solver", "step_gates", "step gates", ()),
    ("solver", "host_read", "control read", ()),
    ("solver", "_grid_step", "gates (stack, host read)", ()),
    ("solver", "refresh_needed", "predicate", ()),
    ("solver", "stale_lhs_ok", "speed gates", ()),
    ("solver_grid", "grid_gates", "gates kernel", ()),
    ("solver", "refresh_or_reuse", "refresh", ()),
    ("solver", "refresh_scalar", "refresh", ()),
    ("solver", "_ballistic_step", "ballistic (other)", ()),
    ("solver", "ballistic_step", "ballistic (other)", ()),
    ("solver", "attach_control", "control lanes (cat)", ()),
    ("solver_cuda", "control_lanes", "K2", ()),
    ("solver_cuda", "step_fused", "step_fused (diagnostics reorder)", ()),
    ("solver_cuda", "step_kernel", "K1", ()),
    ("solver_grid", "step_grid", "step_grid (layout, stick, overflow)", ()),
    ("solver_grid", "collide_grid", "K5", ()),
    ("solver_cuda", "cache_to_args", "stick conversions", ()),
    ("solver_cuda", "args_to_cache", "stick conversions", ()),
    ("solver", "predict", "predict", ()),
    ("solver_grid", "grid_predict", "predict", ()),
    ("solver_grid", "iterblock_grid", "K6", ()),
    ("solver", "_sanitize", "sanitize", ("predict", "finalize")),
    ("solver", "finalize", "finalize", ()),
    ("solver_grid", "grid_finalize", "finalize", ()),
    ("solver", "make_diagnostics", "diagnostics", ()),
)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def install(mods: dict, active: list) -> list:
    """Wraps every function of STAGES that ``mods`` has; returns the
    (module, name, original) triples to restore."""
    import torch

    saved = []
    for mod_name, fn_name, label, not_in in STAGES:
        mod = mods[mod_name]
        fn = getattr(mod, fn_name, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _label=label, _not_in=not_in, **kw):
            if active and active[-1] in _not_in:
                return _fn(*a, **kw)
            active.append(_label)
            try:
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)
            finally:
                active.pop()

        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, functools.wraps(fn)(wrapped))
    return saved


def attribute(events, labels) -> dict:
    """Per stage: launches, kernels, device us, copies and host self us of
    the traced events (FunctionEvents; one host thread drives the step),
    and the kernels by name."""
    from torch.autograd import DeviceType

    out = collections.defaultdict(lambda: {"launches": 0, "kernels": 0, "device_us": 0.0,
                                           "copies": 0, "host_us": 0.0,
                                           "by_kernel": collections.Counter()})
    cpu = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async
           and (e.name in labels or e.name in LAUNCH_CALLS or e.name in COPY_CALLS)]
    cpu.sort(key=lambda e: (e.time_range.start, e.name not in labels, -e.time_range.end))
    stack, by_id = [], {}
    for e in cpu:
        t = e.time_range.start
        while stack and stack[-1].time_range.end < t:
            stack.pop()
        if e.name in labels:
            dur = e.time_range.end - t
            out[e.name]["host_us"] += dur
            if stack:   # self time: less the ranges directly inside
                out[stack[-1].name]["host_us"] -= dur
            stack.append(e)
            continue
        stage = stack[-1].name if stack else "outside the step"
        by_id[e.id] = stage
        out[stage]["launches" if e.name in LAUNCH_CALLS else "copies"] += 1
    for e in device_ops(events, labels):
        if e.name.startswith(("Memcpy", "Memset")):
            continue
        stage = by_id.get(e.id, "unmatched")
        out[stage]["kernels"] += 1
        out[stage]["device_us"] += e.time_range.end - e.time_range.start
        out[stage]["by_kernel"][e.name.removeprefix("void ")[:60]] += 1
    return out


def device_ops(events, labels):
    """The kernels and copies on the card: its events but the stages'
    own ranges, which the profiler mirrors on the device's timeline."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA and e.name not in labels]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    parser.add_argument("--scene", default="Stress4096")
    parser.add_argument("--warm", type=int, default=1000)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from avbd3d_tpu_torch import kernels, load_scene, solver, solver_cuda, solver_grid

    if not torch.cuda.is_available():
        print("stage_trace: CUDA is not available", file=sys.stderr)
        return 2
    kernels.build()
    card = card_line()
    sc = load_scene(args.scene, device="cuda")
    w, p, cap = sc.world, sc.params, sc.cap
    for _ in range(args.warm):
        w = solver.step(w, p, cap)
    torch.cuda.synchronize()
    active = []
    mods = {"solver": solver, "solver_grid": solver_grid, "solver_cuda": solver_cuda}
    saved = install(mods, active)
    refreshes = ballistic = 0
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                w = solver.step(w, p, cap)
                refreshes += int(solver.step.last_gates["refreshed"])
                ballistic += int(solver.step.last_gates.get("ballistic", False))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    events = list(prof.events())
    labels = {label for _m, _f, label, _n in STAGES}
    stages = attribute(events, labels)
    device = [(e.time_range.start, e.time_range.end) for e in device_ops(events, labels)]
    busy, end = 0.0, None
    for s, e in sorted(device):   # the union of the device's busy intervals
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    n = args.steps
    total = {k: sum(v[k] for v in stages.values()) / n
             for k in ("launches", "kernels", "device_us", "copies")}
    print(f"stage_trace: {os.path.abspath(args.root)}, {args.scene} steps {args.warm + 1}-"
          f"{args.warm + n} ({refreshes} refresh steps, {ballistic} ballistic) [{card}]")
    print(f"  {wall * 1e3 / n:.3f} ms/step traced; {total['launches']:.2f} launches/step "
          f"({total['kernels']:.2f} kernels on the card), {total['device_us']:.1f} us/step "
          f"in kernels, idle share {100.0 * (1.0 - busy / (wall * 1e6)):.1f}%, "
          f"{total['copies']:.2f} copies/step")
    print(f"  {'stage':40s} {'launches':>9s} {'kernels':>8s} {'device us':>10s} "
          f"{'copies':>7s} {'host us':>9s}")
    rows = sorted(stages.items(), key=lambda kv: -kv[1]["launches"])
    for name, v in rows:
        print(f"  {name[:40]:40s} {v['launches'] / n:9.2f} {v['kernels'] / n:8.2f} "
              f"{v['device_us'] / n:10.2f} {v['copies'] / n:7.2f} {v['host_us'] / n:9.1f}")
        for k, c in v["by_kernel"].most_common(8):
            print(f"      {k:58s} {c / n:7.2f}")
    rec = {"root": os.path.abspath(args.root), "card": card, "scene": args.scene,
           "warm": args.warm, "steps": n, "refresh_steps": refreshes,
           "ballistic_steps": ballistic, "ms_per_step": wall * 1e3 / n,
           "launches_per_step": total["launches"], "kernels_per_step": total["kernels"],
           "device_us_per_step": total["device_us"], "copies_per_step": total["copies"],
           "idle_share": 1.0 - busy / (wall * 1e6),
           "stages": {name: {"launches": v["launches"] / n, "kernels": v["kernels"] / n,
                             "device_us": v["device_us"] / n, "copies": v["copies"] / n,
                             "host_us": v["host_us"] / n,
                             "by_kernel": {k: c / n for k, c in v["by_kernel"].items()}}
                      for name, v in rows}}
    line = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
