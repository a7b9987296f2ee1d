"""Where a step's time goes: a ``torch.profiler`` breakdown of N steps.

    python -m avbd3d_tpu_torch.utils.profile_phases [scene] [warm_steps] \\
        [--steps N] [--device cuda|cpu]

The counterpart of the reference's ``avbd3d_tpu/utils/profile_phases.py``
(which splits the jitted step by timing it at several iteration counts).  An
eager PyTorch step is a sequence of launches, so the split is read from a
trace instead: after ``warm_steps`` steps (default 600) of ``scene``
(default Stress1000), ``--steps`` steps (default 50) run under
``torch.profiler`` and the table shows

  device time by kernel name   (self time on the card, count per step)
  host time by operator        (self time on the CPU, count per step)
  launches per step            (kernels traced on the card / steps)
  busy share                   (summed kernel time / wall time of the block)

with the card's name and power limit.  The same steps from the same state
are timed once more without the profiler (host clock around a
synchronize), so the table also says what the tracing costs.  With
``--device cpu`` only the host half exists, and the table says so.
``trace`` is the same measurement from a given state with nothing printed
(the traced window of ``avbd3d_tpu_torch.bench``).  ``utils/profile_cuda.py``
is the other profiler: it times K3 and K4 alone with CUDA events.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

from .. import load_scene, run_steps

TOP = 12


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_time_us(event) -> float:
    """Self time on the card of a profiler row (the attribute was renamed
    from ``self_cuda_time_total`` to ``self_device_time_total``)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _timed_block(w, p, c, steps: int, cuda: bool):
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = run_steps(w, p, c, steps)
    if cuda:
        torch.cuda.synchronize()
    return w, time.perf_counter() - t0


def trace(w, p, c, steps: int) -> dict:
    """``steps`` steps from ``w``, once untimed by the profiler and once
    under ``torch.profiler`` from the same state, so both blocks do the
    same work; prints nothing.  Returns ``wall_s`` and ``untraced_s`` (the
    block with and without the profiler), ``device_us`` (summed kernel
    time; 0.0 when the trace holds none), ``launches`` (kernels traced on
    the card), ``busy`` (device_us / wall, None without device time),
    ``kernels`` and ``operators`` ([(name, self us, count)], largest
    first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = w.bodies.pos.device.type == "cuda"
    _, untraced = _timed_block(w, p, c, steps, cuda)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=activities) as prof:
        _, wall = _timed_block(w, p, c, steps, cuda)
    rows = prof.key_averages()
    kernels = sorted(((e.key, device_time_us(e), e.count) for e in rows
                      if e.device_type == DeviceType.CUDA and device_time_us(e) > 0.0),
                     key=lambda r: -r[1])
    operators = sorted(((e.key, float(e.self_cpu_time_total), e.count) for e in rows
                        if e.device_type == DeviceType.CPU),
                       key=lambda r: -r[1])
    device_us = sum(r[1] for r in kernels)
    launches = sum(r[2] for r in kernels if not r[0].startswith(("Memcpy", "Memset")))
    busy = device_us / (wall * 1e6) if device_us > 0.0 else None
    return {"wall_s": wall, "untraced_s": untraced, "device_us": device_us,
            "launches": launches, "busy": busy, "kernels": kernels, "operators": operators}


def profile(scene_name: str, warm: int, steps: int, device) -> dict:
    """``trace`` of ``steps`` steps after ``warm`` steps of ``scene_name``,
    printed as the table the module's docstring describes; returns
    ``trace``'s numbers."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    scene = load_scene(scene_name, device=dev)
    w, p, c = scene.world, scene.params, scene.cap
    w = run_steps(w, p, c, warm)
    r = trace(w, p, c, steps)
    wall, untraced, device_us, busy = r["wall_s"], r["untraced_s"], r["device_us"], r["busy"]

    where = card_line() if cuda else "cpu (the kernels' plain versions; no device half)"
    b = w.bodies
    print(f"profile_phases: scene={scene_name} warm={warm} steps={steps} N={b.n} "
          f"D={c.max_degree} iters={p.iterations} [{where}]")
    print(f"  block of {steps} steps: {wall * 1e3 / steps:.3f} ms/step traced, "
          f"{untraced * 1e3 / steps:.3f} ms/step untraced")
    if cuda and device_us > 0.0:
        print(f"  device: {device_us / steps:.1f} us/step in kernels, busy share "
              f"{100.0 * busy:.1f}% of the traced wall time, {r['launches'] / steps:.1f} "
              f"launches/step")
        print(f"  {'device time by kernel':58s} {'us/step':>10s} {'count/step':>10s}")
        for name, us, count in r["kernels"][:TOP]:
            print(f"  {name[:58]:58s} {us / steps:10.2f} {count / steps:10.2f}")
    elif cuda:
        print("  device: the trace holds no device time (no CUPTI here); device time by "
              "kernel, launches/step and busy share: not measured")
    print(f"  {'host time by operator':58s} {'us/step':>10s} {'count/step':>10s}")
    for name, us, count in r["operators"][:TOP]:
        print(f"  {name[:58]:58s} {us / steps:10.2f} {count / steps:10.2f}")
    return r


def main(argv=None):
    parser = argparse.ArgumentParser(description="torch.profiler breakdown of the port's step")
    parser.add_argument("scene", nargs="?", default="Stress1000")
    parser.add_argument("warm", nargs="?", type=int, default=600)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without CUDA) or cpu")
    args = parser.parse_args(argv)
    profile(args.scene, args.warm, args.steps, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
