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
  idle gaps                    (the longest stretches between device
                                operations, each named by the host
                                operation or the span of
                                ``utils/host_spans`` running when it
                                began)

with the card's name and power limit.  The same steps from the same state
are timed once more without the profiler (host clock around a
synchronize), so the table also says what the tracing costs.  With
``--device cpu`` only the host half exists, and the table says so.
On the card the profiler session opens with ``prime``'s launches, which no
step makes, and the table leaves them out: the H100's profiler drops one of
the first records of the port's kernels in a session.  ``trace`` is the
same measurement from a given state with nothing printed (the traced
window of ``avbd3d_tpu_torch.bench``).  ``utils/profile_cuda.py``
is the other profiler: it times K3 and K4 alone with CUDA events.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time

import torch

from .. import load_scene, run_steps, solver_cuda
from . import host_spans

TOP = 12
TOP_GAPS = 5
BETWEEN_OPS = "python (between ops)"   # a gap that began outside every traced host op
WINDOW = "profile_phases.window"       # the host range of the traced block


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


def idle_gaps(device, host, top: int = TOP_GAPS) -> dict:
    """The card's idle stretches in a trace, each labelled by what the host
    was doing when it began.

    ``device``: (start_us, end_us) of every device operation (kernels,
    copies); ``host``: (name, start_us, end_us) of the host operations
    (operators and runtime calls, nested as the profiler records them).
    A gap is a stretch between two device operations in which none ran;
    its label is the innermost host operation running at the gap's first
    instant (a span of ``host_spans`` among them, inside ``trace``), or
    BETWEEN_OPS where none was.  Returns ``idle_us`` (all gaps summed),
    ``between_ops_us`` (those labelled BETWEEN_OPS) and ``gaps`` (the
    ``top`` longest: us, start_us, host_op)."""
    gaps, end = [], None
    for s, e in sorted(device):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    labels, stack, i = {}, [], 0
    ops = sorted(host, key=lambda h: (h[1], -h[2]))
    for t, _ in gaps:
        while i < len(ops) and ops[i][1] <= t:
            while stack and stack[-1][2] < ops[i][1]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        labels[t] = stack[-1][0] if stack else BETWEEN_OPS
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"idle_us": sum(e - s for s, e in gaps),
            "between_ops_us": sum(e - s for s, e in gaps if labels[s] == BETWEEN_OPS),
            "gaps": [{"us": e - s, "start_us": s, "host_op": labels[s]} for s, e in longest]}


def _timed_block(w, p, c, steps: int, cuda: bool):
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = run_steps(w, p, c, steps)
    if cuda:
        torch.cuda.synchronize()
    return w, time.perf_counter() - t0


def prime(w, p) -> None:
    """Two launches of K7 (``solver_cuda.bp_probe`` on ``w``, which no step
    launches), each synchronized, its launch counter left as it was: on
    the H100 the profiler drops one of the first records of the port's
    kernels in a session, whatever torch ran before it, so a session opens
    with these and leaves them out (as ``chip_smoke.block_kernels`` does)."""
    launches = solver_cuda.bp_probe.launches
    for _ in range(2):
        solver_cuda.bp_probe(w.bp.nb, w.bodies, p)
        torch.cuda.synchronize()
    solver_cuda.bp_probe.launches = launches


def _summed(events, value) -> list:
    """[(name, summed ``value(e)``, count)] of ``events`` by name, largest
    first."""
    total, count = {}, {}
    for e in events:
        total[e.key] = total.get(e.key, 0.0) + value(e)
        count[e.key] = count.get(e.key, 0) + 1
    return sorted(((k, total[k], count[k]) for k in total), key=lambda r: -r[1])


def _window_events(events) -> list:
    """The events that began at or after the start of the WINDOW range,
    without it: the traced block's own (what ran before it, such as
    ``prime``'s synchronized launches, is left out)."""
    start = min((e.time_range.start for e in events if e.name == WINDOW), default=-math.inf)
    return [e for e in events if e.name != WINDOW and e.time_range.start >= start]


def trace(w, p, c, steps: int) -> dict:
    """``steps`` steps from ``w``, once untimed by the profiler and once
    under ``torch.profiler`` from the same state, so both blocks do the
    same work; prints nothing.  On the card the session opens with
    ``prime``, whose records every figure leaves out.  Inside the traced
    block each span of ``host_spans`` is also a profiler range
    (``host_spans.PREFIX`` + its name), which labels the idle gaps; the
    range's mirror on the device's timeline is no device operation and is
    left out of every device figure.  Returns ``wall_s`` and ``untraced_s``
    (the block with and without the profiler), ``device_us`` (summed kernel
    time; 0.0 when the trace holds none), ``launches`` (kernels traced on
    the card), ``busy`` (device_us / wall, None without device time),
    ``kernels`` and ``operators`` ([(name, self us, count)], largest first;
    the spans' ranges among the operators), ``gaps`` (``idle_gaps`` of the
    traced block, and ``unspanned``: the same gaps labelled without the
    spans' ranges, as the host ops alone name them; None without device
    time) and ``span_mirrors`` (the device-side span records left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    cuda = w.bodies.pos.device.type == "cuda"
    _, untraced = _timed_block(w, p, c, steps, cuda)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=activities) as prof:
        if cuda:
            prime(w, p)
        with record_function(WINDOW), host_spans.traced(record_function):
            _, wall = _timed_block(w, p, c, steps, cuda)
    events = _window_events(prof.events())
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    device = [e for e in on_device if not e.name.startswith(host_spans.PREFIX)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    kernels = [r for r in _summed(device, device_time_us) if r[1] > 0.0]
    operators = _summed(host, lambda e: float(e.self_cpu_time_total))
    device_us = sum(r[1] for r in kernels)
    launches = sum(r[2] for r in kernels if not r[0].startswith(("Memcpy", "Memset")))
    busy = device_us / (wall * 1e6) if device_us > 0.0 else None
    gaps = None
    if device_us > 0.0:
        ops = [(e.name, e.time_range.start, e.time_range.end) for e in host if not e.is_async]
        on_card = [(e.time_range.start, e.time_range.end) for e in device if not e.is_async]
        gaps = idle_gaps(on_card, ops)
        gaps["unspanned"] = idle_gaps(
            on_card, [o for o in ops if not o[0].startswith(host_spans.PREFIX)])
    return {"wall_s": wall, "untraced_s": untraced, "device_us": device_us,
            "launches": launches, "busy": busy, "kernels": kernels, "operators": operators,
            "gaps": gaps,
            "span_mirrors": len(on_device) - len(device)}


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
        print(f"  {'longest idle gaps, by the host op running at their start':58s} "
              f"{'us':>10s}")
        for g in r["gaps"]["gaps"]:
            print(f"  {g['host_op'][:58]:58s} {g['us']:10.2f}")
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
