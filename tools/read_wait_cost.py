"""The cost of timing the step's host work, in one process on the card.

    python tools/read_wait_cost.py [--scene Stress1000] [--warm 700] [--window 1000]
        [--pairs 3] [--sides none,wrap,wall,cpu,rusage,nospans]

Builds the kernels, steps ``--scene`` ``--warm`` steps, then runs
``--pairs`` rounds of windows of ``--window`` steps, each window from where
the last one ended, one window a side in a round, the order rotated each
round: ``none`` (the reads untimed; the host spans, ``utils.host_spans``,
recording as they always do), ``wrap`` (``Tensor.cpu`` replaced by a
Python function that only calls it), ``wall`` (``bench.ReadWait``, which
reads ``time.perf_counter`` around the read), ``cpu`` (also
``time.process_time`` around it), ``rusage`` (``getrusage`` around it) and
``nospans`` (the host spans' functions replaced by ones that record
nothing and read no clock: ``none`` less ``nospans`` is what the spans
cost, but the calls themselves).  One process runs every side, so the
pace a process keeps of its own (PERF.md section 7) is the same on each.
The last line is one JSON object: the card's name and power limit, each
side's us a step by window, their medians and each side's cost a step
against ``none``, each round's ``none`` less ``nospans`` with their median
and range, the spans recorded a step, the wall us a step inside the
reads, and the cost of one ``time.process_time``, ``getrusage``,
``time.perf_counter`` and ``time.perf_counter_ns`` call, of a step's
chain of spans (``step_chain``) and of a launch wrapper's spans around an
empty call (``spanned_launch`` against ``bare_launch``), with the spans'
cost a step they give (``direct_cost_us_per_step``: the chain and the
launches a step the registry counted), which the windows' noise does not
hide.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import resource
import statistics
import sys
import time
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from avbd3d_tpu_torch import bench, kernels, load_scene, solver  # noqa: E402
from avbd3d_tpu_torch.utils import host_spans, profile_phases  # noqa: E402


def call_us(fn, n: int = 20000) -> float:
    return 1e6 * min(timeit.repeat(fn, number=n, repeat=3)) / n


@contextlib.contextmanager
def wrapped(side: str, inside: list):
    """``Tensor.cpu`` as ``side`` has it; ``inside`` gets the wall seconds
    inside the reads where ``side`` reads a clock."""
    if side == "none":
        yield
        return
    if side == "nospans":
        with no_spans():
            yield
        return
    if side == "wall":
        wait = bench.ReadWait()
        with wait.installed():
            yield
        inside.append(wait.wall_s)
        return
    cpu, acc = torch.Tensor.cpu, [0.0]
    cpu_clock = (time.process_time if side == "cpu"
                 else lambda: resource.getrusage(resource.RUSAGE_SELF))

    def read(t, *args, **kwargs):
        if side == "wrap":
            return cpu(t, *args, **kwargs)
        t0 = time.perf_counter()
        cpu_clock()
        out = cpu(t, *args, **kwargs)
        cpu_clock()
        acc[0] += time.perf_counter() - t0
        return out

    torch.Tensor.cpu = read
    try:
        yield
    finally:
        del torch.Tensor.cpu
    if side != "wrap":
        inside.append(acc[0])


def _begin_nothing(name):
    return 0


def _end_nothing(name, t0):
    return 0


def _switch_nothing(done, t0, then):
    return 0


def _call_nothing(kid, t0, entry, *args):
    return entry(*args)


_SPAN_FUNCTIONS = ("begin", "end", "switch", "call")


@contextlib.contextmanager
def no_spans():
    """``host_spans``' functions replaced by ones that record nothing."""
    saved = [getattr(host_spans, f) for f in _SPAN_FUNCTIONS]
    for f, fn in zip(_SPAN_FUNCTIONS, (_begin_nothing, _end_nothing, _switch_nothing,
                                       _call_nothing)):
        setattr(host_spans, f, fn)
    try:
        yield
    finally:
        for f, fn in zip(_SPAN_FUNCTIONS, saved):
            setattr(host_spans, f, fn)


def step_chain():
    """The spans a step records around its work (solver.step's)."""
    t0 = host_spans.begin("step")
    t = host_spans.begin("gates")
    t = host_spans.switch("gates", t, "read")
    t = host_spans.switch("read", t, "refresh")
    t = host_spans.switch("refresh", t, "decide")
    t = host_spans.switch("decide", t, "path")
    host_spans.end("path", t)
    host_spans.end("step", t0)


def _entry(*args):
    return 0


def spanned_launch():
    """A launch wrapper's spans around an empty ctypes stand-in."""
    host_spans.call("cost", host_spans.begin("cost.prep"), _entry, 1, 2, 3)


def bare_launch():
    _entry(1, 2, 3)


SIDES = ("none", "wrap", "wall", "cpu", "rusage", "nospans")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene", default="Stress1000")
    parser.add_argument("--warm", type=int, default=700)
    parser.add_argument("--window", type=int, default=1000)
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--sides", default=",".join(SIDES),
                        help="the sides to run, from " + ",".join(SIDES) + " (none among them)")
    args = parser.parse_args(argv)
    sides = args.sides.split(",")
    if "none" not in sides or not set(sides) <= set(SIDES):
        parser.error(f"--sides: a subset of {SIDES} with none in it")
    if not torch.cuda.is_available():
        print("read_wait_cost: CUDA is not available", file=sys.stderr)
        return 2
    kernels.build()
    scene = load_scene(args.scene, device="cuda")
    p, c = scene.params, scene.cap
    w = solver.run_steps(scene.world, p, c, args.warm)
    torch.cuda.synchronize()
    us = {side: [] for side in sides}
    inside = {side: [] for side in sides}
    host_spans.reset()
    for k in range(args.pairs):
        for i in range(len(sides)):
            side = sides[(i + k) % len(sides)]
            t0 = time.perf_counter()
            with wrapped(side, inside[side]):
                for _ in range(args.window):
                    w = solver.step(w, p, c)
                torch.cuda.synchronize()
            us[side].append(1e6 * (time.perf_counter() - t0) / args.window)
    recorded = host_spans.snapshot()
    spanned_steps = args.window * args.pairs * (len(sides) - ("nospans" in sides))
    med = {side: statistics.median(xs) for side, xs in us.items()}
    line = {"card": profile_phases.card_line(), "scene": args.scene,
            "warm": args.warm, "window": args.window, "pairs": args.pairs,
            "us_per_step": us, "median_us_per_step": med,
            "cost_us_per_step": {s: med[s] - med["none"] for s in sides},
            "inside_reads_us_per_step": {
                s: 1e6 * statistics.median(v) / args.window
                for s, v in inside.items() if v},
            "spans_per_step": sum(n for _ns, n in recorded.values()) / spanned_steps,
            "process_time_us": call_us(time.process_time),
            "getrusage_us": call_us(lambda: resource.getrusage(resource.RUSAGE_SELF)),
            "perf_counter_us": call_us(time.perf_counter),
            "perf_counter_ns_us": call_us(time.perf_counter_ns),
            "step_chain_us": call_us(step_chain), "spanned_launch_us": call_us(spanned_launch),
            "bare_launch_us": call_us(bare_launch)}
    launches = sum(n for k, (_ns, n) in recorded.items() if k.endswith(".call")) / spanned_steps
    line["launches_per_step"] = launches
    line["direct_cost_us_per_step"] = line["step_chain_us"] + launches * (
        line["spanned_launch_us"] - line["bare_launch_us"])
    host_spans.reset()
    if "nospans" in sides:
        diffs = [a - b for a, b in zip(us["none"], us["nospans"])]
        line["spans_cost_us_per_step"] = {"rounds": diffs, "median": statistics.median(diffs),
                                          "range": [min(diffs), max(diffs)]}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
