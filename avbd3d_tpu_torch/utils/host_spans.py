"""Where the host's step goes: named spans on the host's clock.

The registry keeps, for each span name, the nanoseconds and the calls
recorded since the last ``reset()``; ``snapshot()`` returns them.  The
spans sit in ``solver.step`` (``step``, and inside it ``gates``, ``read``,
``refresh``, ``decide`` and ``path``, one after the other) and in every
launch wrapper of ``kernels`` (``<id>.prep``, from the wrapper's entry to
its ctypes call, and ``<id>.call``, the call, by the kernel ids of
``bench.WRAPPER_KERNELS``: ``call``).  A span nests inside the one running
when it began, so a parent less its children is the parent's own time (the
bench's ``layers.host_span_us_per_step``).

The clock is ``time.perf_counter_ns``, a wall clock: a process CPU clock
costs hundreds of microseconds a step on the card's host
(tools/read_wait_cost.py).  The spans are always on, in the explicit form::

    t = host_spans.begin("gates")
    ...
    t = host_spans.switch("gates", t, "read")   # gates ends, read begins
    ...
    host_spans.end("read", t)

and in a launch wrapper, whose two spans are kept as one record::

    t0 = host_spans.begin("K1.prep")
    ...
    code = host_spans.call("K1", t0, lib.cdll.avbd_step, ...)

While ``traced`` is open (``utils/profile_phases.trace`` opens it inside
its profiler), each span is also a ``torch.profiler.record_function``
range named ``PREFIX + name``, so a trace's idle gaps are labelled by the
span that was running; outside it a span costs its clock reads and its
sums.  This module imports no torch: ``traced`` takes the range factory.
"""

from __future__ import annotations

import contextlib
from time import perf_counter_ns

PREFIX = "avbd."

_totals = {}     # name -> [ns, calls]
_launches = {}   # kernel id -> [prep ns, call ns, calls] (``call``)
_ranges = None   # the range factory while ``traced`` is open
_open = []       # the ranges open, innermost last


def _enter(name: str) -> None:
    r = _ranges(PREFIX + name)
    r.__enter__()
    _open.append(r)


def begin(name: str) -> int:
    """Opens span ``name``; returns its start, for ``end`` or ``switch``."""
    if _ranges is not None:
        _enter(name)
    return perf_counter_ns()


def end(name: str, t0: int) -> int:
    """Closes span ``name`` begun at ``t0``; returns the time it ended."""
    t1 = perf_counter_ns()
    try:
        acc = _totals[name]
    except KeyError:
        acc = _totals[name] = [0, 0]
    acc[0] += t1 - t0
    acc[1] += 1
    if _ranges is not None:
        _open.pop().__exit__(None, None, None)
    return t1


def switch(done: str, t0: int, then: str) -> int:
    """Closes span ``done`` begun at ``t0`` and opens its sibling ``then``
    at the same instant; returns that instant, ``then``'s start."""
    t1 = perf_counter_ns()
    try:
        acc = _totals[done]
    except KeyError:
        acc = _totals[done] = [0, 0]
    acc[0] += t1 - t0
    acc[1] += 1
    if _ranges is not None:
        _open.pop().__exit__(None, None, None)
        _enter(then)
    return t1


def call(kid: str, t0: int, entry, *args):
    """``entry(*args)``, the ctypes call of a launch wrapper of kernel id
    ``kid`` whose span ``<kid>.prep`` began at ``t0`` (its entry): that span
    ends here and ``<kid>.call`` times the call.  Returns what it returns."""
    if _ranges is not None:
        _open.pop().__exit__(None, None, None)
        _enter(kid + ".call")
    t1 = perf_counter_ns()
    out = entry(*args)
    t2 = perf_counter_ns()
    try:
        acc = _launches[kid]
    except KeyError:
        acc = _launches[kid] = [0, 0, 0]
    acc[0] += t1 - t0
    acc[1] += t2 - t1
    acc[2] += 1
    if _ranges is not None:
        _open.pop().__exit__(None, None, None)
    return out


def reset() -> None:
    """Every span's sums to nothing."""
    _totals.clear()
    _launches.clear()


def snapshot() -> dict:
    """{name: (ns, calls)} recorded since the last ``reset``."""
    out = {k: (ns, n) for k, (ns, n) in _totals.items()}
    for kid, (prep, ctypes_call, n) in _launches.items():
        out[f"{kid}.prep"] = (prep, n)
        out[f"{kid}.call"] = (ctypes_call, n)
    return out


@contextlib.contextmanager
def traced(ranges):
    """Inside the block every span also opens ``ranges(PREFIX + name)``
    (``torch.profiler.record_function``); ranges a raised exception left
    open are closed when it ends."""
    global _ranges
    _ranges = ranges
    try:
        yield
    finally:
        _ranges = None
        while _open:
            _open.pop().__exit__(None, None, None)
