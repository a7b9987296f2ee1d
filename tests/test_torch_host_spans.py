"""The host spans of the port's step (avbd3d_tpu_torch/utils/host_spans.py).

On the CPU, on small scenes (the kernels' plain versions): the registry's
reset, snapshot and nesting; ``solver.step`` records one ``step`` and one
``gates``, ``read``, ``refresh``, ``decide`` and ``path`` inside it a step,
``read`` as many as ``step.host_reads``, each parent at least its
children, on the fused path and on the grid tier forced on a small
contact-only pile; the launch functions' ``<id>.prep`` and ``<id>.call``
around their ctypes call; the bench's ``layers`` carry the split a timed
step (``host_split``) and "not measured" for the allocator's counts; the
spans' profiler ranges appear only inside ``profile_phases.trace``, name
the idle gaps there, and their device-side mirrors count in no device
figure.
"""

import dataclasses
import math
import types

import torch

from avbd3d_tpu_torch import bench, kernels, load_scene, solver
from avbd3d_tpu_torch.config import SolverParams
from avbd3d_tpu_torch.convert import world_from_arrays
from avbd3d_tpu_torch.models.scenes import SceneBuilder, _ground
from avbd3d_tpu_torch.utils import host_spans, profile_phases
from avbd3d_tpu_torch.utils.profile_phases import BETWEEN_OPS

torch.set_num_threads(1)

STEP_CHILDREN = ("gates", "read", "refresh", "decide", "path")


def counts(snap: dict) -> dict:
    return {k: n for k, (_ns, n) in snap.items()}


def children_within_parents(snap: dict) -> None:
    """``step`` holds its five spans; ``gates`` its launch functions' SG /
    G, ``refresh`` R's, ``path`` every other id's."""
    ns = {k: v for k, (v, _n) in snap.items()}
    assert sum(ns.get(k, 0) for k in STEP_CHILDREN) <= ns["step"]
    ids = {k.split(".")[0] for k in ns if k.endswith((".prep", ".call"))}
    parent = {"SG": "gates", "G": "gates", "R": "refresh"}
    for owner in STEP_CHILDREN:
        inside = [ns.get(f"{i}.{part}", 0) for i in ids if parent.get(i, "path") == owner
                  for part in ("prep", "call")]
        assert sum(inside) <= ns.get(owner, 0)


def test_registry_resets_snapshots_and_nests():
    host_spans.reset()
    t0 = host_spans.begin("outer")
    t = host_spans.begin("a")
    t = host_spans.switch("a", t, "b")
    t1 = host_spans.end("b", t)
    host_spans.end("outer", t0)
    t = host_spans.begin("c")
    host_spans.end("c", t)
    t = host_spans.begin("c")
    host_spans.end("c", t)
    snap = host_spans.snapshot()
    assert counts(snap) == {"outer": 1, "a": 1, "b": 1, "c": 2}
    assert all(isinstance(ns, int) and ns >= 0 for ns, _n in snap.values())
    # a and b are siblings inside outer, b ending at the instant end returned.
    assert snap["a"][0] + snap["b"][0] <= snap["outer"][0]
    assert snap["a"][0] + snap["b"][0] <= t1 - t0
    # The snapshot is a copy: later spans do not change it.
    host_spans.end("b", host_spans.begin("b"))
    assert snap["b"][1] == 1 and host_spans.snapshot()["b"][1] == 2
    host_spans.reset()
    assert host_spans.snapshot() == {}


def test_ranges_open_only_while_traced():
    """Outside ``traced`` a span opens no range; inside it each span opens
    one named PREFIX + its name, closed in nesting order, and ranges an
    exception left open close with the block."""
    events = []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            events.append(("enter", self.name))

        def __exit__(self, *exc):
            events.append(("exit", self.name))

    host_spans.end("x", host_spans.begin("x"))
    assert events == []
    with host_spans.traced(Range):
        t0 = host_spans.begin("step")
        t = host_spans.begin("gates")
        t = host_spans.switch("gates", t, "read")
        host_spans.end("read", t)
        host_spans.end("step", t0)
        host_spans.begin("left.open")
    assert events == [("enter", "avbd.step"), ("enter", "avbd.gates"), ("exit", "avbd.gates"),
                      ("enter", "avbd.read"), ("exit", "avbd.read"), ("exit", "avbd.step"),
                      ("enter", "avbd.left.open"), ("exit", "avbd.left.open")]
    events.clear()
    host_spans.end("x", host_spans.begin("x"))
    assert events == [] and host_spans._open == []


def test_step_records_its_spans_a_step():
    sc = load_scene("TwoBlockDrop", device="cpu")
    w, p, c = sc.world, sc.params, sc.cap
    host_spans.reset()
    solver.step.host_reads = 0
    for _ in range(3):
        w = solver.step(w, p, c)
    snap = host_spans.snapshot()
    assert counts(snap) == {"step": 3, "gates": 3, "read": 3, "refresh": 3, "decide": 3,
                            "path": 3}
    assert snap["read"][1] == solver.step.host_reads
    children_within_parents(snap)


def small_pile(device="cpu"):
    """Ground and four cubes in two touching layers, padded to 1024 bodies
    (G = 8): the smallest world the grid tier takes."""
    sb = SceneBuilder()
    _ground(sb)
    for i in range(4):
        sb.add_body((1, 1, 1), 1.0, 0.5, ((i % 2) * 1.01, 0.499 + (i // 2) * 0.995, 0.0))
    arrays, params, cap, _n = sb.build(SolverParams(iterations=8), max_degree=8,
                                       cache_degree=4, min_bodies=1024)
    return world_from_arrays(arrays, device), params, cap.replace(backend="grid")


def test_grid_step_records_its_spans():
    w, p, c = small_pile()
    host_spans.reset()
    solver.step.host_reads = 0
    for _ in range(2):
        w = solver.step(w, p, c)
    assert solver.step.last_path == "grid"
    snap = host_spans.snapshot()
    assert counts(snap) == {"step": 2, "gates": 2, "read": 2, "refresh": 2, "decide": 2,
                            "path": 2}
    assert snap["read"][1] == solver.step.host_reads
    children_within_parents(snap)


def test_call_times_prep_and_call():
    """``host_spans.call``: ``<id>.prep`` from the wrapper's entry to the
    call, ``<id>.call`` the call, one record a launch in the snapshot;
    what the call returns is returned; inside ``traced`` the prep range
    closes and the call's opens around it."""
    host_spans.reset()
    seen = []

    def entry(*args):
        seen.append(args)
        return 7

    for _ in range(2):
        t0 = host_spans.begin("K1.prep")
        assert host_spans.call("K1", t0, entry, 1, "two") == 7
    assert seen == [(1, "two")] * 2
    snap = host_spans.snapshot()
    assert counts(snap) == {"K1.prep": 2, "K1.call": 2}
    assert all(ns >= 0 for ns, _n in snap.values())
    names = []

    class Range:
        def __init__(self, name):
            names.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            names.append("exit")

    with host_spans.traced(Range):
        host_spans.call("K6", host_spans.begin("K6.prep"), entry)
    assert names == ["avbd.K6.prep", "exit", "avbd.K6.call", "exit"]


def test_launchers_open_their_prep_span():
    """Every launch function of kernels.py opens ``<its id>.prep`` at its
    entry and makes its one ctypes call through ``host_spans.call`` with
    that id; the ids are bench.WRAPPER_KERNELS'."""
    import inspect

    ids = set()
    for name, fn in vars(kernels).items():
        if not name.startswith("launch_") or name == "launch_floor":
            continue
        src = inspect.getsource(fn)
        (kid,) = {line.split('"')[1].split(".")[0] for line in src.splitlines()
                  if "host_spans.begin(" in line}
        assert f'host_spans.call("{kid}", t0, lib.cdll.' in src, name
        assert src.count("lib.cdll.") == 1, name
        ids.add(kid)
    assert ids == {kid for kid, _names in bench.WRAPPER_KERNELS.values()}


def test_host_split_of_a_snapshot():
    """``bench.host_split``: us and calls a timed step by span; ``world`` is
    ``path`` less the launch functions inside it (SG and G sit in
    ``gates``, R in ``refresh``), ``step_other`` ``step`` less its five
    spans, ``loop`` the windows' wall time less ``step``."""
    ms = 1_000_000
    spans = {"step": (100 * ms, 10), "gates": (10 * ms, 10), "read": (20 * ms, 10),
             "refresh": (15 * ms, 10), "decide": (5 * ms, 10), "path": (40 * ms, 10),
             "SG.prep": (3 * ms, 10), "SG.call": (2 * ms, 10), "R.prep": (4 * ms, 4),
             "R.call": (1 * ms, 4), "K1.prep": (12 * ms, 10), "K1.call": (8 * ms, 10)}
    result = {"timed_steps": 10, "timed_s": 0.12, "windows": 2, "host_spans": spans}
    split = bench.host_split(result)
    us, calls = split["host_span_us_per_step"], split["host_span_calls_per_step"]
    assert us["step"] == 10000.0 and us["path"] == 4000.0
    assert us["world"] == 4000.0 - 1200.0 - 800.0
    assert us["step_other"] == 10000.0 - 9000.0
    assert math.isclose(us["loop"], 12000.0 - 10000.0)
    assert us["R.call"] == 100.0 and calls["R.call"] == 0.4
    assert calls["loop"] == 0.2 and calls["world"] == calls["step_other"] == 1.0
    # The grid tier's step has no ballistic or variant gates of its own,
    # but every key is there.
    result["host_spans"] = {"step": (1, 1)}
    assert set(bench.host_split(result)["host_span_us_per_step"]) == {
        "step", *STEP_CHILDREN, "world", "step_other", "loop"}


def test_span_calls_planned_from_the_launches():
    per_step = {"step_kernel": 0.5, "control_lanes": 0.5, "candidate_lists": 0.25,
                "step_gates": 1.0, "ballistic_step": 0.5, "iterblock_grid": 0}
    assert bench.span_calls_planned(per_step) == {"K1.call": 0.5, "K2.call": 0.5,
                                                  "R.call": 0.5, "SG.call": 1.0,
                                                  "BS.call": 0.5}


def test_bench_layers_carry_the_host_split(monkeypatch):
    """A CPU run's ``layers``: the split with finite us and exact calls a
    step (one a step for the step's spans, a window's share for ``loop``),
    no launch function (the plain versions run), and "not measured" for
    the allocator's counts."""
    monkeypatch.setattr(bench, "traced_window", lambda w, p, c, steps: {"steps": steps})
    (r,) = bench.regimes("stress1000_settled")
    r = dataclasses.replace(r, scene="TwoBlockDrop", warm=2, window=2, windows=3,
                            hold=(3, None), report=(1, 2))
    line = bench.measure((r,), "cpu", "cpu", 0.0, False)
    assert line["correct"] is True
    lay = line["layers"]["stress1000_settled"]
    us, calls = lay["host_span_us_per_step"], lay["host_span_calls_per_step"]
    assert set(us) == set(calls) == {"step", *STEP_CHILDREN, "world", "step_other", "loop"}
    assert all(math.isfinite(v) for v in us.values())
    assert all(us[k] > 0.0 for k in ("step", *STEP_CHILDREN))
    assert calls == {**dict.fromkeys(("step", *STEP_CHILDREN, "world", "step_other"), 1.0),
                     "loop": 0.5}
    assert us["world"] == us["path"] and us["loop"] >= 0.0
    for k in ("device_allocs_per_step", "device_frees_per_step", "alloc_retries"):
        assert lay[k] == "not measured"
    assert lay["idle_between_ops_share"] == "not measured"
    assert line["extra"]["regimes"]["stress1000_settled"]["host_spans"]["read"][1] == 6


def test_ranges_appear_only_inside_the_trace():
    """The spans' profiler ranges: none in a profile of a step outside
    ``profile_phases.trace``, one a span and step inside it."""
    sc = load_scene("TwoBlockDrop", device="cpu")
    w, p, c = sc.world, sc.params, sc.cap
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        solver.step(w, p, c)
    assert not [e.name for e in prof.events() if e.name.startswith(host_spans.PREFIX)]
    r = profile_phases.trace(w, p, c, 2)
    ranges = {k: n for k, _us, n in r["operators"] if k.startswith(host_spans.PREFIX)}
    assert ranges == {f"avbd.{k}": 2 for k in ("step", *STEP_CHILDREN)}
    assert host_spans._ranges is None and host_spans._open == []


def fake_event(name, start, end, device, us=0.0, cpu_us=0.0):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, key=name, is_async=False,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end),
        self_device_time_total=us, self_cpu_time_total=cpu_us)


def test_trace_names_gaps_by_span_and_drops_their_mirrors(monkeypatch):
    """The rows as the card gives them inside the traced block: the spans'
    ranges on the host and their mirrors on the device's timeline.  The
    mirrors count in no kernel, launch, device us or idle gap; a gap that
    begins inside a span is named by it, and ``unspanned`` names it as the
    host ops alone would."""
    window = profile_phases.WINDOW
    rows = [fake_event(window, 10.0, 60.0, False, cpu_us=20.0),
            fake_event("avbd.step", 10.5, 58.0, False, cpu_us=5.0),
            fake_event("avbd.step", 12.0, 50.0, True, us=38.0),
            fake_event("avbd.gates", 11.0, 15.0, False, cpu_us=2.0),
            fake_event("avbd.gates", 12.0, 14.0, True, us=2.0),
            fake_event("k_step_gates", 12.0, 14.0, True, us=2.0),
            fake_event("avbd.path", 16.0, 57.0, False, cpu_us=10.0),
            fake_event("avbd.path", 20.0, 50.0, True, us=30.0),
            fake_event("k_primal<512>", 20.0, 30.0, True, us=10.0),
            fake_event("k_primal<512>", 40.0, 50.0, True, us=10.0)]

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return rows

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    sc = load_scene("TwoBlockDrop", device="cpu")
    r = profile_phases.trace(sc.world, sc.params, sc.cap, 1)
    assert r["kernels"] == [("k_primal<512>", 20.0, 2), ("k_step_gates", 2.0, 1)]
    assert r["launches"] == 3 and r["device_us"] == 22.0 and r["span_mirrors"] == 3
    gaps = r["gaps"]
    assert gaps["idle_us"] == (20.0 - 14.0) + (40.0 - 30.0)
    assert {g["start_us"]: g["host_op"] for g in gaps["gaps"]} == {14.0: "avbd.gates",
                                                                    30.0: "avbd.path"}
    assert gaps["between_ops_us"] == 0.0
    assert [g["host_op"] for g in gaps["unspanned"]["gaps"]] == [BETWEEN_OPS, BETWEEN_OPS]
    assert gaps["unspanned"]["between_ops_us"] == gaps["idle_us"]

