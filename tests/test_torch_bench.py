"""The port's bench (``avbd3d_tpu_torch.bench``) on the CPU.

Its regimes run here on TwoBlockDrop with windows cut to a few steps (the
kernels' plain versions, host clock): the JSON line carries every key of
the root ``bench.py`` (read from its source, which imports JAX and so is not
run) under the same name, plus the added ones; the correctness fields equal
the JAX reference's after 50 steps; the timed and checked runs end in the
same poses; a failed limit gives ``"correct": false`` and exit code 1; and
the entry point refuses to run without CUDA.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from avbd3d_tpu import solver as jsolver
from avbd3d_tpu.models import scenes as jscenes

from avbd3d_tpu_torch import bench, load_scene, solver
from avbd3d_tpu_torch.config import Capacity, SolverParams
from avbd3d_tpu_torch.convert import world_from_arrays
from avbd3d_tpu_torch.models.scenes import Scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

# Each regime cut to a few TwoBlockDrop steps, with held and reported
# windows inside the run.
SMALL = {
    "stress1000_falling": dict(window=3, windows=2, hold=(3, None), report=(1, 2)),
    "stress1000_cascade": dict(warm=1, window=2, hold=(3, None), report=(1, 2)),
    "stress1000_settled": dict(warm=2, window=2, windows=2, hold=(3, None), report=(1, 2)),
    "stress2048": dict(warm=2, window=2, windows=2, hold=(2, 4), report=(5, None)),
    "stress4096": dict(warm=2, window=2, windows=2, hold=(2, 4), report=(5, None)),
}

# bench.py's keys under ``extra``, by the regime that gives them.
EXTRA_KEYS = {
    "stress1000_falling": {"falling_steps_per_sec", "falling_vs_baseline"},
    "stress1000_cascade": {"cascade_steps_per_sec"},
    "stress1000_settled": {"settled_median_steps_per_sec", "settled_median_vs_baseline",
                           "block_steps", "trials", "max_penetration", "active_manifolds",
                           "active_contacts", "overflow"},
    "stress2048": {"stress2048"},
    "stress4096": {"stress4096"},
}


def small(name: str) -> bench.Regime:
    (r,) = bench.regimes(name)
    return dataclasses.replace(r, scene="TwoBlockDrop", **SMALL[name])


def bench_py_keys() -> tuple:
    """(top-level keys, keys under ``extra``, a capacity tier's keys) of the
    root bench.py's JSON line, from its source."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def keys(d):
        return {k.value for k in d.keys}

    result = next(n.value for n in ast.walk(funcs["main"]) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "result")
    extra = next(v for k, v in zip(result.keys, result.values) if k.value == "extra")
    tier = next(n.value for n in ast.walk(funcs["_bench_capacity"])
                if isinstance(n, ast.Return))
    return keys(result), keys(extra), keys(tier)


def test_extra_keys_cover_bench_py():
    # bench.py adds its capacity tiers to ``extra`` under name.lower().
    _top, extra, _tier = bench_py_keys()
    assert set().union(*EXTRA_KEYS.values()) | {"device"} == extra | {"stress2048", "stress4096"}


@pytest.mark.parametrize("name", [r.name for r in bench.REGIMES])
def test_regime_gives_bench_py_keys(name, monkeypatch):
    """Each regime alone (``--regime``): bench.py's keys for it under the
    same names, the added fields, its counts and checks.  The traced
    window is stubbed here (test_traced_window_on_cpu runs it)."""
    monkeypatch.setattr(bench, "traced_window", lambda w, p, c, steps: {"steps": steps})
    top, _extra, tier = bench_py_keys()
    line = bench.measure((small(name),), "cpu", "cpu", 0.0, False)
    assert top <= set(line) and line["correct"] and line["failed"] == []
    assert line["metric"] == ("stress1000_settled_steps_per_sec"
                              if name == "stress1000_settled" else f"{name}_steps_per_sec")
    assert line["value"] == line["extra"]["regimes"][name]["best"]
    assert {"baseline_source", "quick"} <= set(line)
    extra = line["extra"]
    assert extra["device"] == "cpu" and "build_s" in extra
    assert EXTRA_KEYS[name] <= set(extra)
    if name in ("stress2048", "stress4096"):
        assert tier | {"runs_steps_per_sec", "median_steps_per_sec"} <= set(extra[name])
        assert len(extra[name]["runs_steps_per_sec"]) == 2
    if name == "stress1000_settled":
        assert len(extra["settled_block_steps_per_sec"]) == 2
        assert {"sanitized", "settled_quartiles_steps_per_sec"} <= set(extra)

    r = extra["regimes"][name]
    counts = r["counts"]
    steps = SMALL[name].get("windows", 1) * SMALL[name]["window"]
    assert counts["steps"] == steps and counts["paths"] == {"fused": steps}
    assert counts["host_reads_per_step"] == 1.0
    assert sum(counts["refresh_steps_by_window"]) == counts["refresh_steps"]
    assert len(counts["refresh_steps_by_window"]) == SMALL[name].get("windows", 1)
    # The kernels' plain versions run on the CPU: nothing launches.
    assert set(counts["launches"].values()) == {0}
    checks = r["checks"]
    assert checks["poses_identical"] and checks["finite"] and checks["sanitized"] == 0.0
    assert "held" in checks and checks["held"]["limit"] == bench.PEN_LIMIT
    assert extra["traced"] == {"TwoBlockDrop": {"steps": bench.TRACE_STEPS}}
    json.dumps(line)


def test_traced_window_on_cpu():
    """The traced window from a state: the same step untraced and traced
    (host clock), its device figures "not measured" without a card."""
    sc = load_scene("TwoBlockDrop", device="cpu")
    w = solver.run_steps(sc.world, sc.params, sc.cap, 2)
    out = bench.traced_window(w, sc.params, sc.cap, 1)
    assert out["from_step"] == 2 and out["steps"] == 1
    assert out["ms_per_step_untraced"] > 0.0 and out["ms_per_step_traced"] > 0.0
    for key in ("device_us_per_step", "busy_share", "launches_per_step", "top_kernels"):
        assert out[key] == "not measured"


def test_quick_and_single_regime_selection():
    assert [r.name for r in bench.regimes("stress4096")] == ["stress4096"]
    quick = {r.name: r for r in bench.regimes(quick=True)}
    assert quick["stress1000_falling"].windows == 1
    assert (quick["stress1000_settled"].window, quick["stress1000_settled"].windows) == (200, 1)
    assert (quick["stress4096"].warm, quick["stress4096"].window,
            quick["stress4096"].windows) == (200, 100, 1)
    full = {r.name: r for r in bench.regimes()}
    assert (full["stress1000_settled"].steps, full["stress2048"].steps,
            full["stress4096"].steps) == (5700, 1100, 1200)
    with pytest.raises(KeyError):
        bench.regimes("stress9999")


def test_correctness_fields_match_reference():
    """50 TwoBlockDrop steps in the configuration of
    test_torch_parity_step.py::test_lockstep_50_steps_two_block_drop
    (lhs_rebuild_every=1, no ballistic path, backend "pallas") through the
    bench and through the reference: counts identical, max penetration
    within that test's 2e-3 m (f32 op-order drift through contact onset)."""
    sc = jscenes.load_scene("TwoBlockDrop")
    params = sc.params.replace(lhs_rebuild_every=1, ballistic=False)
    cap = sc.cap.replace(backend="pallas")
    jw = sc.world
    world = world_from_arrays(jax.device_get(dataclasses.asdict(jw)), "cpu")
    scene = Scene("TwoBlockDrop", world, SolverParams(**dataclasses.asdict(params)),
                  Capacity(**dataclasses.asdict(cap)), sc.n_real)
    regime = bench.Regime("lockstep", "TwoBlockDrop", 0, 50, 1, hold=(1, None))
    result, _end = bench.run_regime(regime, "cpu", scene)
    for _ in range(50):
        jw = jsolver.step(jw, params, cap)
    want = np.asarray(jw.diagnostics.vec)
    got = result["final"]
    assert result["failed"] == [] and result["checks"]["poses_identical"]
    assert got["step"] == 50
    assert got["active_manifolds"] == int(want[6]) and got["active_contacts"] == int(want[5])
    assert got["overflow"] == int(want[9]) + int(want[10]) and got["sanitized"] == int(want[8])
    assert got["active_contacts"] > 0
    assert abs(got["max_penetration"] - float(want[0])) < 2e-3


def test_timed_and_checked_runs_end_in_identical_poses():
    """The falling regime's two timed runs and its checked run end in the
    same poses as a plain ``run_steps`` from the built scene, and the
    comparison sees a one-ulp change."""
    regime = small("stress1000_falling")
    scene = load_scene("TwoBlockDrop", device="cpu")
    result, (end, p, c) = bench.run_regime(regime, "cpu", scene)
    assert result["checks"]["poses_identical"]
    plain = solver.run_steps(scene.world, p, c, regime.steps)
    assert bench.same_poses(end, plain)
    pos = plain.bodies.pos.clone()
    pos[1, 0, 1] = torch.nextafter(pos[1, 0, 1], torch.tensor(np.inf, dtype=pos.dtype))
    assert not bench.same_poses(end, plain.replace(bodies=plain.bodies.replace(pos=pos)))


def test_failed_limit_gives_correct_false_and_exit_1(monkeypatch, capsys):
    """A penetration limit below the run's penetration fails the run: the
    JSON line says ``"correct": false`` and names the check, exit code 1."""
    monkeypatch.setattr(bench, "PEN_LIMIT", -1.0)
    monkeypatch.setattr(bench, "traced_window", lambda w, p, c, steps: {"steps": steps})
    line = bench.measure((small("stress1000_cascade"),), "cpu", "cpu", 0.0, False)
    capsys.readouterr()
    assert bench.finish(line) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is False
    assert any("max penetration" in f and "held steps 3-3" in f for f in out["failed"])


def test_planned_launches_on_the_card():
    """What the bench holds the card's counters to: K1 a fused contact
    step, K2 a ballistic one, K5 once and K6 five times a Stress4096 grid
    step; on the CPU nothing."""
    s4096 = load_scene("Stress4096", device="cpu")
    s1000 = load_scene("Stress1000", device="cpu")
    tally = bench.Tally()
    tally.paths.update(fused=10, grid=7)
    tally.ballistic.update(fused=4)
    tally.grid_variants.update({(True, True): 3, (False, False): 4})
    plan = bench.planned_launches(tally, s4096.params, s4096.cap, cuda=True)
    assert plan == {"step_kernel": 6, "control_lanes": 4, "collide_and_init": 0,
                    "solve_loop": 0, "bp_probe": 0, "collide_grid": 7, "iterblock_grid": 35}
    assert set(bench.planned_launches(tally, s1000.params, s1000.cap, cuda=False).values()) == {0}


def test_bench_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "avbd3d_tpu_torch.bench", "--quick"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA is not available" in proc.stderr
