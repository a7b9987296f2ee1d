"""The port's measurement entry point: ``bench.py``'s regimes on the card.

    python -m avbd3d_tpu_torch.bench [--regime NAME] [--quick]

The counterpart of the repository's ``bench.py`` (which times the JAX
package) and of the reference's ``profile_phases.bench``.  It runs
``bench.py``'s regimes through the port's own entry points
(``load_scene(..., device="cuda")``, ``solver.step``), checks every run's
output, and prints ONE JSON line, last:

  {"metric": ..., "value": ..., "unit": "steps/sec", "vs_baseline": ...,
   "baseline_source": ..., "correct": true, "failed": [], "quick": false,
   "extra": {...}}

with ``bench.py``'s keys under the same names and meanings (``value`` the
settled best; under ``extra`` ``device``, ``settled_median_steps_per_sec``,
``falling_steps_per_sec``, ``cascade_steps_per_sec``, ``block_steps``,
``trials``, ``max_penetration``, ``active_manifolds``, ``active_contacts``,
``overflow``, ``stress2048`` / ``stress4096`` ...).  ``device`` is the
card's name and power limit as nvidia-smi gives them.  Added: ``build_s``
(the kernels' build, set-up time), ``sanitized``, every run's and block's
raw steps/s with the median and quartiles, and under ``extra.regimes`` each
regime's counts and checks and under ``extra.traced`` the traced window of
each scene.

Regimes (``REGIMES``; ``--regime`` runs one alone, whose best steps/s is
then the headline):

  stress1000_falling   steps 0-300 from the built scene, 2 runs
  stress1000_cascade   steps 100-300 (the landing cascade alone)
  stress1000_settled   settle to step 700, then TRIALS blocks of BLOCK steps
  stress2048           700 warm steps (fused path), then 2 x 200 timed
  stress4096           800 warm steps (grid tier), then 2 x 200 timed

``--quick`` (``QUICK``, for chip_smoke.py): one falling run, one settled
block of 200 steps, the capacity tiers at 200 warm steps and 1 x 100 timed.

Timing: a host clock around windows that end in ``torch.cuda.synchronize()``;
the bench loops over ``solver.step`` itself and tallies each step's path
and gates (``step.last_path``, ``step.last_gates``) without a device read.
Before the first window the kernels are built and every scene takes two
untimed steps (the built scene's first step is a contact step, its second
a ballistic one on the fused path).

Correctness, enforced: each regime is run a second time, untimed, from the
same state with every step's diagnostics kept, and must end in the timed
run's poses bit for bit.  Held at every step: sanitized 0, pair and degree
overflow 0, finite poses; max penetration below PEN_LIMIT over the
regime's ``hold`` steps (Stress1000 from step 301, Stress2048 401-600,
Stress4096 901-1000); its ``report`` steps are reported only.  The counts
are held to what the code promises: one host read a step, K1 once a fused
contact step, K2 once a ballistic step, K5 once and K6 as ``grid_specs``
plans (5 at Stress4096) a grid step, K3, K4 and K7 never.  A failed check
prints the JSON line with ``"correct": false`` and the checks named in
``failed``, and the bench exits 1.

A traced window, apart from the timed ones: 50 steps of each scene from its
last regime's end state through ``utils/profile_phases.trace`` (device us a
step, busy share, launches a step, the top 5 kernels, and the same window
untraced beside it: the tracing cost).

Without CUDA the bench exits 2 and prints no JSON.  The regime functions
take an explicit device, so the tests drive them on the CPU at a small
size; the entry point runs only on the card, and nothing on its path falls
back to a plain kernel version.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from . import kernels, load_scene, solver, solver_cuda, solver_grid
from .utils import profile_phases

# The C++ reference on one Xeon thread (BASELINE.md:37-38: Stress1000,
# 300-step falling window 44.1, settled 600-step run 19.9; BASELINE.md:70-74,
# 80-81: the capacity-scaling scenes' settled best 100-step block), as
# bench.py:35-40 records them.
BASELINE_SETTLED = 19.9
BASELINE_FALLING = 44.1
BASELINE_STRESS = {"Stress2048": 5.93, "Stress4096": 2.87}
BASELINE_SOURCE = ("the C++ reference on one Xeon thread (BASELINE.md:37-38, 70-74), "
                   "not a GPU")
BLOCK = 1000
TRIALS = 5
# chip_smoke.py's bound: max penetration at every held step.
PEN_LIMIT = 0.01
TRACE_STEPS = 50
TOP_KERNELS = 5
NAME_CHARS = 100     # a traced kernel's name, cut (torch's templates run to 1000)


@dataclasses.dataclass(frozen=True)
class Regime:
    """One regime of ``bench.py``: ``warm`` untimed steps from the built
    scene, then ``windows`` timed windows of ``window`` steps, each from
    the warm state when ``restart`` (the falling regime's runs), else one
    after the other (blocks).  ``hold``: the 1-based steps (first, last;
    last None for the end of the run) at which max penetration must stay
    below PEN_LIMIT; ``report``: steps whose max penetration is reported,
    not held.  ``baseline``: the C++ reference's steps/s (None: none)."""

    name: str
    scene: str
    warm: int
    window: int
    windows: int
    restart: bool = False
    hold: tuple | None = None
    report: tuple | None = None
    baseline: float | None = None

    @property
    def steps(self) -> int:
        """Steps from the built scene to the end of the last window."""
        return self.warm + self.window * (1 if self.restart else self.windows)


REGIMES = (
    Regime("stress1000_falling", "Stress1000", 0, 300, 2, restart=True, hold=(301, None),
           report=(1, 300), baseline=BASELINE_FALLING),
    Regime("stress1000_cascade", "Stress1000", 100, 200, 1, hold=(301, None), report=(1, 300)),
    Regime("stress1000_settled", "Stress1000", 700, BLOCK, TRIALS, hold=(301, None),
           report=(1, 300), baseline=BASELINE_SETTLED),
    Regime("stress2048", "Stress2048", 700, 200, 2, hold=(401, 600), report=(601, None),
           baseline=BASELINE_STRESS["Stress2048"]),
    Regime("stress4096", "Stress4096", 800, 200, 2, hold=(901, 1000), report=(1001, None),
           baseline=BASELINE_STRESS["Stress4096"]),
)
QUICK = {"stress1000_falling": {"windows": 1}, "stress1000_settled": {"window": 200, "windows": 1},
         "stress2048": {"warm": 200, "window": 100, "windows": 1},
         "stress4096": {"warm": 200, "window": 100, "windows": 1}}


def regimes(name: str | None = None, quick: bool = False) -> tuple:
    """``REGIMES`` (or the one named), cut to ``QUICK``'s windows."""
    out = tuple(r for r in REGIMES if name in (None, r.name))
    if not out:
        raise KeyError(f"unknown regime {name!r}; available: {[r.name for r in REGIMES]}")
    if quick:
        out = tuple(dataclasses.replace(r, **QUICK.get(r.name, {})) for r in out)
    return out


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Tally:
    """Paths and gates of the steps it runs, from ``step.last_path`` and
    ``step.last_gates`` (no device read)."""

    def __init__(self):
        self.paths = collections.Counter()
        self.ballistic = collections.Counter()    # by path
        self.refreshed = 0
        self.grid_variants = collections.Counter()   # (stale_ok, calm) of grid steps

    def run(self, w, p, c, n: int):
        step = solver.step
        for _ in range(n):
            w = step(w, p, c)
            path, g = step.last_path, step.last_gates
            self.paths[path] += 1
            self.refreshed += g["refreshed"]
            if g.get("ballistic"):
                self.ballistic[path] += 1
            elif path == "grid":
                self.grid_variants[(g["stale_ok"], g["calm"])] += 1
        return w


def launch_counts() -> dict:
    return {"step_kernel": solver_cuda.step_kernel.launches,
            "control_lanes": solver_cuda.control_lanes.launches,
            "collide_and_init": solver_cuda.collide_and_init.launches,
            "solve_loop": solver_cuda.solve_loop.launches,
            "bp_probe": solver_cuda.bp_probe.launches,
            "collide_grid": solver_grid.collide_grid.launches,
            "iterblock_grid": solver_grid.iterblock_grid.launches}


def reset_counts() -> None:
    solver_cuda.reset_launch_counts()
    solver_grid.reset_launch_counts()
    solver.step.host_reads = 0


def planned_launches(tally: Tally, p, c, cuda: bool) -> dict:
    """The launches the code promises for the tallied steps: K1 once a
    fused contact step; K2 once a fused ballistic step and once a portable
    step; K5 once and K6 as ``grid_specs`` plans for the step's variant a
    grid step; K3, K4, K7 never.  On the CPU the plain versions run and
    nothing launches."""
    fused, grid = tally.paths["fused"], tally.paths["grid"]
    k6 = sum(n * len(solver_grid.grid_specs(p, *solver_cuda.select_variant(p, stale, calm),
                                            c.grid_residency))
             for (stale, calm), n in tally.grid_variants.items())
    plan = {"step_kernel": fused - tally.ballistic["fused"],
            "control_lanes": tally.ballistic["fused"] + tally.paths["xla"],
            "collide_and_init": 0, "solve_loop": 0, "bp_probe": 0,
            "collide_grid": grid, "iterblock_grid": k6}
    return plan if cuda else dict.fromkeys(plan, 0)


def checked_run(w, p, c, n: int):
    """``n`` steps from ``w`` keeping every step's 16 diagnostics lanes and
    whether its poses are finite on the device; one read at the end.
    Returns the final world and an (n, 17) array."""
    rows = torch.empty((n, 17), dtype=torch.float32, device=w.bodies.pos.device)
    for i in range(n):
        w = solver.step(w, p, c)
        b = w.bodies
        rows[i, :16] = w.diagnostics.vec
        rows[i, 16] = torch.isfinite(b.pos).all() & torch.isfinite(b.quat).all()
    return w, rows.cpu().numpy()


def same_poses(a, b) -> bool:
    return all(torch.equal(getattr(a.bodies, f), getattr(b.bodies, f))
               for f in ("pos", "quat", "linvel", "angvel"))


def _window(steps: tuple | None, total: int) -> tuple | None:
    """(first, last) clipped to a run of ``total`` steps; None if empty."""
    if steps is None:
        return None
    first, last = steps[0], min(total, steps[1] or total)
    return (first, last) if first <= last else None


def check_rows(rows: np.ndarray, regime: Regime) -> tuple:
    """The per-step limits over a checked run's rows.  Returns (checks,
    failed): ``checks`` the worst values and the held and reported
    penetration windows, ``failed`` the names of the checks not met."""
    total = rows.shape[0]
    failed = []

    def first(mask) -> int:
        return int(np.argmax(mask)) + 1

    for lane, name in ((8, "sanitized"), (9, "pair_overflow"), (10, "degree_overflow")):
        bad = rows[:, lane] != 0.0
        if bad.any():
            failed.append(f"{regime.name}: {name} {rows[:, lane].max():g} (first at step "
                          f"{first(bad)})")
    if not rows[:, 16].all():
        failed.append(f"{regime.name}: non-finite poses (first at step {first(rows[:, 16] == 0)})")
    checks = {"checked_steps": total, "max_penetration": float(rows[:, 0].max()),
              "sanitized": float(rows[:, 8].max()), "pair_overflow": float(rows[:, 9].max()),
              "degree_overflow": float(rows[:, 10].max()), "finite": bool(rows[:, 16].all())}
    held = _window(regime.hold, total)
    if held is not None:
        pen = rows[held[0] - 1:held[1], 0]
        checks["held"] = {"steps": list(held), "max_penetration": float(pen.max()),
                          "limit": PEN_LIMIT}
        if not (pen < PEN_LIMIT).all():
            failed.append(f"{regime.name}: max penetration {pen.max():.6f} >= {PEN_LIMIT} over "
                          f"held steps {held[0]}-{held[1]} (first at step "
                          f"{held[0] - 1 + first(pen >= PEN_LIMIT)})")
    shown = _window(regime.report, total)
    if shown is not None:
        checks["reported"] = {"steps": list(shown),
                              "max_penetration": float(rows[shown[0] - 1:shown[1], 0].max())}
    return checks, failed


def _spread(sps: list) -> dict:
    q1, med, q3 = np.percentile(sps, [25, 50, 75])
    return {"steps_per_sec_runs": sps, "best": max(sps), "median": float(med),
            "quartiles": [float(q1), float(q3)]}


def run_regime(regime: Regime, device, scene=None):
    """Runs ``regime`` on ``device`` (``scene``: the loaded scene, else
    ``load_scene(regime.scene, device)``), then its checked run.  Returns
    (result, (world, params, cap)) with the timed windows' end world."""
    dev = torch.device(device)
    scene = scene or load_scene(regime.scene, device=dev)
    if scene.world.bodies.pos.device.type != dev.type:
        raise ValueError(f"scene on {scene.world.bodies.pos.device}, regime asked for {dev}")
    w0, p, c = scene.world, scene.params, scene.cap

    _sync(dev)
    t0 = time.perf_counter()
    start = solver.run_steps(w0, p, c, regime.warm)
    _sync(dev)
    warm_s = time.perf_counter() - t0

    tally = Tally()
    reset_counts()
    sps, refreshes, ends, w = [], [], [], start
    for _ in range(regime.windows):
        if regime.restart:
            w = start
        before = tally.refreshed
        _sync(dev)
        t0 = time.perf_counter()
        w = tally.run(w, p, c, regime.window)
        _sync(dev)
        sps.append(regime.window / (time.perf_counter() - t0))
        refreshes.append(tally.refreshed - before)
        if regime.restart:
            ends.append(w)
    ends = ends or [w]
    launches, host_reads = launch_counts(), solver.step.host_reads
    steps = regime.window * regime.windows

    checked, rows = checked_run(w0, p, c, regime.steps)
    checks, failed = check_rows(rows, regime)
    checks["poses_identical"] = all(same_poses(e, checked) for e in ends)
    if not checks["poses_identical"]:
        failed.append(f"{regime.name}: the checked run's final poses differ from the timed run's")
    plan = planned_launches(tally, p, c, dev.type == "cuda")
    if launches != plan:
        failed.append(f"{regime.name}: launches {launches}, the code plans {plan}")
    if host_reads != steps:
        failed.append(f"{regime.name}: {host_reads} host reads in {steps} steps, one a step "
                      "expected")

    d = w.diagnostics.as_dict()
    result = {
        "scene": regime.scene, "n": w0.bodies.n, "warm_steps": regime.warm,
        "window_steps": regime.window, "windows": regime.windows,
        **_spread(sps), "warmup_wall_s": warm_s,
        "counts": {"steps": steps, "paths": dict(tally.paths),
                   "refresh_steps": tally.refreshed, "refresh_steps_by_window": refreshes,
                   "ballistic_steps": sum(tally.ballistic.values()),
                   "host_reads_per_step": host_reads / steps, "launches": launches,
                   "launches_per_step": {k: launches[k] / steps for k in (
                       "step_kernel", "control_lanes", "collide_grid", "iterblock_grid")}},
        "checks": checks,
        "final": {"step": w.step_index, "max_penetration": d["max_penetration"],
                  "active_manifolds": int(d["active_manifolds"]),
                  "active_contacts": int(d["active_contacts"]),
                  "overflow": int(d["pair_overflow"]) + int(d["degree_overflow"]),
                  "sanitized": int(d["sanitized"])},
        "failed": failed,
    }
    if regime.baseline:
        result["vs_baseline"] = result["best"] / regime.baseline
    return result, (w, p, c)


def traced_window(w, p, c, steps: int) -> dict:
    """``profile_phases.trace`` of ``steps`` steps from ``w``, in the
    bench's units; device figures "not measured" where the trace holds no
    device time (the CPU, or a card the profiler cannot trace)."""
    r = profile_phases.trace(w, p, c, steps)
    out = {"from_step": w.step_index, "steps": steps,
           "ms_per_step_untraced": 1e3 * r["untraced_s"] / steps,
           "ms_per_step_traced": 1e3 * r["wall_s"] / steps}
    out["tracing_cost"] = out["ms_per_step_traced"] / out["ms_per_step_untraced"] - 1.0
    if r["device_us"] > 0.0:
        out.update(device_us_per_step=r["device_us"] / steps, busy_share=r["busy"],
                   launches_per_step=r["launches"] / steps,
                   top_kernels=[{"name": k[:NAME_CHARS], "us_per_step": us / steps,
                                 "count_per_step": n / steps}
                                for k, us, n in r["kernels"][:TOP_KERNELS]])
    else:
        out.update(dict.fromkeys(("device_us_per_step", "busy_share", "launches_per_step",
                                  "top_kernels"), "not measured"))
    return out


def warm_up(scenes, device) -> None:
    """Two untimed steps of each scene from its built state: the first is a
    contact step (the built control block forces it), the second a
    ballistic one on the fused path; the grid tier steps both times."""
    for name in scenes:
        sc = load_scene(name, device=device)
        solver.run_steps(sc.world, sc.params, sc.cap, 2)
    _sync(device)


def report(results: dict, device_line: str, build_s: float, quick: bool,
           traced: dict) -> dict:
    """The JSON line: ``bench.py``'s keys from the regimes that ran, the
    added fields, and ``correct`` / ``failed`` over every regime."""
    extra = {"device": device_line, "build_s": build_s}
    fall = results.get("stress1000_falling")
    if fall:
        extra.update(falling_steps_per_sec=fall["best"], falling_vs_baseline=fall["vs_baseline"],
                     falling_runs_steps_per_sec=fall["steps_per_sec_runs"],
                     falling_median_steps_per_sec=fall["median"])
    if "stress1000_cascade" in results:
        extra["cascade_steps_per_sec"] = results["stress1000_cascade"]["best"]
    settled = results.get("stress1000_settled")
    if settled:
        extra.update(
            settled_median_steps_per_sec=settled["median"],
            settled_median_vs_baseline=settled["median"] / BASELINE_SETTLED,
            settled_block_steps_per_sec=settled["steps_per_sec_runs"],
            settled_quartiles_steps_per_sec=settled["quartiles"],
            block_steps=settled["window_steps"], trials=settled["windows"],
            **{k: settled["final"][k] for k in ("max_penetration", "active_manifolds",
                                                 "active_contacts", "overflow", "sanitized")})
    for name in ("stress2048", "stress4096"):
        r = results.get(name)
        if r:
            extra[name] = {"steps_per_sec": r["best"], "vs_cxx_same_n": r["vs_baseline"],
                           "warmup_wall_s": r["warmup_wall_s"],
                           "max_penetration": r["final"]["max_penetration"],
                           "overflow": r["final"]["overflow"],
                           "sanitized": r["final"]["sanitized"],
                           "runs_steps_per_sec": r["steps_per_sec_runs"],
                           "median_steps_per_sec": r["median"]}
    extra["regimes"] = results
    extra["traced"] = traced
    head = "stress1000_settled" if settled else next(iter(results))
    failed = [f for r in results.values() for f in r["failed"]]
    return {"metric": f"{head}_steps_per_sec", "value": results[head]["best"],
            "unit": "steps/sec", "vs_baseline": results[head].get("vs_baseline"),
            "baseline_source": BASELINE_SOURCE, "correct": not failed, "failed": failed,
            "quick": quick, "extra": extra}


def finish(line: dict) -> int:
    """Prints the JSON line; the exit code: 0 when correct, else 1."""
    print(json.dumps(line), flush=True)
    return 0 if line["correct"] else 1


def measure(chosen, device, device_line: str, build_s: float, quick: bool) -> dict:
    """Every regime of ``chosen`` on ``device``, then a traced window of
    each scene from its last regime's end state; returns ``report``."""
    results, ends = {}, {}
    for r in chosen:
        t0 = time.perf_counter()
        results[r.name], ends[r.scene] = run_regime(r, device)
        log(f"{r.name}: best {results[r.name]['best']:.1f} steps/s, median "
            f"{results[r.name]['median']:.1f}, {time.perf_counter() - t0:.1f} s, "
            f"failed {results[r.name]['failed']}")
    traced = {name: traced_window(*end, TRACE_STEPS) for name, end in ends.items()}
    return report(results, device_line, build_s, quick, traced)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="bench.py's regimes on the card (the port)")
    parser.add_argument("--regime", choices=[r.name for r in REGIMES],
                        help="run this regime alone (default: all)")
    parser.add_argument("--quick", action="store_true",
                        help="shorter windows (chip_smoke.py's run)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: CUDA is not available; the bench runs on the card only", file=sys.stderr)
        return 2
    card = profile_phases.card_line()
    build_s = kernels.build().build_seconds
    chosen = regimes(args.regime, args.quick)
    warm_up(dict.fromkeys(r.scene for r in chosen), "cuda")
    log(f"{card}; kernels built in {build_s:.1f} s")
    return finish(measure(chosen, "cuda", card, build_s, args.quick))


if __name__ == "__main__":
    sys.exit(main())
