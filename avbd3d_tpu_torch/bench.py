"""The port's measurement entry point: ``bench.py``'s regimes on the card.

    python -m avbd3d_tpu_torch.bench [--regime NAME] [--quick] [--seed N]

The counterpart of the repository's ``bench.py`` (which times the JAX
package) and of the reference's ``profile_phases.bench``.  It runs
``bench.py``'s regimes through the port's own entry points
(``load_scene(..., device="cuda")``, ``solver.step``), checks every run's
output, and prints ONE JSON line, last:

  {"metric": ..., "value": ..., "unit": "steps/sec", "vs_baseline": ...,
   "baseline_source": ..., "correct": true, "failed": [], "quick": false,
   "steps_per_sec": ..., "steps_per_sec_n": ..., "seed": 0,
   "failed_steps": 0, "steps_run": ..., "plain_check": {...},
   "layers": {...}, "extra": {...}}

with ``bench.py``'s keys under the same names and meanings (``value`` the
settled best block; under ``extra`` ``device``,
``settled_median_steps_per_sec``, ``falling_steps_per_sec``,
``cascade_steps_per_sec``, ``block_steps``, ``trials``,
``max_penetration``, ``active_manifolds``, ``active_contacts``,
``overflow``, ``stress2048`` / ``stress4096`` ...).  ``device`` is the
card's name and power limit as nvidia-smi gives them.  Added: ``build_s``
(the kernels' build, set-up time), ``sanitized``, every run's and block's
raw steps/s with the median and quartiles, under ``extra.regimes`` each
regime's counts and checks, under ``extra.traced`` each regime's traced
window, and the conditions of the run, reported and not metrics:
``extra.host`` (the CPU model, the CPUs this process may use, and for each
regime the load average before and after its timed windows, Python's
garbage collections in them, the process's CPU seconds and involuntary
context switches over them, ``getrusage``, and ``read_wait``: the count
and the wall seconds of the blocking reads and closing syncs inside them,
``ReadWait``) and ``extra.card``
(nvidia-smi's SM clock, power draw, temperature and power limit before the
first timed window and after the last of each regime, never inside one).

The benchmark's cells (BENCHMARK.json) read the added top-level keys:
``steps_per_sec`` is the headline regime's whole-window rate, all its
timed steps over all its timed windows' seconds, and ``steps_per_sec_n``
that count of steps (``value`` stays bench.py's best block);
``failed_steps`` of ``steps_run`` counts the checked steps at which any
per-step hold broke; ``plain_check`` holds each regime's card step against
the plain versions; ``layers`` gives each regime's per-layer metrics, the
windows' median and quartiles and the host's path a timed step among
them: ``host_cpu_us_per_step``, the process's CPU time less the wall time
of its blocking reads of the card, through which CUDA's default context
spins (the host's own work), and ``host_wait_us_per_step``, that wall
time (the wait).  Held beside them: the reads timed
are the step's counted reads, and the checked run synchronizes with the
card at its reads alone (torch's sync debug mode), so no wait hides in
the host's share.  The host's step split by span (``utils.host_spans``,
recorded over the timed windows): ``host_span_us_per_step`` and
``host_span_calls_per_step``, by span (``host_split``), and the caching
allocator's ``cudaMalloc`` / ``cudaFree`` calls and retries over the timed
windows (``device_allocs_per_step``, ``device_frees_per_step``,
``alloc_retries``; read before the first window and after the last, never
inside a step).

Regimes (``REGIMES``; ``--regime`` runs one alone, whose best window is
then ``value`` and whose whole-window rate ``steps_per_sec``):

  stress1000_falling   10 windows of 300 steps, each from the built scene
                       (steps 1-300 ten times): the landing
  stress1000_cascade   steps 100-300 (the landing cascade alone)
  stress1000_settled   settle to step 700, then TRIALS blocks of BLOCK steps
  stress2048           700 warm steps (fused path), then 2 x 200 timed
  stress2048_settling  700 warm steps (fused path), then 10 windows of 200,
                       each from the step-700 state (steps 701-900): a
                       settling pile whose refresh gate opens often
  stress4096           800 warm steps (grid tier), then 10 x 200 timed

``--quick`` (``QUICK``, for chip_smoke.py): one falling window, one settled
block of 200 steps, the capacity tiers (and stress2048_settling) at 200 warm
steps and 1 x 100 timed.

``--seed N`` (default 0): seed 0 runs each scene as built, the reference's
layout; N > 0 moves every dynamic body's spawn position by a seeded uniform
draw in [-SEED_AMP, SEED_AMP] per axis (``utils/jitter_probe.perturbed``)
before the warm steps.  The same seed gives the same run.

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
are held to what the code promises (``planned_launches``): one host read
a step; every kernel wrapper's launches, the stage and refresh wrappers'
among them: K1 once a fused contact step, K2 once a ballistic step, K5
once and K6 as ``grid_specs`` plans (5 at Stress4096) a grid step, SG
(``step_gates``) once a fused step, BS (``ballistic_step``) once a
ballistic one, G, PR and FN (``grid_gates`` / ``grid_predict`` /
``grid_finalize``) once a grid step, R (``candidate_lists``) once a
refreshed step, and K3, K4, K7 and P (``refresh_needed``) never.  A failed
check prints the JSON line with ``"correct": false`` and the checks named in
``failed``, and the bench exits 1.  ``failed_steps`` counts the checked
run's steps at which a per-step hold broke.

Held against the plain versions, at the start and at the end of the timed
windows and from the regime's ``plain_at`` states (the falling regime's
step 1, whose step is ballistic): the state is copied to the CPU and
stepped once there, where every kernel wrapper runs its plain PyTorch
version, and that step is compared with the card's step from the same
state.  Integer outputs must be identical (contact cache slots, counts,
feature ids, candidate lists, active manifolds and contacts, overflow and
sanitized counts, the path taken and whether the step was ballistic);
poses and velocities must agree within ``plain_tolerance`` (card against
CPU; on the CPU the two steps are the same code on the same device and
must agree bit for bit).  Every launch of a fused or grid step is a
kernel of csrc/ (K1, K2, K5, K6, the refresh and the stage kernels), so
the CPU's step is their plain versions throughout; only the host's
Python between the launches is the same code on both devices.  Beside each
comparison: a control, the card's step with its poses rounded to
CONTROL_DTYPE and back, which must fail it (held); and a witness, the
CPU's step from the same state with every dynamic pose one ulp up, against
the CPU's step (reported: how far one rounding carries in one step).

A traced window of each regime, apart from the timed ones, over the work
its timed windows do: a restarted regime's one window from its windows'
start state (the warm state), a block regime's TRACE_STEPS steps from its
end state, which continues its blocks; through
``utils/profile_phases.trace`` (its session
primed by launches no step makes, which it leaves out; device us a step,
busy and idle share, launches a step, the top 5 kernels, the port's kernels'
us and launches a step by the id of the wrapper that launched them
(``WRAPPER_KERNELS``; PERF.md section 6) beside each wrapper's calls a step
by its counter, the longest idle gaps on the card labelled by the host
operation or span running when each began, the share of the idle time no
host op or span names (``idle_between_ops_share``, beside the share the
host ops alone leave unnamed), and the same window untraced beside it:
the tracing cost); the regime's ``layers`` carry it.  End-to-end numbers
come from the untraced windows only.  Peak device memory
(``max_memory_allocated`` over the timed windows) and the world's own bytes
are reported per regime.

Without CUDA the bench exits 2 and prints no JSON.  The regime functions
take an explicit device, so the tests drive them on the CPU at a small
size; the entry point runs only on the card, and nothing on its path falls
back to a plain kernel version.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import resource
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from . import kernels, load_scene, solver, solver_cuda, solver_grid
from .ops import broadphase
from .parallel.batched import with_tensors, world_tensors
from .utils import host_spans, profile_phases
from .utils.jitter_probe import perturbed

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
# bench.py takes 5 blocks; the cell's whole-window rate takes 20 (steps
# 701-20700), whose first 5 are bench.py's (PERF.md section 2).
TRIALS = 20
# chip_smoke.py's bound: max penetration at every held step.
PEN_LIMIT = 0.01
TRACE_STEPS = 50
TOP_KERNELS = 5
NAME_CHARS = 100     # a traced kernel's name, cut (torch's templates run to 1000)
# --seed N > 0: the largest move of a dynamic body's spawn position on each
# axis (m), a small fraction of the scenes' own hash jitter (0.04 m in x and
# z, 0.25 m in y); utils/jitter_probe.py's amplitude.
SEED_AMP = 0.001
# The largest position difference allowed between one step on the card and
# the same step on the CPU through the plain versions (m; also each
# quaternion component).  PyTorch's CPU and CUDA ops round differently, and
# 20 stiff sweeps carry one rounding to a millimetre at a body: one ulp of
# input on the CPU alone moves Stress4096's step 800 by 1.4e-3 m and
# Stress1000's falling step 300, mid-landing, by 3.3e-3 m (the witness).
# The bound lies between the largest difference measured at the regimes'
# states (1.71e-3 m, Stress4096 step 800), 1.46x below it, and the control,
# the card's step rounded to CONTROL_DTYPE (1.04e-2 m at the least), 4.1x
# above it (PERF.md section 2).  It lies below the witness at falling step
# 300, where the card's step has differed by at most 4.2e-4 m: a card
# rounding that carried as far as one ulp does would fail there, and is
# read against the witness reported beside the check.  Velocities follow
# from the positions over one step: the bound over dt, twice that for
# angular velocity.
PLAIN_POS_TOL = 2.5e-3
CONTROL_DTYPE = torch.float16
# What torch's sync debug mode says at each call that synchronizes.
SYNC_WARNING = "called a synchronizing CUDA operation"
# Integer leaves that must be identical after the step, and the diagnostics
# lanes that are counts (active contacts, manifolds, sanitized, pair and
# degree overflow).  The stick latches, float comparisons at a threshold,
# are counted where they differ, not held.
PLAIN_INTS = ("contacts.other", "contacts.count", "contacts.feature",
              "bp.nb", "bp.key", "bp.thr", "bp.cand", "bp.dropped")
COUNT_LANES = {5: "active_contacts", 6: "active_manifolds", 8: "sanitized",
               9: "pair_overflow", 10: "degree_overflow"}
# The kernels of csrc/ each wrapper's entry point launches, by the id of
# PERF.md section 6 (the TPU kernel the wrapper replaces, or the XLA stage
# it ports); the keys are launch_counts' names.  Every __global__ kernel of
# csrc/ is here but k_launch_floor, a measuring tool no step launches.
# Some kernels are launched by more than one entry point (K1 shares its
# collide with K3 and K5, its sweeps with K4 and K6): a traced kernel goes
# to the one wrapper of its set that launched in the window, else to
# "unattributed".
_SWEEPS = {"k_predict", "k_geom", "k_primal", "k_dual", "k_sweeps", "k_joint_sweeps",
           "k_joint_ema", "k_final_body", "k_final_reduce"}
_COLLIDE = {"k_filter_cull", "k_collide"}
WRAPPER_KERNELS = {"step_kernel": ("K1", _COLLIDE | _SWEEPS),
                   "control_lanes": ("K2", {"k_control_lanes"}),
                   "collide_and_init": ("K3", _COLLIDE),
                   "solve_loop": ("K4", _SWEEPS),
                   "collide_grid": ("K5", _COLLIDE),
                   "iterblock_grid": ("K6", {"k_geom", "k_primal", "k_dual", "k_sweeps"}),
                   "bp_probe": ("K7", {"k_probe"}),
                   "candidate_lists": ("R", {"k_bp_tables", "k_bp_lists"}),
                   "refresh_needed": ("P", {"k_refresh_needed"}),
                   "grid_gates": ("G", {"k_grid_gates"}),
                   "grid_predict": ("PR", {"k_grid_predict"}),
                   "grid_finalize": ("FN", {"k_grid_finalize"}),
                   "step_gates": ("SG", {"k_step_gates"}),
                   "ballistic_step": ("BS", {"k_ballistic_step"})}
# The spans of solver.step a timed step reports (utils.host_spans), one after
# the other inside ``step``; the kernel ids whose launch functions run inside
# ``gates`` (SG, G) or ``refresh`` (R), all others' inside ``path``; and the
# ctypes calls a launch of a wrapper makes where it is not one (R's
# candidate_lists: k_bp_tables, then k_bp_lists).
STEP_SPANS = ("gates", "read", "refresh", "decide", "path")
OUTSIDE_PATH = frozenset({"SG", "G", "R"})
CALLS_A_LAUNCH = {"R": 2}
# The caching allocator's counters (torch.cuda.memory_stats) read before
# the first timed window and after the last.
ALLOC_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries")
# nvidia-smi's readings of the card beside each regime's timed windows.
CARD_QUERY = ("clocks.sm", "power.draw", "temperature.gpu", "power.limit")


@dataclasses.dataclass(frozen=True)
class Regime:
    """One regime of ``bench.py``: ``warm`` untimed steps from the built
    scene, then ``windows`` timed windows of ``window`` steps, each from
    the warm state when ``restart`` (the falling regime's runs), else one
    after the other (blocks).  ``hold``: the 1-based steps (first, last;
    last None for the end of the run) at which max penetration must stay
    below PEN_LIMIT; ``report``: steps whose max penetration is reported,
    not held.  ``baseline``: the C++ reference's steps/s (None: none).
    ``plain_at``: steps after the warm state, besides the windows' start
    and end, from which the plain-version check also steps."""

    name: str
    scene: str
    warm: int
    window: int
    windows: int
    restart: bool = False
    hold: tuple | None = None
    report: tuple | None = None
    baseline: float | None = None
    plain_at: tuple = ()

    @property
    def steps(self) -> int:
        """Steps from the built scene to the end of the last window."""
        return self.warm + self.window * (1 if self.restart else self.windows)

    @property
    def trace_steps(self) -> int:
        """The traced window's steps: one window when ``restart`` (from the
        warm state, the work every timed window does), else TRACE_STEPS
        from the end state (the blocks' work continued)."""
        return self.window if self.restart else TRACE_STEPS


REGIMES = (
    Regime("stress1000_falling", "Stress1000", 0, 300, 10, restart=True, hold=(301, None),
           report=(1, 300), baseline=BASELINE_FALLING, plain_at=(1,)),
    Regime("stress1000_cascade", "Stress1000", 100, 200, 1, hold=(301, None), report=(1, 300)),
    Regime("stress1000_settled", "Stress1000", 700, BLOCK, TRIALS, hold=(301, None),
           report=(1, 300), baseline=BASELINE_SETTLED),
    Regime("stress2048", "Stress2048", 700, 200, 2, hold=(401, 600), report=(601, None),
           baseline=BASELINE_STRESS["Stress2048"]),
    Regime("stress2048_settling", "Stress2048", 700, 200, 10, restart=True, hold=(401, 600),
           report=(601, None), baseline=BASELINE_STRESS["Stress2048"]),
    Regime("stress4096", "Stress4096", 800, 200, 10, hold=(901, 1000), report=(1001, None),
           baseline=BASELINE_STRESS["Stress4096"]),
)
QUICK = {"stress1000_falling": {"windows": 1}, "stress1000_settled": {"window": 200, "windows": 1},
         "stress2048": {"warm": 200, "window": 100, "windows": 1},
         "stress2048_settling": {"warm": 200, "window": 100, "windows": 1},
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
    """Every kernel wrapper's launch counter (WRAPPER_KERNELS' keys)."""
    return {"step_kernel": solver_cuda.step_kernel.launches,
            "control_lanes": solver_cuda.control_lanes.launches,
            "collide_and_init": solver_cuda.collide_and_init.launches,
            "solve_loop": solver_cuda.solve_loop.launches,
            "bp_probe": solver_cuda.bp_probe.launches,
            "collide_grid": solver_grid.collide_grid.launches,
            "iterblock_grid": solver_grid.iterblock_grid.launches,
            "candidate_lists": broadphase.candidate_lists.launches,
            "refresh_needed": broadphase.refresh_needed.launches,
            "grid_gates": solver_grid.grid_gates.launches,
            "grid_predict": solver_grid.grid_predict.launches,
            "grid_finalize": solver_grid.grid_finalize.launches,
            "step_gates": solver.step_gates.launches,
            "ballistic_step": solver.ballistic_step.launches}


def reset_counts() -> None:
    """Every counter of ``launch_counts`` and the host reads to 0."""
    solver_cuda.reset_launch_counts()
    solver_grid.reset_launch_counts()
    solver.step.host_reads = 0


def planned_launches(tally: Tally, p, c, cuda: bool) -> dict:
    """The launches the code promises for the tallied steps (``solver.step``):
    K1 once a fused contact step; K2 once a fused ballistic step and once a
    portable step; K5 once and K6 as ``grid_specs`` plans for the step's
    variant a grid step; SG (``step_gates``) once a fused or portable step;
    BS (``ballistic_step``) once a ballistic step; G, PR and FN once a grid
    step; R (``candidate_lists``) once a refreshed step (the matrix refresh;
    ``cap.bp_window`` > 0 is not planned); K3, K4, K7 and P never.  On the
    CPU the plain versions run and nothing launches."""
    fused, grid, xla = tally.paths["fused"], tally.paths["grid"], tally.paths["xla"]
    k6 = sum(n * len(solver_grid.grid_specs(p, *solver_cuda.select_variant(p, stale, calm),
                                            c.grid_residency))
             for (stale, calm), n in tally.grid_variants.items())
    plan = {"step_kernel": fused - tally.ballistic["fused"],
            "control_lanes": tally.ballistic["fused"] + xla,
            "collide_and_init": 0, "solve_loop": 0, "bp_probe": 0,
            "collide_grid": grid, "iterblock_grid": k6,
            "candidate_lists": tally.refreshed, "refresh_needed": 0,
            "grid_gates": grid, "grid_predict": grid, "grid_finalize": grid,
            "step_gates": fused + xla, "ballistic_step": sum(tally.ballistic.values())}
    return plan if cuda else dict.fromkeys(plan, 0)


class GcWatch:
    """A ``gc.callbacks`` entry: Python's garbage collections that start
    while ``on``, counted by generation, and their seconds."""

    def __init__(self):
        self.on = False
        self.collections = [0, 0, 0]
        self.seconds = 0.0
        self._t0 = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter() if self.on else None
        elif self._t0 is not None:
            self.collections[info["generation"]] += 1
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None


class ReadWait:
    """The host's blocking reads while ``installed``: every
    ``torch.Tensor.cpu`` call (the step's read of the card, one a step)
    and each call passed to ``timed`` (the windows' closing syncs), with
    their count and the wall seconds inside them.  The default CUDA context
    spins through such a read (one context, fewer than the cores), so its
    wall seconds are also the reading thread's CPU seconds spent waiting.
    Only a wall clock is read: a process CPU clock read around each read
    costs 126-490 us a step on the card (tools/read_wait_cost.py)."""

    def __init__(self):
        self.calls = 0
        self.wall_s = 0.0

    def timed(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.calls += 1
            self.wall_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def installed(self):
        cpu = torch.Tensor.cpu
        torch.Tensor.cpu = lambda t, *args, **kwargs: self.timed(cpu, t, *args, **kwargs)
        try:
            yield self
        finally:
            del torch.Tensor.cpu
            assert torch.Tensor.cpu is cpu


def card_reading() -> dict:
    """CARD_QUERY as nvidia-smi gives it, each value with its unit."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(CARD_QUERY)}",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    return dict(zip(CARD_QUERY, (v.strip() for v in out.stdout.splitlines()[0].split(","))))


def allocator_counts(device) -> dict | str:
    """ALLOC_STATS of the caching allocator on ``device`` (None for a
    counter this torch does not keep); "not measured" off the card."""
    if torch.device(device).type != "cuda":
        return "not measured"
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k) for k in ALLOC_STATS}


def host_line() -> dict:
    """The host's CPU model (/proc/cpuinfo) and the CPUs this process may
    use."""
    model = "not reported"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), model)
    except OSError:
        pass
    return {"cpu_model": model, "cpus": len(os.sched_getaffinity(0))}


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


@contextlib.contextmanager
def sync_calls(cuda: bool):
    """The calls that synchronize the host with the card inside the context
    (torch's sync debug mode warns at each), as a list of their messages
    filled when it closes; empty on the CPU."""
    found = []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    found += [str(m.message) for m in seen if SYNC_WARNING in str(m.message)]


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
    failed): ``checks`` the worst values, the held and reported
    penetration windows and ``failed_steps`` (the steps at which any
    per-step hold broke) of ``steps_run``, ``failed`` the names of the
    checks not met."""
    total = rows.shape[0]
    failed = []
    broke = (rows[:, 8] != 0.0) | (rows[:, 9] != 0.0) | (rows[:, 10] != 0.0) | (rows[:, 16] == 0)

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
        broke[held[0] - 1:held[1]] |= ~(pen < PEN_LIMIT)
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
    checks.update(failed_steps=int(broke.sum()), steps_run=total)
    return checks, failed


def to_cpu(world):
    """A copy of ``world`` on the CPU."""
    return with_tensors(world, {k: v.cpu() for k, v in world_tensors(world).items()})


def world_bytes(world) -> int:
    """The bytes of every tensor of ``world``: the state a step reads."""
    return sum(t.numel() * t.element_size() for t in world_tensors(world).values())


def plain_tolerance(dt: float) -> dict:
    """PLAIN_POS_TOL for pos and quat, over ``dt`` for linvel, twice that
    for angvel (a rotation by angle a moves a quaternion by ~a / 2)."""
    return {"pos": PLAIN_POS_TOL, "quat": PLAIN_POS_TOL, "linvel": PLAIN_POS_TOL / dt,
            "angvel": 2.0 * PLAIN_POS_TOL / dt}


def compare_plain(dev, dev_path: str, cpu, cpu_path: str, tol: dict) -> tuple:
    """One step's result ``dev`` (path ``dev_path``) against the same step
    ``cpu`` run through the plain versions.  Integer leaves (PLAIN_INTS),
    the count lanes and the path must be identical; pos, quat, linvel and
    angvel within ``tol``.  Also counted: stick latches that differ.
    Returns (record, failed)."""
    a, b = world_tensors(dev), world_tensors(cpu)
    differ = [k for k in PLAIN_INTS if not torch.equal(a[k].cpu(), b[k])]
    va, vb = a["diagnostics.vec"].cpu(), b["diagnostics.vec"]
    differ += [name for lane, name in COUNT_LANES.items() if va[lane] != vb[lane]]
    if dev_path != cpu_path:
        differ.append(f"path ({dev_path} against {cpu_path})")
    diff = {f: float((a[f"bodies.{f}"].cpu() - b[f"bodies.{f}"]).abs().max()) for f in tol}
    over = {f: d for f, d in diff.items() if not d <= tol[f]}
    failed = []
    if differ:
        failed.append(f"plain-version check: integer outputs differ: {differ}")
    if over:
        failed.append(f"plain-version check: {over} beyond the tolerance {tol}")
    return {"integers_identical": not differ, "differ": differ, "max_abs_diff": diff,
            "tolerance": tol, "path": dev_path, "ok": not failed,
            "stick_latches_differ": int((a["contacts.stick"].cpu() != b["contacts.stick"]).sum())
            }, failed


def rounded(world, dtype):
    """``world`` with every dynamic body's pose and velocity rounded to
    ``dtype`` and back (the padding, parked at 1e6 m, would overflow)."""
    b = world.bodies
    return world.replace(bodies=b.replace(**{
        f: torch.where(b.dynamic[None], getattr(b, f).to(dtype).to(torch.float32), getattr(b, f))
        for f in ("pos", "quat", "linvel", "angvel")}))


def one_ulp_up(world):
    """``world`` with every dynamic body's position and quaternion one ulp up."""
    b, up = world.bodies, torch.tensor(np.inf)
    nudged = {f: torch.where(b.dynamic[None], torch.nextafter(getattr(b, f), up), getattr(b, f))
              for f in ("pos", "quat")}
    return world.replace(bodies=b.replace(**nudged))


def plain_check(state, p, c) -> tuple:
    """One step from ``state`` where it lies and from its copy on the CPU
    (every kernel wrapper takes its plain version there), compared by
    ``compare_plain``: within ``plain_tolerance`` from the card, bit for
    bit on the CPU.  Held beside it: the card's step rounded to
    CONTROL_DTYPE must fail the comparison (``control``).  Reported: the
    CPU's step from ``state`` one ulp up (``one_ulp_up``) against the CPU's
    step (``one_ulp``).  Returns (record with the CPU step's seconds and
    whether the step was ballistic, failed)."""
    dev = solver.step(state, p, c)
    dev_path, ballistic = solver.step.last_path, bool(solver.step.last_gates.get("ballistic"))
    start = to_cpu(state)
    t0 = time.perf_counter()
    cpu = solver.step(start, p, c)
    cpu_s = time.perf_counter() - t0
    cpu_path = solver.step.last_path
    cpu_ballistic = bool(solver.step.last_gates.get("ballistic"))
    tol = plain_tolerance(p.dt)
    if state.bodies.pos.device.type != "cuda":
        tol = dict.fromkeys(tol, 0.0)
    record, failed = compare_plain(dev, dev_path, cpu, cpu_path, tol)
    if ballistic != cpu_ballistic:
        failed.append(f"plain-version check: the card's step ballistic {ballistic}, the CPU's "
                      f"{cpu_ballistic}")
    control = compare_plain(rounded(dev, CONTROL_DTYPE), dev_path, cpu, cpu_path, tol)[0]
    if control["ok"]:
        failed.append(f"plain-version check: the card's step rounded to {CONTROL_DTYPE} passes it "
                      f"({control['max_abs_diff']} within {tol}); it cannot see such a fault")
    nudged = solver.step(one_ulp_up(start), p, c)
    ulp = compare_plain(nudged, solver.step.last_path, cpu, cpu_path, tol)[0]
    record.update(from_step=state.step_index, ballistic=ballistic, cpu_step_s=cpu_s,
                  ok=not failed,
                  control={"rounded_to": str(CONTROL_DTYPE).removeprefix("torch."),
                           "max_abs_diff": control["max_abs_diff"], "fails": not control["ok"]},
                  one_ulp={k: ulp[k] for k in ("max_abs_diff", "integers_identical", "differ",
                                               "stick_latches_differ")})
    return record, failed


def _spread(window: int, seconds: list) -> dict:
    """The timed windows of ``window`` steps, each taking ``seconds``:
    ``steps_per_sec`` all their steps over all their seconds (the
    end-to-end metric), and each window's rate with the best, median and
    quartiles."""
    sps = [window / t for t in seconds]
    q1, med, q3 = np.percentile(sps, [25, 50, 75])
    return {"steps_per_sec": window * len(seconds) / sum(seconds),
            "timed_steps": window * len(seconds), "timed_s": sum(seconds),
            "steps_per_sec_runs": sps, "best": max(sps), "median": float(med),
            "quartiles": [float(q1), float(q3)]}


def run_regime(regime: Regime, device, scene=None, seed: int = 0):
    """Runs ``regime`` on ``device`` (``scene``: the loaded scene, else
    ``load_scene(regime.scene, device)``; ``seed`` > 0 perturbs its spawn
    positions, see SEED_AMP), then its checked run and its plain-version
    checks at the start and the end of its timed windows and from its
    ``plain_at`` states.  Returns (result, (world, params, cap)) with the
    world its traced window starts from: the warm state when ``restart``
    (every window's start), else the timed windows' end world."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    scene = scene or load_scene(regime.scene, device=dev)
    if scene.world.bodies.pos.device.type != dev.type:
        raise ValueError(f"scene on {scene.world.bodies.pos.device}, regime asked for {dev}")
    w0, p, c = perturbed(scene.world, seed, SEED_AMP), scene.params, scene.cap

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    t0 = time.perf_counter()
    start = solver.run_steps(w0, p, c, regime.warm)
    _sync(dev)
    warm_s = time.perf_counter() - t0

    tally, watch, wait = Tally(), GcWatch(), ReadWait()
    card_before = card_reading() if cuda else None
    load, usage = os.getloadavg(), resource.getrusage(resource.RUSAGE_SELF)
    reset_counts()
    allocs = allocator_counts(dev)
    host_spans.reset()
    seconds, refreshes, ends, w = [], [], [], start
    gc.callbacks.append(watch)
    try:
        with wait.installed():
            for _ in range(regime.windows):
                if regime.restart:
                    w = start
                before = tally.refreshed
                _sync(dev)
                watch.on = True
                t0 = time.perf_counter()
                w = tally.run(w, p, c, regime.window)
                wait.timed(_sync, dev)
                seconds.append(time.perf_counter() - t0)
                watch.on = False
                refreshes.append(tally.refreshed - before)
                if regime.restart:
                    ends.append(w)
    finally:
        gc.callbacks.remove(watch)
    spans = host_spans.snapshot()
    if cuda:
        allocs = {"before": allocs, "after": allocator_counts(dev)}
    used = resource.getrusage(resource.RUSAGE_SELF)
    host = {"loadavg_before": list(load), "loadavg_after": list(os.getloadavg()),
            "gc_collections": watch.collections, "gc_s": watch.seconds,
            "cpu_s": used.ru_utime - usage.ru_utime + used.ru_stime - usage.ru_stime,
            "involuntary_switches": used.ru_nivcsw - usage.ru_nivcsw,
            "read_wait": {"calls": wait.calls, "wall_s": wait.wall_s}}
    card = {"before": card_before, "after": card_reading()} if cuda else "not measured"
    ends = ends or [w]
    launches, host_reads = launch_counts(), solver.step.host_reads
    steps = regime.window * regime.windows
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"

    with sync_calls(cuda) as syncs:
        checked, rows = checked_run(w0, p, c, regime.steps)
    checks, failed = check_rows(rows, regime)
    checks["poses_identical"] = all(same_poses(e, checked) for e in ends)
    if not checks["poses_identical"]:
        failed.append(f"{regime.name}: the checked run's final poses differ from the timed run's")
    checks["plain"] = []
    also = [solver.run_steps(start, p, c, k) for k in regime.plain_at]
    for state in (start, *also, w):
        record, plain_failed = plain_check(state, p, c)
        checks["plain"].append(record)
        failed += [f"{regime.name}, from step {state.step_index}: {f}" for f in plain_failed]
    plan = planned_launches(tally, p, c, cuda)
    if launches != plan:
        failed.append(f"{regime.name}: launches {launches}, the code plans {plan}")
    if host_reads != steps:
        failed.append(f"{regime.name}: {host_reads} host reads in {steps} steps, one a step "
                      "expected")
    if wait.calls != host_reads + regime.windows:
        failed.append(f"{regime.name}: {wait.calls} reads and syncs timed, {host_reads} host "
                      f"reads and {regime.windows} closing syncs expected")
    if cuda and len(syncs) != regime.steps + 1:
        failed.append(f"{regime.name}: the checked run synchronized {len(syncs)} times in "
                      f"{regime.steps} steps, its reads alone ({regime.steps + 1}) expected")

    d = w.diagnostics.as_dict()
    result = {
        "scene": regime.scene, "n": w0.bodies.n, "seed": seed, "warm_steps": regime.warm,
        "window_steps": regime.window, "windows": regime.windows,
        **_spread(regime.window, seconds), "warmup_wall_s": warm_s,
        "memory": {"world_bytes": world_bytes(w0), "peak_bytes": peak},
        "counts": {"steps": steps, "paths": dict(tally.paths),
                   "refresh_steps": tally.refreshed, "refresh_steps_by_window": refreshes,
                   "ballistic_steps": sum(tally.ballistic.values()),
                   "host_reads_per_step": host_reads / steps, "launches": launches,
                   "launches_per_step": {k: n / steps for k, n in launches.items()}},
        "checks": checks,
        "host": host, "card": card,
        "host_spans": {k: list(v) for k, v in spans.items()}, "allocator": allocs,
        "final": {"step": w.step_index, "max_penetration": d["max_penetration"],
                  "active_manifolds": int(d["active_manifolds"]),
                  "active_contacts": int(d["active_contacts"]),
                  "overflow": int(d["pair_overflow"]) + int(d["degree_overflow"]),
                  "sanitized": int(d["sanitized"])},
        "failed": failed,
    }
    if regime.baseline:
        result["vs_baseline"] = result["best"] / regime.baseline
    return result, (start if regime.restart else w, p, c)


def traced_window(w, p, c, steps: int) -> dict:
    """``profile_phases.trace`` of ``steps`` steps from ``w``, in the
    bench's units, with the port's kernels' us and launches a step summed by
    the id of the wrapper that launched them (``kernel_us``:
    ``kernel_us_per_step``, ``kernel_launches_per_step``) and each wrapper's
    calls a step by its own counter (``calls_per_step``, by id; the counters
    cover both of ``trace``'s blocks, the same steps from the same state);
    device figures "not measured" where the trace holds no device time (the
    CPU, or a card the profiler cannot trace)."""
    reset_counts()
    r = profile_phases.trace(w, p, c, steps)
    launched = launch_counts()
    out = {"from_step": w.step_index, "steps": steps,
           "ms_per_step_untraced": 1e3 * r["untraced_s"] / steps,
           "ms_per_step_traced": 1e3 * r["wall_s"] / steps}
    out["tracing_cost"] = out["ms_per_step_traced"] / out["ms_per_step_untraced"] - 1.0
    if r["device_us"] > 0.0:
        own_us, own_n = collections.Counter(), collections.Counter()
        for k, us, n in r["kernels"]:
            name = kernel_name(k)
            if name.startswith("k_"):
                own_us[name] += us / steps
                own_n[name] += n / steps
        gaps = r["gaps"]
        out.update(device_us_per_step=r["device_us"] / steps, busy_share=r["busy"],
                   idle_share=1.0 - r["busy"], launches_per_step=r["launches"] / steps,
                   top_kernels=[{"name": k[:NAME_CHARS], "us_per_step": us / steps,
                                 "count_per_step": n / steps}
                                for k, us, n in r["kernels"][:TOP_KERNELS]],
                   kernel_us_per_step=kernel_us(own_us, launched),
                   kernel_launches_per_step=kernel_us(own_n, launched),
                   calls_per_step={WRAPPER_KERNELS[k][0]: n / (2 * steps)
                                   for k, n in launched.items() if n},
                   idle_us_per_step=gaps["idle_us"] / steps,
                   idle_gaps=[{**g, "host_op": g["host_op"][:NAME_CHARS]} for g in gaps["gaps"]],
                   idle_between_ops_share={
                       "spans": gaps["between_ops_us"] / gaps["idle_us"],
                       "host_ops_alone": gaps["unspanned"]["between_ops_us"] / gaps["idle_us"]}
                   if gaps["idle_us"] > 0.0 else "not measured",
                   span_mirrors_left_out=r["span_mirrors"])
    else:
        out.update(dict.fromkeys(("device_us_per_step", "busy_share", "idle_share",
                                  "launches_per_step", "top_kernels", "kernel_us_per_step",
                                  "kernel_launches_per_step", "calls_per_step",
                                  "idle_us_per_step", "idle_gaps", "idle_between_ops_share",
                                  "span_mirrors_left_out"), "not measured"))
    return out


def kernel_name(key: str) -> str:
    """A traced kernel's name without its parameter list and without the
    ``void`` a demangled template carries: ``void k_primal<512>(Dims, ...)``
    -> ``k_primal<512>``."""
    return key.split("(")[0].removeprefix("void ")


def kernel_us(own: dict, launched: dict) -> dict:
    """The traced window's kernels of csrc/ (us, or launches, a step by
    name) summed by the id of the wrapper that launched them: of the
    wrappers that launched in the window (``launched``, launch_counts'
    names), the one whose entry point launches that kernel
    (WRAPPER_KERNELS); where two did, or none, "unattributed"."""
    out = collections.Counter()
    for name, us in own.items():
        ids = {kid for wrapper, (kid, names) in WRAPPER_KERNELS.items()
               if launched.get(wrapper) and name.split("<")[0] in names}
        out[ids.pop() if len(ids) == 1 else "unattributed"] += us
    return dict(out)


def host_per_step(result: dict) -> dict:
    """The host's path a timed step, in us: the process's CPU time over the
    timed windows less the wall time inside its reads and closing syncs,
    through which the reading thread spins (``host_cpu_us_per_step``, the
    host's own work), and that wall time (``host_wait_us_per_step``, the
    host waiting on the card)."""
    host, steps = result["host"], result["timed_steps"]
    wait_s = host["read_wait"]["wall_s"]
    return {"host_cpu_us_per_step": 1e6 * (host["cpu_s"] - wait_s) / steps,
            "host_wait_us_per_step": 1e6 * wait_s / steps}


def host_split(result: dict) -> dict:
    """The host's timed step by span (``utils.host_spans`` over the timed
    windows): ``host_span_us_per_step`` and ``host_span_calls_per_step``,
    keyed ``step``, STEP_SPANS, ``world`` (``path`` less the launch
    functions inside it: the result's assembly), ``step_other`` (``step``
    less STEP_SPANS: the path's choice and the step's own calls),
    ``<id>.prep`` and ``<id>.call`` for every kernel id that launched, and
    ``loop`` (the windows' wall time less ``step``: the bench's own loop
    and the closing syncs; a call a window)."""
    steps = result["timed_steps"]
    spans = result["host_spans"]
    us = {k: 1e-3 * ns / steps for k, (ns, _n) in spans.items()}
    calls = {k: n / steps for k, (_ns, n) in spans.items()}
    ids = sorted({k.rsplit(".", 1)[0] for k in spans if k.endswith((".prep", ".call"))})
    wrappers = [f"{i}.{part}" for i in ids for part in ("prep", "call")]
    out_us = {k: us.get(k, 0.0) for k in ("step",) + STEP_SPANS}
    out_n = {k: calls.get(k, 0.0) for k in ("step",) + STEP_SPANS}
    out_us["world"] = out_us["path"] - sum(us.get(k, 0.0) for k in wrappers
                                           if k.split(".")[0] not in OUTSIDE_PATH)
    out_n["world"] = out_n["path"]
    out_us["step_other"] = out_us["step"] - sum(out_us[k] for k in STEP_SPANS)
    out_n["step_other"] = out_n["step"]
    for k in wrappers:
        out_us[k], out_n[k] = us.get(k, 0.0), calls.get(k, 0.0)
    out_us["loop"] = 1e6 * result["timed_s"] / steps - out_us["step"]
    out_n["loop"] = result["windows"] / steps
    return {"host_span_us_per_step": out_us, "host_span_calls_per_step": out_n}


def span_calls_planned(launches_per_step: dict) -> dict:
    """Each kernel id's ``<id>.call`` spans a step as ``launches_per_step``
    (launch_counts' names, a step) promises them: one ctypes call a launch,
    CALLS_A_LAUNCH where a launch makes more; ids that did not launch are
    left out."""
    out = collections.Counter()
    for wrapper, n in launches_per_step.items():
        kid = WRAPPER_KERNELS[wrapper][0]
        if n:
            out[f"{kid}.call"] += n * CALLS_A_LAUNCH.get(kid, 1)
    return dict(out)


def allocs_per_step(result: dict) -> dict:
    """The caching allocator's device allocations and frees a timed step
    and its retries over the timed windows (ALLOC_STATS); "not measured"
    off the card or where this torch keeps no such counter."""
    a, steps = result["allocator"], result["timed_steps"]
    if a == "not measured":
        return dict.fromkeys(("device_allocs_per_step", "device_frees_per_step",
                              "alloc_retries"), "not measured")

    def grew(k, per=1):
        before, after = a["before"][k], a["after"][k]
        return "not measured" if None in (before, after) else (after - before) / per

    return {"device_allocs_per_step": grew("num_device_alloc", steps),
            "device_frees_per_step": grew("num_device_free", steps),
            "alloc_retries": grew("num_alloc_retries")}


def layers(result: dict, traced: dict | None, build_s: float) -> dict:
    """One regime's per-layer metrics (PERF.md section 3): its timed
    windows' median and quartiles and the counts, which repeat exactly;
    the host's path a timed step (``host_per_step``), split by span
    (``host_split``), and the allocator's calls (``allocs_per_step``); its
    own traced window, where one was taken (device time, idle share and gaps,
    launches, us and launches a step by wrapper id beside each wrapper's
    calls a step; where it starts and its steps are ``extra.traced``'s);
    and the set-up metrics (the kernels' build, peak memory)."""
    c = result["counts"]
    out = {"window_steps_per_sec": {"median": result["median"],
                                    "quartiles": result["quartiles"],
                                    "windows": result["windows"]},
           "refresh_share": c["refresh_steps"] / c["steps"],
           "host_reads_per_step": c["host_reads_per_step"],
           **host_per_step(result), **host_split(result), **allocs_per_step(result),
           "build_s": build_s, **result["memory"]}
    traced = traced or {}
    for k in ("device_us_per_step", "idle_share", "launches_per_step", "kernel_us_per_step",
              "kernel_launches_per_step", "calls_per_step", "idle_gaps",
              "idle_between_ops_share"):
        out[k] = traced.get(k, "not measured")
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
           traced: dict, seed: int = 0) -> dict:
    """The JSON line: ``bench.py``'s keys from the regimes that ran, the
    added fields, and ``correct`` / ``failed`` over every regime.  The
    headline regime (stress1000_settled, else the first that ran) gives
    ``steps_per_sec``: all its timed steps over their seconds, n steps."""
    extra = {"device": device_line, "build_s": build_s,
             "host": {**host_line(), "regimes": {k: r["host"] for k, r in results.items()}},
             "card": {k: r["card"] for k, r in results.items()}}
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
            "quick": quick, "steps_per_sec": results[head]["steps_per_sec"],
            "steps_per_sec_n": results[head]["timed_steps"], "seed": seed,
            "failed_steps": sum(r["checks"]["failed_steps"] for r in results.values()),
            "steps_run": sum(r["checks"]["steps_run"] for r in results.values()),
            "plain_check": {k: r["checks"]["plain"] for k, r in results.items()},
            "layers": {k: layers(r, traced.get(k), build_s) for k, r in results.items()},
            "extra": extra}


def finish(line: dict) -> int:
    """Prints the JSON line; the exit code: 0 when correct, else 1."""
    print(json.dumps(line), flush=True)
    return 0 if line["correct"] else 1


def measure(chosen, device, device_line: str, build_s: float, quick: bool,
            seed: int = 0) -> dict:
    """Every regime of ``chosen`` on ``device`` at ``seed``, then each
    regime's traced window (``Regime.trace_steps`` from the state
    ``run_regime`` returns); returns ``report``."""
    results, starts = {}, {}
    for r in chosen:
        t0 = time.perf_counter()
        results[r.name], starts[r.name] = run_regime(r, device, seed=seed)
        res = results[r.name]
        cpu_s = [round(q["cpu_step_s"], 1) for q in res["checks"]["plain"]]
        log(f"{r.name} (seed {seed}): {res['steps_per_sec']:.1f} steps/s over "
            f"{res['timed_steps']} steps, window median {res['median']:.1f}, best "
            f"{res['best']:.1f}, {time.perf_counter() - t0:.1f} s (the CPU's plain steps {cpu_s} "
            f"s), failed {res['failed']}")
    traced = {r.name: traced_window(*starts[r.name], r.trace_steps) for r in chosen}
    return report(results, device_line, build_s, quick, traced, seed)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="bench.py's regimes on the card (the port)")
    parser.add_argument("--regime", choices=[r.name for r in REGIMES],
                        help="run this regime alone (default: all)")
    parser.add_argument("--quick", action="store_true",
                        help="shorter windows (chip_smoke.py's run)")
    parser.add_argument("--seed", type=int, default=0,
                        help="0: the scenes as built; N > 0: spawn positions moved by a seeded "
                             f"draw of at most {SEED_AMP} m per axis")
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be >= 0")
    if not torch.cuda.is_available():
        print("bench: CUDA is not available; the bench runs on the card only", file=sys.stderr)
        return 2
    card = profile_phases.card_line()
    build_s = kernels.build().build_seconds
    chosen = regimes(args.regime, args.quick)
    warm_up(dict.fromkeys(r.scene for r in chosen), "cuda")
    log(f"{card}; kernels built in {build_s:.1f} s")
    return finish(measure(chosen, "cuda", card, build_s, args.quick, args.seed))


if __name__ == "__main__":
    sys.exit(main())
