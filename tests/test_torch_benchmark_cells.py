"""What the benchmark's cells (BENCHMARK.json) read from the port's bench.

On the CPU, on a few TwoBlockDrop steps (the kernels' plain versions): the
cells' commands name the bench's regimes and the key its last line prints;
the headline is all the timed steps over all the timed windows' seconds,
with the count of steps; ``--seed`` leaves seed 0 as built and moves seeded
spawns by at most SEED_AMP; the plain-version check passes here at the
start and the end of the timed windows (and, on Stress1000's falling
regime, from the ballistic step-1 state), sees a one-ulp change and fails
a run whose control passes; ``failed_steps`` counts a broken hold; the
idle-gap labeller names the host op at a gap's start; the traced kernels
go to the wrapper that launched them, and each regime carries its own
trace, over its own timed work; ``layers`` carries the host's CPU time a
timed step; the kernels' build log round-trips through its store beside
the library.
"""

import dataclasses
import json
import os
import re
import shlex
import types

import numpy as np
import pytest
import torch

from avbd3d_tpu_torch import bench, kernels, load_scene, solver
from avbd3d_tpu_torch.utils import profile_phases
from avbd3d_tpu_torch.utils.profile_phases import BETWEEN_OPS, idle_gaps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

# stress1000_settled cut to three timed windows of two TwoBlockDrop steps.
SETTLED = dict(scene="TwoBlockDrop", warm=2, window=2, windows=3, hold=(3, None), report=(1, 2))


def settled_small() -> bench.Regime:
    (r,) = bench.regimes("stress1000_settled")
    return dataclasses.replace(r, **SETTLED)


def no_trace(monkeypatch):
    monkeypatch.setattr(bench, "traced_window", lambda w, p, c, steps: {"steps": steps})


def one_ulp_up(t):
    t = t.clone()
    t.view(-1)[0] = torch.nextafter(t.view(-1)[0], torch.tensor(np.inf, dtype=t.dtype))
    return t


def test_benchmark_cells_name_the_bench():
    """Each cell runs the bench on one regime at a seed on one chip, and
    its metric is a key of the bench's last line."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        cells = json.load(f)["workloads"]
    assert [c["name"] for c in cells] == ["stress1000_settled", "stress2048_settling",
                                          "stress4096"]
    names = {r.name for r in bench.REGIMES}
    for cell in cells:
        argv = shlex.split(cell["command"])
        assert argv[:3] == ["python", "-m", "avbd3d_tpu_torch.bench"]
        args = dict(zip(argv[3::2], argv[4::2]))
        assert args["--regime"] == cell["name"] and cell["name"] in names
        assert int(args["--seed"]) == 0 and cell["chips"] == 1
        assert cell["reduced"] == [] and len(cell["source"]) <= 200
        (metric,) = cell["metrics"]
        assert metric["name"] == "steps_per_sec" and metric["higher_is_better"] is True
        assert 0.0 < metric["bound"] < 1.0


def test_headline_is_the_whole_window_rate_with_its_steps(monkeypatch):
    no_trace(monkeypatch)
    line = bench.measure((settled_small(),), "cpu", "cpu", 0.0, False, seed=0)
    r = line["extra"]["regimes"]["stress1000_settled"]
    runs = r["steps_per_sec_runs"]
    assert line["correct"] and len(runs) == 3
    assert line["steps_per_sec_n"] == r["timed_steps"] == 6
    assert line["steps_per_sec"] == pytest.approx(6 / sum(2 / x for x in runs), rel=1e-12)
    assert line["steps_per_sec"] == 6 / r["timed_s"]
    assert line["value"] == max(runs)     # bench.py's key keeps its meaning
    assert line["seed"] == 0
    assert line["failed_steps"] == 0 and line["steps_run"] == 2 + 2 * 3
    layers = line["layers"]["stress1000_settled"]
    assert layers["window_steps_per_sec"] == {"median": float(np.median(runs)),
                                              "quartiles": r["quartiles"], "windows": 3}
    assert layers["host_reads_per_step"] == 1.0 and 0.0 <= layers["refresh_share"] <= 1.0
    assert layers["idle_share"] == "not measured" and layers["peak_bytes"] == "not measured"
    assert layers["world_bytes"] > 0
    json.dumps(line)


def test_layers_carry_the_trace_of_their_own_end_state_only(monkeypatch):
    """Three regimes of one scene, each traced over its own timed work: a
    block regime (cascade, settled) from its own end state, TRACE_STEPS
    steps; a restarted one (settling) from its windows' start state, the
    warm state, over one window.  Each regime's ``layers`` carries its own
    trace and no other's."""
    monkeypatch.setattr(bench, "traced_window",
                        lambda w, p, c, steps: {"steps": steps, "from_step": w.step_index,
                                                "idle_share": w.step_index / 100.0})
    cascade = dataclasses.replace(bench.regimes("stress1000_cascade")[0], scene="TwoBlockDrop",
                                  warm=1, window=2, hold=(3, None), report=(1, 2))
    settling = dataclasses.replace(bench.regimes("stress2048_settling")[0], scene="TwoBlockDrop",
                                   warm=4, window=3, windows=2, hold=(5, None), report=(1, 4))
    chosen = (cascade, settled_small(), settling)
    line = bench.measure(chosen, "cpu", "cpu", 0.0, False)
    assert line["correct"]
    traced = line["extra"]["traced"]
    assert list(traced) == [r.name for r in chosen]
    want = {"stress1000_cascade": (cascade.steps, bench.TRACE_STEPS),
            "stress1000_settled": (settled_small().steps, bench.TRACE_STEPS),
            "stress2048_settling": (settling.warm, settling.window)}
    assert want["stress1000_cascade"] == (3, 50) and want["stress2048_settling"] == (4, 3)
    for name, (from_step, steps) in want.items():
        assert (traced[name]["from_step"], traced[name]["steps"]) == (from_step, steps)
        assert line["layers"][name]["idle_share"] == from_step / 100.0
    assert [r.trace_steps for r in chosen] == [50, 50, 3]


def test_seed_zero_is_the_built_scene_and_a_seed_repeats():
    regime = settled_small()
    scene = load_scene("TwoBlockDrop", device="cpu")
    p, c = scene.params, scene.cap
    _r, (end0, _p, _c) = bench.run_regime(regime, "cpu", scene, seed=0)
    assert bench.same_poses(end0, solver.run_steps(scene.world, p, c, regime.steps))

    moved = bench.perturbed(scene.world, 3, bench.SEED_AMP)
    shift = (moved.bodies.pos - scene.world.bodies.pos).abs()
    dynamic = scene.world.bodies.dynamic
    assert float(shift.max()) <= bench.SEED_AMP + 1e-6
    assert bool((shift.amax(0)[dynamic] > 0).all()) and float(shift.amax(0)[~dynamic].max()) == 0.0
    r3, (end3, _p, _c) = bench.run_regime(regime, "cpu", scene, seed=3)
    _r, (again, _p, _c) = bench.run_regime(regime, "cpu", scene, seed=3)
    assert r3["seed"] == 3 and r3["failed"] == []
    assert bench.same_poses(end3, again) and not bench.same_poses(end3, end0)


def test_stress2048_settling_is_ten_restarted_windows_cut_by_quick():
    """Ten windows of 200 steps, each from the same step-700 state (steps
    701-900, 2000 timed steps); ``--quick`` one window of 100 after 200."""
    (r,) = bench.regimes("stress2048_settling")
    assert (r.scene, r.warm, r.window, r.windows, r.restart, r.steps) == (
        "Stress2048", 700, 200, 10, True, 900)
    assert (r.hold, r.report) == ((401, 600), (601, None))
    (q,) = bench.regimes("stress2048_settling", quick=True)
    assert (q.warm, q.window, q.windows) == (200, 100, 1)


def test_stress1000_falling_is_ten_windows_from_the_built_scene_cut_by_quick():
    """Ten windows of 300 steps, each from the built scene (steps 1-300,
    3000 timed steps), no warm step, the penetration reported and not held;
    the plain check also from step 1; traced over one window from step 0;
    ``--quick`` one window."""
    (r,) = bench.regimes("stress1000_falling")
    assert (r.scene, r.warm, r.window, r.windows, r.restart, r.steps) == (
        "Stress1000", 0, 300, 10, True, 300)
    assert r.window * r.windows == 3000 and r.plain_at == (1,)
    assert bench._window(r.hold, r.steps) is None and r.report == (1, 300)
    assert r.trace_steps == 300
    (q,) = bench.regimes("stress1000_falling", quick=True)
    assert (q.warm, q.window, q.windows) == (0, 300, 1)


def test_stress1000_falling_runs_by_a_cells_command(monkeypatch, capsys):
    """The falling regime runs as a cell's command runs (``tools/ab_cells.py``
    gives a regime that is no cell of BENCHMARK.json this command): the
    bench's parser takes it and, without CUDA, refuses with exit code 2.
    BENCHMARK.json's last line names ``host_cpu_us_per_step``, and the
    settling cell is traced over one window from step 700."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = shlex.split("python -m avbd3d_tpu_torch.bench --regime stress1000_falling --seed 0")
    assert bench.main(argv[3:]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        doc = json.load(f)
    assert "host_cpu_us_per_step" in doc["last_line"]
    cells = {c["name"]: c for c in doc["workloads"]}
    checked = cells["stress2048_settling"]["traffic"]["checked"]
    assert "from step 700" in checked and "50 steps from step 900" not in checked


def test_falling_plain_check_passes_from_the_ballistic_step_one_state(monkeypatch):
    """Stress1000's falling regime, cut to two windows of two steps: the
    plain check passes on the CPU from step 0 (a contact step), from step 1
    (a ballistic one, BS and K2's plain versions) and from the windows'
    end; the float16 control fails at each; the run is correct."""
    no_trace(monkeypatch)
    regime = dataclasses.replace(bench.regimes("stress1000_falling")[0], window=2, windows=2)
    line = bench.measure((regime,), "cpu", "cpu", 0.0, False)
    assert line["correct"] and line["failed_steps"] == 0
    points = line["plain_check"]["stress1000_falling"]
    assert [(q["from_step"], q["ballistic"]) for q in points] == [(0, False), (1, True),
                                                                 (2, True)]
    for q in points:
        assert q["ok"] and q["integers_identical"] and q["path"] == "fused"
        assert set(q["max_abs_diff"].values()) == {0.0}
        assert q["control"]["fails"]
    counts = line["extra"]["regimes"]["stress1000_falling"]["counts"]
    assert counts["ballistic_steps"] == 2 and counts["steps"] == 4


def test_layers_carry_the_host_cpu_time_a_timed_step(monkeypatch):
    """``host_cpu_us_per_step``: the process's user and system CPU seconds
    over the timed windows less the wall seconds inside its reads and
    closing syncs (``extra.host``), a timed step, in us;
    ``host_wait_us_per_step`` those wall seconds.  Every read the step
    counts was timed: six reads in six steps and three closing syncs."""
    no_trace(monkeypatch)
    line = bench.measure((settled_small(),), "cpu", "cpu", 0.0, False)
    assert line["correct"]
    host = line["extra"]["host"]["regimes"]["stress1000_settled"]
    wait = host["read_wait"]
    assert wait["calls"] == 6 + 3 and 0.0 <= wait["wall_s"] < host["cpu_s"]
    lay = line["layers"]["stress1000_settled"]
    assert lay["host_cpu_us_per_step"] == pytest.approx(
        1e6 * (host["cpu_s"] - wait["wall_s"]) / 6, rel=1e-12)
    assert lay["host_wait_us_per_step"] == pytest.approx(1e6 * wait["wall_s"] / 6, rel=1e-12)
    assert lay["host_cpu_us_per_step"] > 0.0 and lay["host_wait_us_per_step"] >= 0.0
    assert "trace_window" not in lay     # where the trace starts is extra.traced's alone


def test_read_wait_times_every_cpu_read_and_puts_tensor_cpu_back():
    """``ReadWait.installed`` counts and times each ``Tensor.cpu`` call and
    each call passed to ``timed``, returns what they return, and leaves
    ``Tensor.cpu`` as it was, also when the block raises."""
    cpu = torch.Tensor.cpu
    wait = bench.ReadWait()
    t = torch.arange(4.0)
    with wait.installed():
        assert torch.equal(t.cpu(), t) and torch.equal(t[1:].cpu(), t[1:])
        assert wait.timed(sum, [1, 2]) == 3
    assert wait.calls == 3 and wait.wall_s >= 0.0
    assert torch.Tensor.cpu is cpu and "cpu" not in vars(torch.Tensor)
    with pytest.raises(RuntimeError), wait.installed():
        raise RuntimeError
    assert torch.Tensor.cpu is cpu and "cpu" not in vars(torch.Tensor)
    t.cpu()
    assert wait.calls == 3


def test_sync_calls_sees_nothing_on_the_cpu():
    """Torch's sync debug mode is the card's; on the CPU ``sync_calls``
    stays empty, and other warnings inside it are not counted."""
    import warnings

    with bench.sync_calls(False) as syncs:
        torch.arange(3.0).cpu()
        warnings.warn("not a synchronization")
    assert syncs == []


def test_plain_check_passes_on_the_cpu_at_both_ends_of_the_windows():
    regime = settled_small()
    result, _end = bench.run_regime(regime, "cpu", load_scene("TwoBlockDrop", device="cpu"))
    points = result["checks"]["plain"]
    assert [q["from_step"] for q in points] == [regime.warm, regime.steps]
    for q in points:
        assert q["ok"] and q["integers_identical"]
        assert set(q["max_abs_diff"].values()) == {0.0}
        assert set(q["tolerance"].values()) == {0.0}     # the same device: bit for bit
        assert q["control"]["fails"] and q["control"]["rounded_to"] == "float16"
        assert max(q["control"]["max_abs_diff"].values()) > 0.0
        assert set(q["one_ulp"]) == {"max_abs_diff", "integers_identical", "differ",
                                     "stick_latches_differ"}
        assert max(q["one_ulp"]["max_abs_diff"].values()) > 0.0


def test_control_and_witness_worlds():
    """The control rounds every dynamic body's pose and velocity to float16
    and back, and leaves the padding (at 1e6 m, past float16) as it is; the
    witness moves each dynamic body's pose one ulp up and no static one."""
    sc = load_scene("TwoBlockDrop", device="cpu")
    w = solver.run_steps(sc.world, sc.params, sc.cap, 3)
    b = w.bodies
    r = bench.rounded(w, torch.float16).bodies
    for f in ("pos", "quat", "linvel", "angvel"):
        got, want = getattr(r, f), getattr(b, f)
        assert torch.equal(got[:, b.dynamic], want[:, b.dynamic].half().float())
        assert torch.equal(got[:, ~b.dynamic], want[:, ~b.dynamic])
    assert r.pos.dtype == torch.float32 and not torch.equal(r.pos, b.pos)
    assert float(b.pos[:, ~b.dynamic].abs().max()) > 65504.0     # float16's largest
    assert bool(torch.isfinite(r.pos).all())
    u = bench.one_ulp_up(w).bodies
    up = torch.tensor(np.inf)
    assert torch.equal(u.pos[:, b.dynamic], torch.nextafter(b.pos[:, b.dynamic], up))
    assert torch.equal(u.quat[:, b.dynamic], torch.nextafter(b.quat[:, b.dynamic], up))
    assert torch.equal(u.pos[:, ~b.dynamic], b.pos[:, ~b.dynamic])
    assert torch.equal(u.linvel, b.linvel)


def test_a_control_that_passes_fails_the_run(monkeypatch):
    """Where the control passes the comparison (here rounded to float32,
    i.e. unchanged), the check cannot see such a fault: ``"correct": false``."""
    monkeypatch.setattr(bench, "CONTROL_DTYPE", torch.float32)
    no_trace(monkeypatch)
    line = bench.measure((settled_small(),), "cpu", "cpu", 0.0, False)
    assert line["correct"] is False
    assert all(not q["ok"] and not q["control"]["fails"]
               for q in line["plain_check"]["stress1000_settled"])
    assert any("cannot see such a fault" in f for f in line["failed"])


def test_plain_check_sees_one_ulp_and_fails_the_run(monkeypatch, capsys):
    """A one-ulp change to a pose after the CPU's step fails the check on
    the CPU; the JSON line says ``"correct": false``, exit code 1.  Within
    the card's tolerance the same ulp passes, and a changed integer output
    fails there too."""
    sc = load_scene("TwoBlockDrop", device="cpu")
    w = solver.run_steps(sc.world, sc.params, sc.cap, 3)
    ulp = w.replace(bodies=w.bodies.replace(pos=one_ulp_up(w.bodies.pos)))
    card = bench.plain_tolerance(sc.params.dt)
    zero = dict.fromkeys(card, 0.0)
    assert bench.compare_plain(w, "fused", w, "fused", zero)[0]["ok"]
    assert not bench.compare_plain(w, "fused", ulp, "fused", zero)[0]["ok"]
    assert bench.compare_plain(w, "fused", ulp, "fused", card)[0]["ok"]
    count = w.contacts.count.clone()
    count.view(-1)[0] += 1
    moved = w.replace(contacts=w.contacts.replace(count=count))
    record, failed = bench.compare_plain(w, "fused", moved, "fused", card)
    assert record["differ"] == ["contacts.count"] and failed
    stick = w.contacts.stick.clone()
    stick.view(-1)[0] = ~stick.view(-1)[0]
    latched = w.replace(contacts=w.contacts.replace(stick=stick))
    record = bench.compare_plain(w, "fused", latched, "fused", card)[0]
    assert record["ok"] and record["stick_latches_differ"] == 1    # counted, not held
    assert not bench.compare_plain(w, "fused", w, "grid", card)[0]["ok"]

    compare = bench.compare_plain

    def after_one_ulp(dev, dev_path, cpu, cpu_path, tol):
        cpu = cpu.replace(bodies=cpu.bodies.replace(pos=one_ulp_up(cpu.bodies.pos)))
        return compare(dev, dev_path, cpu, cpu_path, tol)

    monkeypatch.setattr(bench, "compare_plain", after_one_ulp)
    no_trace(monkeypatch)
    line = bench.measure((settled_small(),), "cpu", "cpu", 0.0, False)
    capsys.readouterr()
    assert bench.finish(line) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is False
    assert not any(q["ok"] for q in out["plain_check"]["stress1000_settled"])
    assert any("plain-version check" in f for f in out["failed"])


def test_failed_steps_count_a_forced_sanitized_lane(monkeypatch):
    regime = settled_small()
    rows = np.zeros((regime.steps, 17), dtype=np.float32)
    rows[:, 16] = 1.0
    assert bench.check_rows(rows, regime)[0]["failed_steps"] == 0
    rows[4, 8] = 1.0                     # sanitized at step 5
    rows[5, 0] = 2 * bench.PEN_LIMIT     # a held step over the limit
    rows[1, 0] = 2 * bench.PEN_LIMIT     # step 2: reported, not held
    rows[6, 16] = 0.0                    # non-finite poses at step 7
    checks, failed = bench.check_rows(rows, regime)
    assert (checks["failed_steps"], checks["steps_run"]) == (3, regime.steps) and len(failed) == 3

    checked_run = bench.checked_run

    def sanitized_once(w, p, c, n):
        w, out = checked_run(w, p, c, n)
        out[n // 2, 8] = 1.0
        return w, out

    monkeypatch.setattr(bench, "checked_run", sanitized_once)
    no_trace(monkeypatch)
    line = bench.measure((regime,), "cpu", "cpu", 0.0, False)
    assert line["correct"] is False and line["failed_steps"] == 1
    assert line["steps_run"] == regime.steps


def test_idle_gaps_name_the_host_op_and_the_length():
    device = [(0.0, 10.0), (12.0, 20.0), (15.0, 22.0), (30.0, 31.0), (40.0, 50.0), (53.0, 54.0)]
    host = [("step", 0.0, 52.0), ("aten::topk", 21.0, 35.0),
            ("cudaLaunchKernel", 22.0, 23.0), ("aten::add", 38.0, 45.0)]
    out = idle_gaps(device, host, top=3)
    assert out["idle_us"] == 2.0 + 8.0 + 9.0 + 3.0
    assert out["gaps"] == [{"us": 9.0, "start_us": 31.0, "host_op": "aten::topk"},
                           {"us": 8.0, "start_us": 22.0, "host_op": "cudaLaunchKernel"},
                           {"us": 3.0, "start_us": 50.0, "host_op": "step"}]
    host = [h for h in host if h[0] != "step"]
    labels = {g["start_us"]: g["host_op"] for g in idle_gaps(device, host)["gaps"]}
    assert labels == {31.0: "aten::topk", 22.0: "cudaLaunchKernel", 50.0: BETWEEN_OPS,
                      10.0: BETWEEN_OPS}
    assert idle_gaps([(0.0, 5.0), (1.0, 4.0)], host)["gaps"] == []
    # A gap that begins inside a span's range (utils.host_spans; open only
    # inside profile_phases.trace) is named by the span; the gaps no host op
    # or span names are summed apart.
    spanned = host + [("avbd.refresh", 48.0, 52.0)]
    out = idle_gaps(device, spanned)
    labels = {g["start_us"]: g["host_op"] for g in out["gaps"]}
    assert labels == {31.0: "aten::topk", 22.0: "cudaLaunchKernel", 50.0: "avbd.refresh",
                      10.0: BETWEEN_OPS}
    assert out["between_ops_us"] == 2.0 and idle_gaps(device, host)["between_ops_us"] == 5.0


def global_kernels() -> set:
    """The names of every ``__global__`` kernel in avbd3d_tpu_torch/csrc/."""
    csrc = os.path.join(REPO, "avbd3d_tpu_torch", "csrc")
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    names = set()
    for fname in os.listdir(csrc):
        with open(os.path.join(csrc, fname)) as f:
            names |= set(pattern.findall(f.read()))
    return names


def test_every_kernel_belongs_to_a_wrapper():
    """Every ``__global__`` kernel of csrc/ but the measuring tool
    ``k_launch_floor`` belongs to a wrapper of WRAPPER_KERNELS, so a traced
    window attributes it; and every name there is a kernel of csrc/."""
    kernels_found = global_kernels()
    assert {"k_step_gates", "k_bp_lists", "k_probe", "k_launch_floor"} <= kernels_found
    named = set().union(*(names for _id, names in bench.WRAPPER_KERNELS.values()))
    assert kernels_found - named == {"k_launch_floor"}
    assert named <= kernels_found
    ids = [kid for kid, _names in bench.WRAPPER_KERNELS.values()]
    assert len(ids) == len(set(ids))
    assert set(ids) == {"K1", "K2", "K3", "K4", "K5", "K6", "K7", "R", "P", "G", "PR", "FN",
                        "SG", "BS"}


def test_kernels_sum_by_the_wrapper_that_launched_them():
    own = {"k_primal<512>": 5.0, "k_dual": 3.0, "k_collide<4>": 1.0, "k_filter_cull": 0.5,
           "k_control_lanes": 0.25, "k_sweeps<1024>": 7.0}
    fused = {"step_kernel": 10, "control_lanes": 2, "collide_grid": 0}
    assert bench.kernel_us(own, fused) == {"K1": 16.5, "K2": 0.25}
    grid = {"collide_grid": 10, "iterblock_grid": 50, "control_lanes": 1}
    assert bench.kernel_us(own, grid) == {"K6": 15.0, "K5": 1.5, "K2": 0.25}
    # Both paths in one window: the shared kernels name no one wrapper; a
    # kernel whose wrapper did not launch names none.
    both = {"step_kernel": 1, "collide_grid": 1, "iterblock_grid": 5}
    assert bench.kernel_us(own, both) == {"unattributed": 16.75}
    assert bench.kernel_us({"k_probe": 2.0}, {"bp_probe": 1}) == {"K7": 2.0}
    # The stage and refresh kernels go to their own wrappers.
    stages = {"k_grid_gates": 7.0, "k_grid_predict": 3.0, "k_grid_finalize": 5.0,
              "k_bp_tables": 1.0, "k_bp_lists": 40.0, "k_collide<4>": 1.0}
    grid = {"collide_grid": 1, "grid_gates": 1, "grid_predict": 1, "grid_finalize": 1,
            "candidate_lists": 1}
    assert bench.kernel_us(stages, grid) == {"G": 7.0, "PR": 3.0, "FN": 5.0, "R": 41.0,
                                             "K5": 1.0}
    fused = {"step_kernel": 1, "step_gates": 1, "ballistic_step": 1, "control_lanes": 1}
    assert bench.kernel_us({"k_step_gates": 1.5, "k_ballistic_step": 4.0, "k_primal<512>": 9.0},
                           fused) == {"SG": 1.5, "BS": 4.0, "K1": 9.0}
    # A stage kernel whose wrapper did not launch names none.
    assert bench.kernel_us({"k_refresh_needed": 6.0}, grid) == {"unattributed": 6.0}
    assert bench.kernel_name("void k_joint_sweeps<512, true>(Dims, Cache)") == \
        "k_joint_sweeps<512, true>"


def fake_event(name, start, end, device, us=0.0, cpu_us=0.0):
    """A profiler record as ``trace`` reads it from ``prof.events()``."""
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, key=name, is_async=False,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end),
        self_device_time_total=us, self_cpu_time_total=cpu_us)


def test_trace_leaves_the_primer_out(monkeypatch):
    """The profiler's rows as the card gives them: the primer's two K7
    launches (each with its host call and synchronize) before the traced
    block's range, which the profiler also mirrors on the device's
    timeline.  ``trace`` counts none of them in its kernels, launches,
    device time, operators or idle gaps."""
    window = profile_phases.WINDOW
    rows = [fake_event("k_probe", 1.0, 3.0, True, us=2.0),
            fake_event("cudaLaunchKernel", 0.5, 0.9, False, cpu_us=0.4),
            fake_event("cudaDeviceSynchronize", 1.0, 3.5, False, cpu_us=2.5),
            fake_event("k_probe", 5.0, 7.0, True, us=2.0),
            fake_event("cudaDeviceSynchronize", 5.0, 7.5, False, cpu_us=2.5),
            fake_event(window, 10.0, 60.0, False, cpu_us=20.0),
            fake_event(window, 12.0, 50.0, True, us=38.0),
            fake_event("cudaLaunchKernel", 11.0, 11.5, False, cpu_us=0.5),
            fake_event("k_step_gates", 12.0, 14.0, True, us=2.0),
            fake_event("aten::empty", 15.0, 20.0, False, cpu_us=5.0),
            fake_event("k_primal<512>", 20.0, 30.0, True, us=10.0),
            fake_event("k_primal<512>", 40.0, 50.0, True, us=10.0),
            fake_event("Memcpy DtoH (Device -> Pinned)", 50.0, 51.0, True, us=1.0)]

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
    assert r["kernels"] == [("k_primal<512>", 20.0, 2), ("k_step_gates", 2.0, 1),
                            ("Memcpy DtoH (Device -> Pinned)", 1.0, 1)]
    assert r["launches"] == 3 and r["device_us"] == 23.0
    assert {name for name, _us, _n in r["operators"]} == {"cudaLaunchKernel", "aten::empty"}
    assert dict((k, n) for k, _us, n in r["operators"])["cudaLaunchKernel"] == 1
    assert r["gaps"]["idle_us"] == (20.0 - 14.0) + (40.0 - 30.0)
    assert [g["host_op"] for g in r["gaps"]["gaps"]] == [BETWEEN_OPS, BETWEEN_OPS]
    # Without the range (a session that never opened it) every row counts.
    assert len(profile_phases._window_events(rows[:5])) == 5


def test_extra_host_and_card_on_a_cpu_run(monkeypatch):
    """The run's conditions ride on the last line, reported and not
    metrics: the CPU model, the CPUs this process may use, and for each
    regime the load average, Python's garbage collections and the process's
    CPU time and involuntary switches over its timed windows; on the CPU
    the card's readings are "not measured"."""
    no_trace(monkeypatch)
    line = bench.measure((settled_small(),), "cpu", "cpu", 0.0, False)
    host = line["extra"]["host"]
    assert isinstance(host["cpu_model"], str) and host["cpus"] == len(os.sched_getaffinity(0))
    timed = host["regimes"]["stress1000_settled"]
    assert len(timed["loadavg_before"]) == len(timed["loadavg_after"]) == 3
    assert len(timed["gc_collections"]) == 3 and timed["gc_s"] >= 0.0
    assert timed["cpu_s"] >= 0.0 and timed["involuntary_switches"] >= 0
    assert line["extra"]["card"] == {"stress1000_settled": "not measured"}
    json.dumps(line)


def test_gc_watch_counts_only_while_on():
    import gc

    watch = bench.GcWatch()
    gc.callbacks.append(watch)
    try:
        gc.collect()
        assert watch.collections == [0, 0, 0]
        watch.on = True
        gc.collect(0)
        gc.collect()
        watch.on = False
        gc.collect()
    finally:
        gc.callbacks.remove(watch)
    assert watch.collections == [1, 0, 1] and watch.seconds > 0.0


def test_build_log_round_trips_into_ptxas_usage(tmp_path):
    lib = str(tmp_path / "libavbd3d_kernels_0123456789abcdef.so")
    assert kernels.load_build_log(lib) == ""
    log = ("== step_kernel.cu\n"
           "ptxas info    : Compiling entry function '_Z8k_primalILi512EEv4Dims5Cache6Bodies"
           "4Work7KParamsiif' for 'sm_90a'\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 72 registers\n")
    kernels.store_build_log(lib, log)
    assert sorted(os.listdir(tmp_path)) == ["libavbd3d_kernels_0123456789abcdef.log"]
    assert kernels.load_build_log(lib) == log
    assert kernels.ptxas_usage(kernels.load_build_log(lib)) == {
        "k_primal<512>": {"registers": 72, "spill_bytes": 12}}


@pytest.mark.parametrize("seed", ["-1", "x"])
def test_seed_must_be_a_count(seed, capsys):
    with pytest.raises(SystemExit):
        bench.main(["--seed", seed])
    assert "--seed" in capsys.readouterr().err
