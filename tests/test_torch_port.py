"""The PyTorch port on its own: isolation from JAX, devices, wrappers, the
kernel parameter contract, the smoke script's failure modes, and (on a
machine with an NVIDIA GPU) each CUDA kernel against its plain version.

No JAX here; the comparisons with the reference are test_torch_parity_*.py.
"""

import dataclasses
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from avbd3d_tpu_torch import (SceneBuilder, kernels, load_scene, run_steps, solver,
                              solver_cuda, solver_grid)
from avbd3d_tpu_torch.config import SolverParams
from avbd3d_tpu_torch.convert import world_from_arrays
from avbd3d_tpu_torch.ops import broadphase
from avbd3d_tpu_torch.ops.broadphase import build_bp_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def test_port_imports_no_jax():
    """Every module of the package (found by ``pkgutil.walk_packages``) and
    chip_smoke.py import neither JAX nor the reference."""
    code = ("import importlib, pkgutil, sys, avbd3d_tpu_torch as pkg; "
            "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]; "
            "[importlib.import_module(m) for m in mods]; import chip_smoke; "
            "assert {'avbd3d_tpu_torch.bench', 'avbd3d_tpu_torch.parallel.sharded', "
            "'avbd3d_tpu_torch.utils.sweep_bench'} <= set(mods), mods; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'avbd3d_tpu.'))"
            " or m == 'avbd3d_tpu']; assert not bad, bad; print(len(mods))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_scene("Stack", device="cuda")


def test_chip_smoke_fails_without_the_card_or_the_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the wrappers return the plain versions' results and
    count no kernel launch."""
    sc = load_scene("TwoBlockDrop", device="cpu")
    w = sc.world
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    bp = w.bp
    args = (w.contacts, bp.nb, bp.key, bp.thr, w.bodies, bp.anchor, bp.anchor_quat,
            sc.params, 10, 4, bp.cand)
    solver_cuda.reset_launch_counts()
    c1, b1, d1, r1 = solver_cuda.step_kernel(*args)
    c2, b2, d2, _r2 = solver_cuda.step_kernel_plain(*args)
    lanes = solver_cuda.control_lanes(bp.nb, w.bodies, bp.anchor, bp.anchor_quat, sc.params)
    k3 = solver_cuda.collide_and_init(w.contacts, bp.nb, bp.key, bp.thr, w.bodies, sc.params)
    k4 = solver_cuda.solve_loop(k3[0], w.bodies, sc.params)
    probe = solver_cuda.bp_probe(bp.nb, w.bodies, sc.params)
    assert all(getattr(solver_cuda, k).launches == 0 for k in
               ("step_kernel", "control_lanes", "collide_and_init", "solve_loop", "bp_probe"))
    assert probe[2].shape == (1, 128) and probe[2].dtype == torch.bool
    for x, y in zip(b1, b2):
        assert torch.equal(x, y)
    assert torch.equal(d1, d2) and torch.equal(c1.count, c2.count)
    assert r1 == (None, None, None)        # no joint or spring rows
    assert int(d1[0, 5]) == 4              # the tilted cube lands on one face
    assert lanes.shape == (5,) and bool(torch.isfinite(lanes).all())
    # K3 then K4 at the scene's iterations is K1 without the control lanes.
    assert torch.equal(k3[0].count, c1.count) and int(k3[1]) == int(d1[0, 9])
    plain = solver_cuda.step_kernel_plain(*args[:8], sc.params.iterations,
                                          sc.params.lhs_rebuild_every, bp.cand)
    assert torch.equal(k4[0].pos, plain[1][0]) and torch.equal(k4[4][0, :9], plain[2][0, :9])


@pytest.mark.parametrize("stale_ok,calm,variant", [
    (True, True, (10, 4)),      # calm: scene iterations, stale cadence
    (True, False, (20, 4)),     # energetic but stale-safe: boosted sweeps
    (False, False, (20, 1)),    # energetic and fresh: boosted, rebuild every sweep
])
def test_select_variant_default_params(stale_ok, calm, variant):
    assert solver_cuda.select_variant(SolverParams(), stale_ok, calm) == variant


def test_select_variant_stress1000_has_one_variant():
    """Stress1000's cadence gate collapses (k_fresh == k_calm, no boost)."""
    p = load_scene("Stress1000", device="cpu").params
    seen = {solver_cuda.select_variant(p, s, c) for s in (True, False) for c in (True, False)}
    assert seen == {(20, 4)}


@pytest.mark.parametrize("n_rows, batch, rows", [(1024, 1, 4), (2048, 1, 8), (5120, 1, 16),
                                                  (16384, 1, 32), (1024, 16, 32), (128, 1, 2)])
def test_bp_rows_per_block(n_rows, batch, rows):
    """k_bp_lists' rows a block on a 132-SM card: the most that still give
    the SMs 1.5 blocks each, else 2 (each row's columns over 4 warps); the
    per-row buffer holds twice the widest list (its cut keeps the D smallest
    of a fuller row)."""
    assert kernels.bp_rows_per_block(n_rows, batch, 132) == rows
    assert kernels.BP_ROW_BUFFER == 2 * kernels.BP_MAX_DEGREE


def stage_geometry() -> dict:
    """The stage kernels' geometry constants as csrc/ defines them: slot
    threads a block of k_grid_finalize (STAGE_THREADS) and its body warps
    (FIN_BODY_WARPS), the grids' most blocks an SM (STAGE_BLOCKS_PER_SM),
    k_grid_predict's latch warps and the groups of 4 latches a latch thread
    loads at a time (PRED_LATCH_WARPS, PRED_LATCH_UNROLL) and
    k_ballistic_step's slot warps (BAL_SLOT_WARPS)."""
    src = ""
    for name in ("avbd_common.cuh", "grid_stages.cu", "fused_stages.cu"):
        with open(os.path.join(REPO, "avbd3d_tpu_torch", "csrc", name)) as f:
            src += f.read()
    return {k: int(re.search(rf"#define {k} (\d+)", src).group(1))
            for k in ("STAGE_THREADS", "FIN_BODY_WARPS", "STAGE_BLOCKS_PER_SM",
                      "PRED_LATCH_WARPS", "PRED_LATCH_UNROLL", "BAL_SLOT_WARPS")}


def finalize_grid(n: int, dc: int, d: int, sms: int) -> int:
    """avbd_grid_finalize's grid: a slot thread for each entry of the
    widest plane set (DC or D slots a body, or the 6 planes of previous
    velocities), at most STAGE_BLOCKS_PER_SM blocks an SM."""
    g = stage_geometry()
    return min(-(-max(dc, d, 6) * n // g["STAGE_THREADS"]), g["STAGE_BLOCKS_PER_SM"] * sms)


def finalize_cover(n: int, dc: int, d: int, blocks: int) -> dict:
    """k_grid_finalize's loops on a ``blocks`` grid written out: {"slots",
    "kept", "prev", "linear", "angular"}, the index of every (slot, body),
    kept entry, previous-velocity entry (6 planes of N) and body half that
    some thread visits, once a visit.  Slot thread t of the grid (stride:
    all of them) takes the slot, kept and previous-velocity entries t, t +
    stride, ...; body warp w of block b the chunks of 16 bodies c = b +
    blocks * (w + FIN_BODY_WARPS r), lanes 0-15 their linear halves, 16-31
    their angular ones."""
    g = stage_geometry()
    bw = g["FIN_BODY_WARPS"]
    stride = blocks * g["STAGE_THREADS"]
    slots, kept = dc * n, d * n
    rounds = -(-max(slots, kept, 6 * n) // stride)
    t = (np.arange(stride)[None, :] + stride * np.arange(rounds)[:, None]).reshape(-1)
    chunks = -(-n // 16)
    steps = -(-chunks // (blocks * bw))
    c = (np.arange(blocks)[:, None, None] + blocks * (
        np.arange(bw)[None, :, None] + bw * np.arange(steps)[None, None, :])).reshape(-1)
    i = 16 * c[c < chunks][:, None] + np.arange(32)[None, :] % 16
    half = np.broadcast_to(np.arange(32)[None, :] >= 16, i.shape)
    ok = i < n
    return {"slots": t[t < slots], "kept": t[t < kept], "prev": t[t < 6 * n],
            "linear": i[ok & ~half], "angular": i[ok & half]}


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("d, dc", [(24, 12), (28, 16)])
@pytest.mark.parametrize("n", [128, 1024, 5120, 16384])
def test_finalize_grid_covers_every_entry_once(n, d, dc, sms):
    """k_grid_finalize's grid (a slot thread for each entry of its widest
    plane, 256 a block, at most two blocks an SM) and its grid-stride loops
    as ``finalize_cover`` writes them out from csrc/'s constants: every
    (slot, body), kept entry, previous-velocity entry and each half
    (linear, angular) of every body taken by exactly one thread; the
    bodies' chunks of 16 spread over min(blocks, N / 16) blocks.  The
    kernel itself is held at other grids on the card
    (test_cuda_finalize_and_step_gates_folds_match_plain)."""
    blocks = finalize_grid(n, dc, d, sms)
    assert 1 <= blocks <= 2 * sms
    assert blocks == min(-(-max(dc, d) * n // 256), 2 * sms)
    cover = finalize_cover(n, dc, d, blocks)
    for key, count in (("slots", dc * n), ("kept", d * n), ("prev", 6 * n), ("linear", n),
                       ("angular", n)):
        assert np.array_equal(np.bincount(cover[key], minlength=count), np.ones(count)), key
    owners = {c % blocks for c in range(n // 16)}
    assert len(owners) == min(blocks, n // 16)


def predict_grid(n: int, planes: int, sms: int) -> int:
    """avbd_grid_predict's grid: a block for each 32 bodies or for each
    PRED_LATCH_UNROLL groups of 4 latches a latch thread, whichever is
    more, at most STAGE_BLOCKS_PER_SM blocks an SM."""
    g = stage_geometry()
    per_block = 32 * g["PRED_LATCH_WARPS"] * g["PRED_LATCH_UNROLL"]
    return min(max(-(-(planes * n // 4) // per_block), -(-n // 32)),
               g["STAGE_BLOCKS_PER_SM"] * sms)


def body_halves(n: int, blocks: int) -> dict:
    """The body warps' loops of k_grid_predict and k_ballistic_step on a
    ``blocks`` grid written out: block b's linear and angular warps take
    the chunks of 32 bodies c = b, b + blocks, ..., a lane a body."""
    chunks = -(-n // 32)
    taken = [np.arange(b, chunks, blocks) for b in range(blocks)]
    i = np.concatenate([(32 * c[:, None] + np.arange(32)[None, :]).reshape(-1) for c in taken])
    i = i[i < n]
    owners = sum(len(c) > 0 for c in taken)
    return {"linear": i, "angular": i, "owners": owners}


def predict_cover(n: int, planes: int, blocks: int, wide: bool) -> dict:
    """k_grid_predict's loops on a ``blocks`` grid written out: the latches
    each latch thread writes (latch warp w of block b is global warp g = b
    + blocks w; its lane's groups of 4 are 32 g + lane + k stride, then the
    latches past the last whole group, a thread one, from 4 groups + 32 g +
    lane; all of them that way where the buffers are not ``wide``), and the
    body halves."""
    g = stage_geometry()
    stride = blocks * g["PRED_LATCH_WARPS"] * 32
    total = planes * n
    groups = total // 4 if wide else 0
    first = ((np.arange(blocks)[:, None] + blocks * np.arange(g["PRED_LATCH_WARPS"])[None, :])
             .reshape(-1, 1) * 32 + np.arange(32)[None, :]).reshape(-1)
    u = (first[None, :] + stride * np.arange(-(-groups // stride) + 1)[:, None]).reshape(-1)
    u = u[u < groups]
    latches = (4 * u[:, None] + np.arange(4)[None, :]).reshape(-1)
    t = (4 * groups + first[None, :] + stride * np.arange(-(-total // stride) + 1)[:, None])
    t = t.reshape(-1)
    return {"latches": np.concatenate([latches, t[t < total]]), **body_halves(n, blocks)}


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("dc", [12, 16])
@pytest.mark.parametrize("n", [128, 1024, 5120, 16384])
def test_predict_grid_covers_every_entry_once(n, dc, sms):
    """k_grid_predict's grid (a block for each 32 bodies or each 2 x 256
    groups of 4 latches, at most two blocks an SM) and its loops as
    ``predict_cover`` writes them out from csrc/'s constants: every stick
    latch (4 DC planes of N) written by exactly one thread, with the wide
    accesses and without them; each half (linear, angular) of every body
    taken by exactly one lane; the chunks of 32 bodies spread over
    min(blocks, N / 32) blocks.  Stress4096's shape takes 160 blocks."""
    planes = 4 * dc
    blocks = predict_grid(n, planes, sms)
    assert 1 <= blocks <= 2 * sms
    if (n, dc, sms) == (5120, 16, 132):
        assert blocks == 160
    for wide in (True, False):
        cover = predict_cover(n, planes, blocks, wide)
        assert np.array_equal(np.bincount(cover["latches"], minlength=planes * n),
                              np.ones(planes * n)), wide
    for key in ("linear", "angular"):
        assert np.array_equal(np.bincount(cover[key], minlength=n), np.ones(n)), key
    assert cover["owners"] == min(blocks, n // 32)


def ballistic_grid(n: int, dc: int, sms: int) -> int:
    """avbd_ballistic_step's grid: a block for each 32 bodies or for each
    BAL_SLOT_WARPS x 32 slots, whichever is more, at most
    STAGE_BLOCKS_PER_SM blocks an SM."""
    g = stage_geometry()
    return min(max(-(-dc * n // (32 * g["BAL_SLOT_WARPS"])), -(-n // 32)),
               g["STAGE_BLOCKS_PER_SM"] * sms)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("dc", [12, 16])
@pytest.mark.parametrize("n", [128, 1024, 2048, 16384])
def test_ballistic_grid_covers_every_entry_once(n, dc, sms):
    """k_ballistic_step's grid (a block for each 32 bodies or each 256
    slots, at most two blocks an SM) and its loops written out: slot thread
    t of the grid takes slots t, t + stride, ... (stride: every slot thread
    of the grid), each slot (DC planes of N) once; each half of every body
    once (``body_halves``).  Stress1000's shape (N = 1024, DC = 12) takes
    48 blocks, Stress2048's 96."""
    g = stage_geometry()
    blocks = ballistic_grid(n, dc, sms)
    assert 1 <= blocks <= 2 * sms
    if sms == 132 and dc == 12 and n in (1024, 2048):
        assert blocks == {1024: 48, 2048: 96}[n]
    stride = blocks * 32 * g["BAL_SLOT_WARPS"]
    t = (np.arange(stride)[None, :] + stride * np.arange(-(-dc * n // stride))[:, None])
    t = t.reshape(-1)
    assert np.array_equal(np.bincount(t[t < dc * n], minlength=dc * n), np.ones(dc * n))
    cover = body_halves(n, blocks)
    for key in ("linear", "angular"):
        assert np.array_equal(np.bincount(cover[key], minlength=n), np.ones(n)), key
    assert cover["owners"] == min(blocks, n // 32)


def test_kernel_parameter_block_matches_struct():
    """kernels._PARAM_NAMES is the field order of struct KParams."""
    with open(os.path.join(REPO, "avbd3d_tpu_torch", "csrc", "avbd_common.cuh")) as f:
        src = f.read()
    body = src[src.index("struct KParams {"):src.index("};", src.index("struct KParams {"))]
    names = []
    for m in re.finditer(r"float (\w+)(?:\[(\d)\])?;", body):
        n = int(m.group(2) or 1)
        names += [m.group(1)] if n == 1 else [f"{m.group(1)}_{k}" for k in range(n)]
    assert tuple(names) == kernels._PARAM_NAMES
    vals = kernels.param_block(load_scene("Stress1000", device="cpu").params)
    assert len(vals) == len(names) and all(np.isfinite(vals))


def test_host_reads_one_per_step():
    sc = load_scene("Ground", device="cpu")
    solver.step.host_reads = 0
    run_steps(sc.world, sc.params, sc.cap, 4)
    assert solver.step.host_reads == 4


def touching_pile(nx, ny, nz, min_bodies, device):
    """Ground + a pile of unit cubes whose layers overlap by 2 mm (contacts
    from the first step), with the Stress tuning and the 28/16 plan."""
    sb = SceneBuilder()
    sb.add_body((100, 1, 100), 0.0, 0.5, (0, -0.5, 0))
    for y in range(ny):
        for z in range(nz):
            for x in range(nx):
                sb.add_body((1, 1, 1), 1.0, 0.5,
                            ((x - (nx - 1) / 2) * 1.01, 0.499 + y * 0.998,
                             (z - (nz - 1) / 2) * 1.01 + 0.003 * y))
    params = SolverParams(iterations=20, beta=30000.0, gamma=0.995,
                          lhs_fresh_rebuild_every=4)
    arrays, params, cap, _ = sb.build(params, max_degree=28, cache_degree=16,
                                      min_bodies=min_bodies)
    return world_from_arrays(arrays, device), params, cap


def test_grid_step_on_cpu_runs_plain_versions():
    """A grid-tier step on CPU tensors: the K5/K6 wrappers take their plain
    versions (no kernel launch), one host read per step, contacts found."""
    w, p, cap = touching_pile(4, 2, 4, 1024, "cpu")
    cap = cap.replace(backend="grid")        # N = 1024 takes the fused path on "auto"
    solver_grid.reset_launch_counts()
    solver.step.host_reads = 0
    w = run_steps(w, p, cap, 2)
    assert solver.step.last_path == "grid" and solver.step.host_reads == 2
    assert solver_grid.collide_grid.launches == 0 and solver_grid.iterblock_grid.launches == 0
    d = w.diagnostics.as_dict()
    assert d["active_manifolds"] >= 32 and d["sanitized"] == 0 and d["pair_overflow"] == 0
    assert d["gate_speed_sq"] == 1.0e9      # finalize resets the control lanes


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version (N = 1024 widths).
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_stress():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    kernels.build()
    sc = load_scene("Stress1000", device="cuda")
    return sc, run_steps(sc.world, sc.params, sc.cap, 160)


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [24, 4, 40])
def test_cuda_candidate_lists_match_plain(cuda_stress, degree):
    """The refresh kernels (csrc/bp_refresh.cu) against the plain version on
    the same card tensors, at a landing Stress1000 state at its width, at D
    = 4 (rows past the width: the bisection) and D = 40, and at RodJointed
    (exclusion columns): nb, key, thr, cand, dropped identical, slack bit for
    bit; one count a call, none for the plain version."""
    sc, w = cuda_stress
    rod = load_scene("RodJointed", device="cuda")
    dropped = []
    for world, margin in ((w, sc.params.bp_margin),
                          (run_steps(rod.world, rod.params, rod.cap, 50), rod.params.bp_margin)):
        b = world.bodies
        broadphase.candidate_lists.launches = 0
        got = build_bp_cache(b, world.exclusions, degree, margin)
        half = tuple(b.size[k] * 0.5 for k in range(3))
        want = broadphase.cache_from_lists(b, broadphase.candidate_lists_plain(
            b.pos, b.quat, half, b.radius, b.dynamic, world.exclusions, degree, margin))
        for f in ("nb", "key", "thr", "cand", "dropped"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(got.slack.view(torch.int32), want.slack.view(torch.int32))
        assert broadphase.candidate_lists.launches == 1
        dropped.append(int(got.dropped))
    assert (dropped[0] > 0) == (degree == 4), dropped


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0.0, 1e-3, 0.05])
def test_cuda_refresh_needed_matches_plain(cuda_stress, shift):
    """The predicate kernel against its plain version on the landing
    Stress1000 state, every dynamic body moved by a seeded draw of scale
    ``shift``: the bool equal, dev_raw bit for bit and the bits of K2's lane
    4, dev_mm within 1e-5 relative and the bits of K2's lane 3; one count a
    call."""
    sc, w = cuda_stress
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    b, bp, margin = w.bodies, w.bp, sc.params.bp_margin
    g = torch.Generator().manual_seed(3)
    step = shift * torch.randn(b.pos.shape, generator=g).to("cuda")
    b = b.replace(pos=b.pos + (b.inv_mass > 0)[None] * step)
    broadphase.refresh_needed.launches = 0
    need = broadphase.refresh_needed(bp, b, margin)
    assert broadphase.refresh_needed.launches == 1
    assert bool(need) == bool(broadphase.refresh_needed_plain(bp, b, margin))
    assert bool(need) == (shift > 0.01)
    _need, devs = kernels.launch_refresh_needed(b, bp.anchor, bp.anchor_quat, bp.slack, margin)
    mm, raw = broadphase.anchor_deviation(b.pos, b.quat, b.radius, b.dynamic, bp.anchor,
                                          bp.anchor_quat)
    lanes = solver_cuda.control_lanes(bp.nb, b, bp.anchor, bp.anchor_quat, sc.params)
    assert torch.equal(devs[1].view(torch.int32), raw.view(torch.int32))
    assert abs(float(devs[0]) - float(mm)) <= 1e-6 + 1e-5 * abs(float(mm))
    assert torch.equal(devs.view(torch.int32), lanes[3:5].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("comp", [1, 0], ids=["pos.y", "pos.x"])
def test_cuda_anchor_folds_keep_nan(cuda_stress, comp):
    """K2 and the predicate kernel at a NaN pose (one dynamic body's pos.y
    or pos.x NaN after its lists were built) against their plain versions,
    whose torch.maximum / torch.min / torch.max keep the NaN: K2's five
    lanes the plain version's (a NaN matching a NaN: the min gap, dev_mm
    and dev_raw NaN), the predicate's deviations those of anchor_deviation
    and K2's lanes 3 and 4, its bool the plain version's (False: a NaN
    breaks no bound)."""
    sc, w = cuda_stress
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    b, bp, margin = nan_pose(w, comp).bodies, w.bp, sc.params.bp_margin
    args = (bp.nb, b, bp.anchor, bp.anchor_quat, sc.params)
    lk, lp = solver_cuda.control_lanes(*args), solver_cuda.control_lanes_plain(*args)
    need, devs = kernels.launch_refresh_needed(b, bp.anchor, bp.anchor_quat, bp.slack, margin)
    mm, raw = broadphase.anchor_deviation(b.pos, b.quat, b.radius, b.dynamic, bp.anchor,
                                          bp.anchor_quat)
    torch.cuda.synchronize()
    assert equal_nan(lk, lp), (lk, lp)
    assert bool(torch.isnan(lk[[2, 3, 4]]).all()), lk
    assert equal_nan(devs, torch.stack([mm, raw])) and equal_nan(devs, lk[3:5]), devs
    assert bool(need) == bool(broadphase.refresh_needed_plain(bp, b, margin)) is False


@pytest.mark.cuda
def test_cuda_step_kernel_matches_plain(cuda_stress):
    sc, w = cuda_stress
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    bp = w.bp
    args = (w.contacts, bp.nb, bp.key, bp.thr, w.bodies, bp.anchor, bp.anchor_quat,
            sc.params, 20, 4, bp.cand)
    cp, bp_, dp, _ = solver_cuda.step_kernel_plain(*args)
    ck, bk, dk, _ = solver_cuda.step_kernel(*args)
    torch.cuda.synchronize()
    for f in ("other", "count", "feature", "stick"):
        assert torch.equal(getattr(cp, f), getattr(ck, f)), f
    for x, y in zip(bp_, bk):
        assert float((x - y).abs().max()) <= 1e-5
    assert torch.equal(dp[0, 5:10], dk[0, 5:10])


@pytest.mark.cuda
def test_cuda_control_lanes_match_plain(cuda_stress):
    """K2 against control_lanes_plain at a landing Stress1000 state: lanes
    0, 1, 2, 4 (mins and maxes) bit for bit, lane 3 (world-wide sums in a
    fixed order of the kernel's own) within 1e-5; a second call gives the
    same bits in a tensor of its own."""
    sc, w = cuda_stress
    b, bp = w.bodies, w.bp
    args = (bp.nb, b, bp.anchor, bp.anchor_quat, sc.params)
    lk = solver_cuda.control_lanes(*args)
    again = solver_cuda.control_lanes(*args)
    lp = solver_cuda.control_lanes_plain(*args)
    torch.cuda.synchronize()
    exact = [0, 1, 2, 4]
    assert torch.equal(lk[exact].view(torch.int32), lp[exact].view(torch.int32))
    torch.testing.assert_close(lk[3], lp[3], rtol=1e-5, atol=1e-6)
    assert torch.equal(lk.view(torch.int32), again.view(torch.int32))
    assert lk.data_ptr() != again.data_ptr()


@pytest.mark.cuda
def test_cuda_control_lanes_batch_matches_single_worlds(cuda_stress):
    """K2 over a batch of 3 worlds (one launch, grid.y = 3) gives each
    world the bits of its own launch, and the vmapped plain version's lanes
    0, 1, 2, 4 bit for bit, lane 3 within 1e-5."""
    from avbd3d_tpu_torch.parallel import replicate_world, world_at

    sc, w = cuda_stress
    worlds = replicate_world(w, 3)
    kick = torch.tensor([0.0, 0.5, 3.0], device="cuda")
    worlds = worlds.replace(bodies=worlds.bodies.replace(
        linvel=worlds.bodies.linvel + kick[:, None, None, None]))
    b, bp = worlds.bodies, worlds.bp
    args = (bp.nb, b, bp.anchor, bp.anchor_quat, sc.params)
    lk = solver_cuda.control_lanes(*args)
    lp = solver_cuda.control_lanes_plain(*args)
    assert lk.shape == (3, 5)
    for i in range(3):
        wi = world_at(worlds, i)
        one = solver_cuda.control_lanes(wi.bp.nb, wi.bodies, wi.bp.anchor, wi.bp.anchor_quat,
                                        sc.params)
        assert torch.equal(lk[i].view(torch.int32), one.view(torch.int32)), i
    exact = [0, 1, 2, 4]
    assert torch.equal(lk[:, exact].view(torch.int32), lp[:, exact].view(torch.int32))
    torch.testing.assert_close(lk[:, 3], lp[:, 3], rtol=1e-5, atol=1e-6)
    assert not torch.equal(lk[0], lk[2])


@pytest.mark.cuda
def test_cuda_bp_probe_matches_plain(cuda_stress):
    """K7 against bp_probe_plain at a landing Stress1000 state and on a
    world without slots: n_slots and near identical, min_sep bit for bit;
    the refined gate launches it once and reads nothing back."""
    sc, w = cuda_stress
    p = sc.params
    solver_cuda.reset_launch_counts()
    for world in (w, load_scene("Ground", device="cuda").world):
        sp, np_, nearp = solver_cuda.bp_probe_plain(world.bp.nb, world.bodies, p)
        sk, nk, neark = solver_cuda.bp_probe(world.bp.nb, world.bodies, p)
        torch.cuda.synchronize()
        assert torch.equal(sp.view(torch.int32), sk.view(torch.int32))
        assert int(np_) == int(nk) and torch.equal(nearp, neark)
        assert neark.dtype == torch.bool and nk.dtype == torch.int32
    assert int(nk) == 0 and float(sk) == 1.0e9
    assert solver_cuda.bp_probe.launches == 2
    # Two calls in a row return tensors of their own.
    first, second = (solver_cuda.bp_probe(w.bp.nb, w.bodies, p) for _ in range(2))
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    solver_cuda.reset_launch_counts()
    reads = solver.step.host_reads
    ok = solver.stale_lhs_ok(w.bodies, w.bp, p)
    assert solver_cuda.bp_probe.launches == 1 and solver.step.host_reads == reads
    assert ok.device.type == "cuda" and ok.shape == ()
    assert bool(ok) or not bool(solver.stale_lhs_ok(w.bodies, w.bp, p, refine=False))
    with pytest.raises(TypeError, match="nb"):
        solver_cuda.bp_probe(w.bp.nb.float(), w.bodies, p)


@pytest.fixture
def cuda_grid():
    """Stress4096's widths (N = 5120, D = 28, DC = 16) on a touching 16^3
    pile after 20 grid steps, with the next step's broadphase cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    kernels.build()
    w, p, cap = touching_pile(16, 16, 16, 0, "cuda")
    w = run_steps(w, p, cap, 20)
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, cap.max_degree, p.bp_margin))
    return w, p, cap


@pytest.mark.cuda
def test_cuda_collide_grid_matches_plain(cuda_grid):
    w, p, cap = cuda_grid
    args = (w.contacts, w.bp.nb, w.bp.key, w.bp.thr, w.bodies, p)
    cp, kp, op, dp = solver_grid.collide_grid_plain(*args)
    ck, kk, ok, dk = solver_grid.collide_grid(*args)
    torch.cuda.synchronize()
    for f in solver_cuda.CACHE_FIELDS:
        a, b = getattr(cp, f), getattr(ck, f)
        if a.dtype.is_floating_point:
            assert float(((a - b).abs() / (a.abs() + 1.0)).max()) <= 1e-5, f
        else:
            assert torch.equal(a, b), f
    assert torch.equal(kp, kk) and torch.equal(op, ok) and int(dp) == int(dk)
    assert int((ck.count > 0).sum()) > 10000


@pytest.mark.cuda
def test_cuda_iterblock_grid_matches_plain(cuda_grid):
    w, p, cap = cuda_grid
    c = solver_grid.collide_grid(w.contacts, w.bp.nb, w.bp.key, w.bp.thr, w.bodies, p)[0]
    b, g = w.bodies, w.bodies.g
    _lv, _av, ip, iq, ps, qs, _s = solver.predict(b, p)

    def cg(a):
        return a.T.contiguous().reshape(a.shape[1], g, 128)

    spec = solver_grid.grid_specs(p, p.iterations, p.lhs_rebuild_every, cap.grid_residency)[0]
    args = (p, solver_grid.pick_gb(g), spec, c, b, cg(ps), cg(qs), c.lam, c.penalty,
            c.stick.to(torch.float32), cg(ip), cg(iq))
    outs_p = solver_grid.iterblock_grid_plain(*args)
    outs_k = solver_grid.iterblock_grid(*args)
    torch.cuda.synchronize()
    assert torch.equal(outs_p[4], outs_k[4])                     # stick latches
    for i in (0, 1, 5):                                          # pos, quat, sep
        assert float((outs_p[i] - outs_k[i]).abs().max()) <= 1e-5
    for i in (2, 3):                                             # lam, penalty
        assert float(((outs_p[i] - outs_k[i]).abs() / (outs_p[i].abs() + 1.0)).max()) <= 1e-5


GRID_STAGE_STATES = ("pile", "fallen", "static", "nan velocity")
# Poses that the prediction's sanitizes meet: one dynamic body's pos.y NaN,
# and one at pos.x 3.4e38 moving at linvel.x 3e38, whose pos + linvel dt
# passes the largest float32 (inertial position and warm start infinite).
POSE_STATES = ("nan pose", "overflow")


def pose_state(w, name):
    """``w`` at a state of POSE_STATES (the 8th dynamic body's pos.y NaN, or
    the first dynamic body at pos.x 3.4e38 with linvel.x 3e38)."""
    if name == "nan pose":
        return nan_pose(w, 1)
    b = w.bodies
    i = int(torch.nonzero((b.inv_mass > 0).reshape(-1)).flatten()[0])
    pos, lv = b.pos.clone(), b.linvel.clone()
    pos.view(3, -1)[0, i] = 3.4e38
    lv.view(3, -1)[0, i] = 3.0e38
    return w.replace(bodies=b.replace(pos=pos, linvel=lv))


def close_or_same(a: float, b: float, rtol: float = 1e-5, atol: float = 1e-6) -> bool:
    """|a - b| <= atol + rtol |b| for finite b; otherwise the same value (a
    NaN matching a NaN, an infinity the same infinity)."""
    if not np.isfinite(b):
        return (np.isnan(a) and np.isnan(b)) or a == b
    return abs(a - b) <= atol + rtol * abs(b)


def grid_stage_world(cuda_grid, name):
    """The grid pile of ``cuda_grid`` as it is, with three dynamic bodies
    below ``fall_freeze_y``, with every body static, or with a NaN and an
    infinite velocity."""
    w, p, cap = cuda_grid
    b = w.bodies
    ids = torch.nonzero((b.inv_mass > 0).reshape(-1)).flatten()[:3]
    if name == "fallen":
        pos = b.pos.clone()
        pos.view(3, -1)[1, ids] = p.fall_freeze_y - 1.0
        b = b.replace(pos=pos)
    if name == "static":
        b = b.replace(inv_mass=torch.zeros_like(b.inv_mass))
    if name == "nan velocity":
        lv, av = b.linvel.clone(), b.angvel.clone()
        lv.view(3, -1)[0, ids[0]] = float("nan")
        av.view(3, -1)[1, ids[1]] = float("inf")
        b = b.replace(linvel=lv, angvel=av)
    if name in POSE_STATES:
        return pose_state(w, name)
    return w.replace(bodies=b)


def same_bits(a, b):
    """Equal tensors, floats as their 32-bit words (a NaN matches a NaN)."""
    if a.dtype == torch.float32:
        na, nb = torch.isnan(a), torch.isnan(b)
        return torch.equal(na, nb) and torch.equal(torch.where(na, 0, a.view(torch.int32)),
                                                   torch.where(nb, 0, b.view(torch.int32)))
    return torch.equal(a, b)


def grid_finalize_args(w, b, p, cap, predicted, nan_pose=False):
    """grid_finalize's operands at the next grid step of ``w`` (its frozen
    bodies ``b``) after the prediction ``predicted`` (grid_predict's
    outputs): K5, one launch of K6; ``nan_pose``: K6's last position of one
    body NaN."""
    lv, av, ip, iq, ps, stickf, san = predicted
    bp = w.bp
    c, kept, once, dropped = solver_grid.collide_grid(w.contacts, bp.nb, bp.key, bp.thr, b, p,
                                                      stickf=stickf)
    spec = solver_grid.grid_specs(p, p.iterations, p.lhs_rebuild_every, cap.grid_residency)[0]
    pos, quat, lam, pen, stick, sep = solver_grid.iterblock_grid(
        p, solver_grid.pick_gb(b.g), spec, c, b, ps, iq, c.lam, c.penalty, c.stick, ip, iq)
    if nan_pose:
        pos.view(3, -1)[2, 7] = float("nan")
    c = c.replace(lam=lam, penalty=pen, stick=stick)
    return (w, b, c, pos, quat, lv, av, san, sep, once, kept, bp.cand, dropped, p)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRID_STAGE_STATES + POSE_STATES)
def test_cuda_grid_stages_match_plain(cuda_grid, name):
    """The grid step's stage kernels (csrc/grid_stages.cu) against their
    plain versions on the same card tensors: k_grid_gates' flags, dev_raw,
    v^2 max and frozen fields bit for bit, dev_mm within 1e-5 relative (a
    non-finite one the same value); k_grid_predict's outputs bit for bit
    (at the overflowed pose an infinite inertial position, the warm start
    sanitized); k_grid_finalize's bodies and latches bit for bit, its
    diagnostics lanes identical but the speeds (2, 3: torch's vector_norm)
    within 1e-6 relative; one count a call."""
    _w, p, cap = cuda_grid
    w = grid_stage_world(cuda_grid, name)
    solver_grid.reset_launch_counts()
    wk, gk = solver_grid.grid_gates(w, p)
    wp, gp = solver_grid.grid_gates_plain(w, p)
    assert same_bits(gk[[0, 1, 2, 4, 5]], gp[[0, 1, 2, 4, 5]]), (gk, gp)
    assert close_or_same(float(gk[3]), float(gp[3])), (gk, gp)
    for f in ("linvel", "angvel", "inv_mass"):
        assert same_bits(getattr(wk.bodies, f), getattr(wp.bodies, f)), f
    b = wp.bodies
    pk = solver_grid.grid_predict(b, w.contacts.stick, p)
    pp = solver_grid.grid_predict_plain(b, w.contacts.stick, p)
    for i, (x, y) in enumerate(zip(pk, pp)):
        assert same_bits(x, y), i
    if name == "nan velocity":
        assert int(pk[6]) == 2
    if name == "overflow":
        assert bool(torch.isinf(pk[2]).any()) and torch.isfinite(pk[4]).all() and int(pk[6]) >= 1
    if name == "nan pose":
        assert int(pk[6]) >= 1
    args = grid_finalize_args(w, b, p, cap, pp, nan_pose=name == "nan velocity")
    fk, fp = solver_grid.grid_finalize(*args), solver_grid.grid_finalize_plain(*args)
    for f in ("pos", "quat", "linvel", "angvel", "prev_linvel", "prev_angvel"):
        assert same_bits(getattr(fk.bodies, f), getattr(fp.bodies, f)), f
    assert torch.equal(fk.contacts.stick, fp.contacts.stick)
    dk, dp = fk.diagnostics.vec, fp.diagnostics.vec
    lanes = [0, 1, 4] + list(range(5, 16))
    assert same_bits(dk[lanes], dp[lanes]), (dk, dp)
    assert float(((dk[2:4] - dp[2:4]).abs() / dp[2:4].abs().clamp(min=1e-30)).max()) <= 1e-6
    if name == "nan velocity":
        assert float(dk[8]) >= 3
    assert (solver_grid.grid_gates.launches, solver_grid.grid_predict.launches,
            solver_grid.grid_finalize.launches) == (1, 1, 1)


def equal_nan(a, b):
    """Equal values, a NaN matching a NaN (zeros of either sign equal)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


# (k_grid_finalize's blocks, k_step_gates' threads a block) of the builds
# the folds are held at: the main build's (None), then builds with those
# defines.
FOLD_GEOMETRY = ((None, None), (1, 32), (4, 64), (64, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("sep_state", ["nan_sep", "zero_sep"])
def test_cuda_finalize_and_step_gates_folds_match_plain(cuda_grid, cuda_rain, sep_state):
    """k_grid_finalize (its grid sized to the card, its lanes folded by
    atomics into ten words) at the two separations that pin its fold, one
    live slot's NaN (lanes 0 and 1 NaN) and every one +0 (lane 0 folds -0
    against the +0 start: +0; lane 1 the slop), at its own grid and through
    builds at 1, 4 and 64 blocks (FOLD_GEOMETRY): bodies and latches bit
    for bit the plain version's, the lanes equal (a NaN matching a NaN),
    lanes 0 and 1 those values with their sign bits, the speeds within 1e-6
    relative, its words and ticket 0 after.  k_step_gates (a thread a float
    of the frozen fields) at its 128 threads a block and through those
    builds at 32, 64 and 256, at the rain-in state with three bodies
    fallen: the control vector and the frozen fields bit for bit.
    k_launch_floor in its three cases: nothing written, a copy, the
    frozen bodies' floats zeroed."""
    w, p, cap = cuda_grid
    wp, _gp = solver_grid.grid_gates_plain(w, p)
    b = wp.bodies
    args = grid_finalize_args(w, b, p, cap,
                              solver_grid.grid_predict_plain(b, w.contacts.stick, p))
    c, sep = args[2], args[8]
    if sep_state == "nan_sep":
        live = torch.nonzero(((c.count > 0) & (c.other >= 0)).reshape(-1))
        sep[0].view(-1)[int(live[len(live) // 2])] = float("nan")
    else:
        sep.zero_()
    fp = solver_grid.grid_finalize_plain(*args)
    dp = fp.diagnostics.vec
    want = [float("nan")] * 2 if sep_state == "nan_sep" else [0.0, p.penetration_slop]
    assert equal_nan(dp[:2], torch.tensor(want, device="cuda")), dp
    want = torch.tensor(want, device="cuda")
    names = ("pos", "quat", "linvel", "angvel", "prev_linvel", "prev_angvel")
    sc, rain, _land = cuda_rain
    sp = sc.params
    fallen = fused_stage_world(rain, sp, "fallen")
    gw, gctl = solver.step_gates_plain(fallen, sp)
    fb, fbp = fallen.bodies, fallen.bp
    for blocks, threads in FOLD_GEOMETRY:
        defines = () if blocks is None else (f"AVBD_FIN_BLOCKS={blocks}",
                                             f"AVBD_GATES_THREADS={threads}")
        with kernels.using(kernels.build(defines=defines)):
            out = kernels.launch_grid_finalize(b, *args[3:8], c, *args[8:])
            lv, av, im, ctl = kernels.launch_step_gates(fb, fallen.diagnostics.vec, fbp.slack,
                                                        fbp.dropped, sp)
        torch.cuda.synchronize()
        for f, t in zip(names, out[:6]):
            assert same_bits(t, getattr(fp.bodies, f)), (blocks, f)
        assert torch.equal(out[6], fp.contacts.stick), blocks
        dk = out[7]
        lanes = [0, 1, 4] + list(range(5, 16))
        assert equal_nan(dk[lanes], dp[lanes]), (blocks, dk, dp)
        assert equal_nan(dk[:2], want) and torch.equal(torch.signbit(dk[:2]),
                                                       torch.signbit(want)), (blocks, dk)
        assert float(((dk[2:4] - dp[2:4]).abs() / dp[2:4].abs().clamp(min=1e-30)).max()) <= 1e-6
        assert int(kernels._SCRATCH[(0, torch.cuda.current_stream().cuda_stream,
                                     "finalize_fold_ticket")].count_nonzero()) == 0
        assert same_bits(ctl, gctl), threads
        for t, f in ((lv, "linvel"), (av, "angvel"), (im, "inv_mass")):
            assert same_bits(t, getattr(gw.bodies, f)), (threads, f)
    src = torch.arange(7 * fb.n, dtype=torch.float32, device="cuda")
    frozen = (fb.inv_mass > 0) & (fb.pos[1] < sp.fall_freeze_y)
    for loads, expect in ((0, torch.zeros_like(src)), (1, src),
                          (3, torch.where(frozen.reshape(1, -1), 0.0, src.view(7, -1)))):
        dst = torch.zeros_like(src)
        kernels.launch_floor(fb, src, dst, loads, sp.fall_freeze_y)
        torch.cuda.synchronize()
        assert same_bits(dst, expect.reshape(-1)), loads
    assert int(frozen.sum()) >= 3


def fold_words(name: str) -> int:
    """The nonzero words left in the scratch ``name`` (a kernel's fold
    words and ticket) on the current stream."""
    return int(kernels._SCRATCH[(0, torch.cuda.current_stream().cuda_stream,
                                 name)].count_nonzero())


def unaligned(t):
    """A copy of ``t`` in a buffer one byte past an aligned one (contiguous,
    its data pointer odd)."""
    flat = torch.empty(t.numel() * t.element_size() + 1, dtype=torch.uint8, device=t.device)
    out = flat[1:].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


# (k_grid_predict's blocks, k_ballistic_step's blocks) of the builds the
# folds are held at: the main build's (None), then builds with those
# defines.
PB_GEOMETRY = ((None, None), (1, 1), (4, 4), (64, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["nan velocity", "overflow"])
def test_cuda_predict_and_ballistic_folds_match_plain(cuda_grid, cuda_rain, state):
    """k_grid_predict and k_ballistic_step (grids sized to the card, the
    sanitize count and the ballistic lanes folded by atomics) at their own
    grids and through builds at 1, 4 and 64 blocks (PB_GEOMETRY, defines
    AVBD_PRED_BLOCKS and AVBD_BAL_BLOCKS): the prediction at the grid
    pile's ``state`` bit for bit grid_predict_plain's, the latches also from
    a buffer not aligned for the wide copy; the ballistic step at the
    landing Stress1000 state (live slots: lane 0 folds -0 and +0) and at
    ``state`` of the rain-in bit for bit _ballistic_body's, lanes 0 and 1
    with their sign bits, the speed lanes within 1e-6 relative; every fold
    word and ticket 0 after each launch."""
    _w, p, _cap = cuda_grid
    b = solver_grid.grid_gates_plain(grid_stage_world(cuda_grid, state), p)[0].bodies
    stick = cuda_grid[0].contacts.stick
    want_p = solver_grid.grid_predict_plain(b, stick, p)
    sc, rain, land = cuda_rain
    sp = sc.params
    worlds = [solver.step_gates_plain(w, sp)[0]
              for w in (land, fused_stage_world(rain, sp, state))]
    want_b = [solver._ballistic_body(w, sp) for w in worlds]
    assert bool(((torch.arange(4, device="cuda").view(4, 1, 1, 1) < land.contacts.count)
                 & (land.contacts.other >= 0)).any())
    names = ("pos", "quat", "linvel", "angvel", "prev_linvel", "prev_angvel")
    for pred_blocks, bal_blocks in PB_GEOMETRY:
        defines = () if pred_blocks is None else (f"AVBD_PRED_BLOCKS={pred_blocks}",
                                                  f"AVBD_BAL_BLOCKS={bal_blocks}")
        with kernels.using(kernels.build(defines=defines)):
            for latches in (stick, unaligned(stick)):
                got = kernels.launch_grid_predict(b, latches, p)
                torch.cuda.synchronize()
                for i, (x, y) in enumerate(zip(got, want_p)):
                    assert same_bits(x, y), (pred_blocks, i)
                assert fold_words("predict_fold_ticket") == 0, pred_blocks
            for w, ref in zip(worlds, want_b):
                out = kernels.launch_ballistic_step(w.bodies, w.contacts, sp)
                torch.cuda.synchronize()
                for f, t in zip(names, out[:6]):
                    assert same_bits(t, getattr(ref.bodies, f)), (bal_blocks, f)
                dk, dp = out[6], ref.diagnostics.vec
                lanes = [0, 1, 4] + list(range(5, 16))
                assert same_bits(dk[lanes], dp[lanes]), (bal_blocks, dk, dp)
                assert torch.equal(torch.signbit(dk[:2]), torch.signbit(dp[:2])), (dk, dp)
                assert float(((dk[2:4] - dp[2:4]).abs()
                              / dp[2:4].abs().clamp(min=1e-30)).max()) <= 1e-6
                assert fold_words("ballistic_fold_ticket") == 0, bal_blocks


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRID_STAGE_STATES)
def test_cuda_grid_gates_deviations_are_the_shared_fold(cuda_grid, name):
    """k_grid_gates (one cooperative launch: a grid barrier, then every
    block folds the group partials and its own bodies' deviations) gives
    dev_mm and dev_raw bit for bit k_refresh_needed's on the frozen bodies
    (the fold K2 and the predicate share, which the gates kernel once ran
    in one block), in one launch, with its ticket 0 after."""
    _w, p, _cap = cuda_grid
    w = grid_stage_world(cuda_grid, name)
    solver_grid.reset_launch_counts()
    wk, gk = solver_grid.grid_gates(w, p)
    bp = w.bp
    _need, devs = kernels.launch_refresh_needed(wk.bodies, bp.anchor, bp.anchor_quat, bp.slack,
                                                p.bp_margin)
    torch.cuda.synchronize()
    assert same_bits(gk[3:5], devs), (gk, devs)
    assert solver_grid.grid_gates.launches == 1
    tickets = {k[2]: int(t.count_nonzero()) for k, t in kernels._SCRATCH.items()
               if "ticket" in k[2]}
    assert not any(tickets.values()), tickets


def nan_pose(world, comp):
    """``world`` with the 8th dynamic body's ``pos[comp]`` NaN, its lists,
    cache and diagnostics those of the finite world."""
    b = world.bodies
    i = int(torch.nonzero((b.inv_mass > 0).reshape(-1)).flatten()[7])
    pos = b.pos.clone()
    pos.view(3, -1)[comp, i] = float("nan")
    return world.replace(bodies=b.replace(pos=pos))


def float_diff(a, b):
    """Largest |a - b|: NaN on both sides counts 0, on one side inf."""
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, 0.0, (a - b).abs())
    return float(torch.where(torch.isnan(d), float("inf"), d).max())


def assert_cache_equal(cp, ck):
    for f in solver_cuda.CACHE_FIELDS:
        a, b = getattr(cp, f), getattr(ck, f)
        if a.dtype.is_floating_point:
            assert float_diff(a, b) == 0.0, f
        else:
            assert torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("comp", [1, 0], ids=["pos.y", "pos.x"])
@pytest.mark.parametrize("kernel", ["K1", "K3", "K5"])
def test_cuda_kernels_match_plain_at_nan_pose(cuda_stress, cuda_grid, kernel, comp):
    """K1, K3 and K5 at a NaN pose (one dynamic body's pos.y or pos.x NaN
    after its lists were built) against their plain versions: integers
    identical, floats difference 0 with a NaN matching a NaN; the precull
    (k_filter_cull, which all three run) culls a slot whose separation is
    NaN, as torch.maximum does."""
    if kernel == "K5":
        w, p, _cap = cuda_grid
        args = (w.contacts, w.bp.nb, w.bp.key, w.bp.thr, nan_pose(w, comp).bodies, p)
        cp, kp, op, dp = solver_grid.collide_grid_plain(*args)
        ck, kk, ok, dk = solver_grid.collide_grid(*args)
        torch.cuda.synchronize()
        assert_cache_equal(cp, ck)
        assert torch.equal(kp, kk) and torch.equal(op, ok) and int(dp) == int(dk)
        return
    sc, w = cuda_stress
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    b, bp = nan_pose(w, comp).bodies, w.bp
    if kernel == "K3":
        args = (w.contacts, bp.nb, bp.key, bp.thr, b, sc.params)
        cp, kp, dp = solver_cuda.collide_half(*args)
        ck, kk, dk = solver_cuda.collide_and_init(*args)
        torch.cuda.synchronize()
        assert_cache_equal(cp, ck)
        assert int(kp) == int(kk) and int(dp) == int(dk)
        return
    args = (w.contacts, bp.nb, bp.key, bp.thr, b, bp.anchor, bp.anchor_quat, sc.params, 20, 4,
            bp.cand)
    cp, bp_, dp, _ = solver_cuda.step_kernel_plain(*args)
    ck, bk, dk, _ = solver_cuda.step_kernel(*args)
    torch.cuda.synchronize()
    assert_cache_equal(cp, ck)
    for i, (x, y) in enumerate(zip(bp_, bk)):
        assert float_diff(x, y) == 0.0, i
    assert torch.equal(dp[0, 5:10], dk[0, 5:10]) and torch.equal(dp[1, 5:11], dk[1, 5:11])


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_block", kernels.BP_ROWS_PER_BLOCK)
def test_cuda_candidate_lists_past_the_row_buffer(cuda_grid, rows_per_block):
    """k_bp_lists on the 16^3 pile at Stress4096's widths with a 2.5 m
    margin, whose rows hold more masked columns than the kernel's per-row
    buffer (its cut to the D smallest keys), with 8, 16 and 32 rows a
    block and on two halves of the rows (a sharded call, ``row0``): nb,
    key, thr, cand identical to the plain version, slack bit for bit."""
    sys.path.insert(0, REPO)
    import chip_smoke

    w, _p, cap = cuda_grid
    b, degree, margin = w.bodies, cap.max_degree, 2.5
    assert int(chip_smoke.masked_per_row(w, degree, margin).max()) > kernels.BP_ROW_BUFFER
    half = tuple(b.size[k] * 0.5 for k in range(3))
    want = broadphase.candidate_lists_plain(b.pos, b.quat, half, b.radius, b.dynamic,
                                            w.exclusions, degree, margin)
    table, max_wh = kernels.launch_bp_tables(b.pos, b.quat, b.size, 0.5, b.radius, b.inv_mass)
    got = kernels.launch_bp_lists(table, table, max_wh, w.exclusions, degree, margin,
                                  rows_per_block=rows_per_block)
    g2 = b.g // 2
    parts = [kernels.launch_bp_lists(table[g0 * 128:(g0 + g2) * 128], table, max_wh,
                                     w.exclusions[:, g0:g0 + g2].contiguous(), degree, margin,
                                     g0 * 128, rows_per_block=rows_per_block)
             for g0 in (0, g2)]
    torch.cuda.synchronize()
    for k in range(4):
        assert torch.equal(got[k], want[k]), k
    assert same_bits(got[4], want[4])
    for k in range(2):
        assert torch.equal(torch.cat([q[k] for q in parts], dim=-2), want[k]), k
    assert torch.equal(torch.cat([q[2] for q in parts]), want[2])
    assert sum(int(q[3]) for q in parts) == int(want[3])
    assert same_bits(torch.minimum(parts[0][4], parts[1][4]), want[4])


@pytest.fixture
def cuda_rain():
    """Stress1000 after one step (the rain-in: its next step ballistic) and
    after 160 (landing), with the next step's broadphase cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    kernels.build()
    sc = load_scene("Stress1000", device="cuda")
    rain = run_steps(sc.world, sc.params, sc.cap, 1)
    land = run_steps(rain, sc.params, sc.cap, 159)
    land = land.replace(bp=build_bp_cache(land.bodies, land.exclusions, sc.cap.max_degree,
                                          sc.params.bp_margin))
    return sc, rain, land


def fused_stage_world(w, p, name):
    """``w`` as it is, with three dynamic bodies below ``fall_freeze_y``,
    with every body static, or with a NaN and an infinite velocity and a
    spin above the clamp."""
    b = w.bodies
    ids = torch.nonzero((b.inv_mass > 0).reshape(-1)).flatten()[:3]
    if name == "fallen":
        pos = b.pos.clone()
        pos.view(3, -1)[1, ids] = p.fall_freeze_y - 1.0
        b = b.replace(pos=pos)
    if name == "static":
        b = b.replace(inv_mass=torch.zeros_like(b.inv_mass))
    if name == "nan velocity":
        lv, av = b.linvel.clone(), b.angvel.clone()
        lv.view(3, -1)[0, ids[0]] = float("nan")
        av.view(3, -1)[1, ids[1]] = float("inf")
        av.view(3, -1)[2, ids[2]] = 4.0 * p.max_angular_speed
        b = b.replace(linvel=lv, angvel=av)
    if name in POSE_STATES:
        return pose_state(w, name)
    return w.replace(bodies=b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRID_STAGE_STATES + POSE_STATES)
def test_cuda_fused_stages_match_plain(cuda_rain, name):
    """The fused path's stage kernels (csrc/fused_stages.cu) against their
    plain versions on the same card tensors at Stress1000's rain-in state:
    k_step_gates' control vector and frozen fields bit for bit, the world it
    was given unchanged; k_ballistic_step's bodies bit for bit, its lanes
    identical (lanes 0 and 1 with their sign bits) but the speeds (2, 3:
    torch's vector_norm) within 1e-6 relative, at the poses of POSE_STATES
    its sanitize count at least 2 (the NaN pose's warm start and linear
    finalize; the overflowed pose's, whose inertial position is
    infinite); the ballistic step with K2 writing into its lanes 11-15
    (``out=``): those lanes the bits of K2's own call, K2's exact lanes the
    plain version's; one count a call (K2 three: the ballistic step's, its
    own call's and the plain version's, whose lanes on CUDA tensors are
    K2's)."""
    sc, rain, _land = cuda_rain
    p = sc.params
    w = fused_stage_world(rain, p, name)
    linvel = w.bodies.linvel.clone()
    solver_cuda.reset_launch_counts()
    wk, gk = solver.step_gates(w, p)
    wp, gp = solver.step_gates_plain(w, p)
    assert same_bits(gk, gp), (gk, gp)
    for f in ("linvel", "angvel", "inv_mass"):
        assert same_bits(getattr(wk.bodies, f), getattr(wp.bodies, f)), f
    assert same_bits(w.bodies.linvel, linvel)
    out = kernels.launch_ballistic_step(wp.bodies, wp.contacts, p)
    ref = solver._ballistic_body(wp, p)
    names = ("pos", "quat", "linvel", "angvel", "prev_linvel", "prev_angvel")
    for f, t in zip(names, out[:6]):
        assert same_bits(t, getattr(ref.bodies, f)), f
    dk, dp = out[6], ref.diagnostics.vec
    lanes = [0, 1, 4] + list(range(5, 16))
    assert same_bits(dk[lanes], dp[lanes]), (dk, dp)
    assert torch.equal(torch.signbit(dk[:2]), torch.signbit(dp[:2])), (dk, dp)
    assert float(((dk[2:4] - dp[2:4]).abs() / dp[2:4].abs().clamp(min=1e-30)).max()) <= 1e-6
    if name == "overflow":
        assert bool(torch.isinf(out[0]).any()) and int(dk[8]) >= 2, dk
    if name == "nan pose":
        assert int(dk[8]) >= 2, dk
    full, full_p = solver.ballistic_step(wp, p), solver._ballistic_step(wp, p)
    own = solver_cuda.control_lanes(wp.bp.nb, full.bodies, wp.bp.anchor, wp.bp.anchor_quat, p)
    vk, vp = full.diagnostics.vec, full_p.diagnostics.vec
    assert same_bits(vk[11:], own)
    assert same_bits(vk[[11, 12, 13, 15]], vp[[11, 12, 13, 15]]), (vk, vp)
    if name == "nan velocity":
        assert float(dk[8]) >= 2
    assert (solver.step_gates.launches, solver.ballistic_step.launches,
            solver_cuda.control_lanes.launches) == (1, 1, 3)


@pytest.mark.cuda
def test_cuda_step_kernel_state_row_and_latches_match_plain(cuda_rain):
    """K1 at a landing Stress1000 state: its new cache's bool
    latches and its row 1 in the state layout equal the plain version's
    (lanes 0-10 identical, the control lanes within 1e-5 relative), lane 9
    both cand - kept in int32 and in float32; a fused step's diagnostics
    are that row."""
    sc, _rain, w = cuda_rain
    bp = w.bp
    args = (w.contacts, bp.nb, bp.key, bp.thr, w.bodies, bp.anchor, bp.anchor_quat,
            sc.params, 20, 4, bp.cand)
    cp, _bp, dp, _ = solver_cuda.step_kernel_plain(*args)
    ck, _bk, dk, _ = solver_cuda.step_kernel(*args)
    torch.cuda.synchronize()
    assert ck.stick.dtype == torch.bool and torch.equal(cp.stick, ck.stick)
    assert torch.equal(dp[1, :11], dk[1, :11]), (dp[1, :16], dk[1, :16])
    assert rel_err(dp[1, 11:16], dk[1, 11:16]) <= 1e-5
    assert float(dk[1, 9]) == float(bp.cand.float() - dk[0, 9])
    assert float(dk[1, 9]) == float(bp.cand - dk[0, 9].to(torch.int32))
    assert not dk[1, 16:].any() and not dk[2:].any()


def rel_err(a, b):
    return float(((a - b).abs() / (a.abs() + 1.0)).max())


@pytest.mark.cuda
def test_cuda_collide_and_solve_loop_match_plain(cuda_stress):
    """K3 and K4 against collide_half / solve_loop_plain at a landing
    Stress1000 state: integers identical, floats within 1e-5."""
    sc, w = cuda_stress
    p = sc.params
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree, p.bp_margin))
    args = (w.contacts, w.bp.nb, w.bp.key, w.bp.thr, w.bodies, p)
    cp, kp, dp = solver_cuda.collide_half(*args)
    ck, kk, dk = solver_cuda.collide_and_init(*args)
    torch.cuda.synchronize()
    for f in solver_cuda.CACHE_FIELDS:
        a, b = getattr(cp, f), getattr(ck, f)
        if a.dtype.is_floating_point:
            assert rel_err(a, b) <= 1e-5, f
        else:
            assert torch.equal(a, b), f
    assert int(kp) == int(kk) and int(dp) == int(dk)
    bp_, lp, pp, sp, diag_p = solver_cuda.solve_loop_plain(cp, w.bodies, p)
    bk, lk, pk, sk, diag_k = solver_cuda.solve_loop(cp, w.bodies, p)
    torch.cuda.synchronize()
    assert torch.equal(sp, sk) and torch.equal(diag_p[0, 5:9], diag_k[0, 5:9])
    assert float((bp_.pos - bk.pos).abs().max()) <= 1e-5
    assert rel_err(lp, lk) <= 1e-5 and rel_err(pp, pk) <= 1e-5


@pytest.mark.cuda
def test_cuda_step_kernel_with_joints_matches_plain():
    """K1's joint branch on RodJointed (hard welds, 2 colour sub-passes)
    after 30 steps: integers identical, poses and joint duals within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    kernels.build()
    sc = load_scene("RodJointed", device="cuda")
    w = run_steps(sc.world, sc.params, sc.cap, 30)
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    bp = w.bp
    args = (w.contacts, bp.nb, bp.key, bp.thr, w.bodies, bp.anchor, bp.anchor_quat,
            sc.params, 20, 4, bp.cand, w.joints, None, sc.cap.joint_colors)
    cp, bp_, dp, rp = solver_cuda.step_kernel_plain(*args)
    ck, bk, dk, rk = solver_cuda.step_kernel(*args)
    torch.cuda.synchronize()
    assert sc.cap.joint_colors == 2 and rk[2] is None
    for x, y in zip(bp_, bk):
        assert float((x - y).abs().max()) <= 1e-5
    assert torch.equal(dp[0, 5:10], dk[0, 5:10])
    assert rel_err(rp[0], rk[0]) <= 1e-5 and rel_err(rp[1], rk[1]) <= 1e-5


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_bad_operands(cuda_stress):
    """A CUDA tensor of the wrong dtype or shape raises before any launch."""
    sc, w = cuda_stress
    p = sc.params
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree, p.bp_margin))
    bp = w.bp
    with pytest.raises(TypeError, match="thr"):
        solver_cuda.collide_and_init(w.contacts, bp.nb, bp.key, bp.thr.float(), w.bodies, p)
    with pytest.raises(ValueError, match="mass"):
        solver_cuda.solve_loop(w.contacts, w.bodies.replace(mass=w.bodies.mass[:1]), p)
    rod = load_scene("RodJointed", device="cuda")
    rw = rod.world.replace(bp=build_bp_cache(rod.world.bodies, rod.world.exclusions,
                                             rod.cap.max_degree, rod.params.bp_margin))
    bad = rw.joints.replace(side=rw.joints.side.float())
    with pytest.raises(TypeError, match="side"):
        solver_cuda.step_kernel(rw.contacts, rw.bp.nb, rw.bp.key, rw.bp.thr, rw.bodies,
                                rw.bp.anchor, rw.bp.anchor_quat, rod.params, 20, 4, rw.bp.cand,
                                bad, None, 2)


# ---------------------------------------------------------------------------
# Each route of the sweep plan against the plain versions, bit for bit
# ---------------------------------------------------------------------------

def forced_plan(tile, dc, blk=0):
    """``tile`` bodies a block, one launch per half-sweep (``blk`` 0) or
    clusters covering logical blocks of ``blk`` bodies."""
    threads, spt, smem = solver_cuda._tile_shape(tile, dc)
    return solver_cuda.SweepPlan(tile, threads, spt, smem, blk // tile)


def assert_step_equal(plain, got):
    """K1's outputs: cache integers identical, every float leaf equal."""
    (cp, bp_, dp, _rp), (ck, bk, dk) = plain, got
    for f in solver_cuda.CACHE_FIELDS:
        assert torch.equal(getattr(cp, f), getattr(ck, f)), f
    for x, y in zip(bp_, bk):
        assert torch.equal(x, y)
    assert torch.equal(dp[0, :10], dk[0, :10]) and torch.equal(dp[0, 15], dk[0, 15])


@pytest.mark.cuda
@pytest.mark.parametrize("route, tile", [("cluster", 64), ("launches", 32), ("launches", 64)])
def test_cuda_step_kernel_routes_match_plain(cuda_stress, route, tile):
    """K1 at a landing Stress1000 state on the cluster-resident route (one
    cluster of 16 blocks, which ``sweep_plan`` leaves to the grid tier) and
    on the launch-per-half-sweep route at both tiles: equal to the plain
    version bit for bit."""
    sc, w = cuda_stress
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    bp, b = w.bp, w.bodies
    plan = forced_plan(tile, 12, 1024 if route == "cluster" else 0)
    assert plan.route == route
    args = (bp.nb, bp.key, bp.thr, b, bp.anchor, bp.anchor_quat, sc.params, 20, 4, bp.cand)
    plain = solver_cuda.step_kernel_plain(w.contacts, *args)
    new, body, diag, _rows = kernels.launch_step(solver_cuda.cache_leaves(w.contacts), *args,
                                                 plan=plan)
    torch.cuda.synchronize()
    assert_step_equal(plain, (solver_cuda.args_to_cache(new), body, diag))


@pytest.mark.cuda
@pytest.mark.parametrize("scene, steps, cluster", [("Stack", 60, 4), ("Pyramid", 60, 4)])
def test_cuda_small_world_takes_cluster_route(scene, steps, cluster):
    """A contact-only world of 128 bodies: ``sweep_plan`` gives it one
    cluster of 32-body tiles, and K1 there equals its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    kernels.build()
    sc = load_scene(scene, device="cuda")
    w = run_steps(sc.world, sc.params, sc.cap, steps)
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    plan = solver_cuda.sweep_plan(w.bodies.n, w.contacts.other.shape[0])
    assert (plan.route, plan.cluster) == ("cluster", cluster)
    bp = w.bp
    args = (w.contacts, bp.nb, bp.key, bp.thr, w.bodies, bp.anchor, bp.anchor_quat,
            sc.params, sc.params.iterations, 4, bp.cand)
    plain = solver_cuda.step_kernel_plain(*args)
    ck, bk, dk, _ = solver_cuda.step_kernel(*args)
    torch.cuda.synchronize()
    assert int(dk[0, 5]) > 0
    assert_step_equal(plain, (ck, bk, dk))


@pytest.mark.cuda
def test_cuda_step_kernel_at_2048_takes_launch_route():
    """Stress2048 after 250 steps (landing): ``sweep_plan`` gives N = 2048
    one launch per half-sweep, and K1 there equals its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    kernels.build()
    sc = load_scene("Stress2048", device="cuda")
    w = run_steps(sc.world, sc.params, sc.cap, 250)
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    assert solver_cuda.sweep_plan(w.bodies.n, w.contacts.other.shape[0]).route == "launches"
    bp = w.bp
    args = (w.contacts, bp.nb, bp.key, bp.thr, w.bodies, bp.anchor, bp.anchor_quat,
            sc.params, 20, 4, bp.cand)
    plain = solver_cuda.step_kernel_plain(*args)
    ck, bk, dk, _ = solver_cuda.step_kernel(*args)
    torch.cuda.synchronize()
    assert int(dk[0, 5]) > 1000
    assert_step_equal(plain, (ck, bk, dk))


@pytest.mark.cuda
@pytest.mark.parametrize("scene, steps", [("SoftGrid", 5), ("RodJointed", 30)])
@pytest.mark.parametrize("route", ["cluster", "grid"])
def test_cuda_joint_branch_matches_plain_bitwise(scene, steps, route):
    """The joint branch runs all its sweeps in one resident launch: one
    cluster (what ``sweep_plan`` gives a 128-body world) or a cooperative
    launch with a grid barrier (forced here).  Body outputs, cache and joint
    duals equal the plain version's, and a second launch gives the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    kernels.build()
    sc = load_scene(scene, device="cuda")
    w = run_steps(sc.world, sc.params, sc.cap, steps)
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    bp, j, n, dc = w.bp, w.joints, w.bodies.n, w.contacts.other.shape[0]
    plan = solver_cuda.sweep_plan(n, dc, None, j.dj)
    assert (plan.route, plan.cluster) == ("cluster", n // 32)
    if route == "grid":
        plan = dataclasses.replace(plan, cluster=0, grid=1)
    args = (bp.nb, bp.key, bp.thr, w.bodies, bp.anchor, bp.anchor_quat, sc.params, 20, 4,
            bp.cand, j, None, sc.cap.joint_colors)
    plain = solver_cuda.step_kernel_plain(w.contacts, *args)

    def launch():
        new, body, diag, rows = kernels.launch_step(solver_cuda.cache_leaves(w.contacts), *args,
                                                    plan=plan)
        return solver_cuda.args_to_cache(new), body, diag, rows

    got, again = launch(), launch()
    torch.cuda.synchronize()
    assert_step_equal(plain, got[:3])
    assert torch.equal(plain[3][0], got[3][0]) and torch.equal(plain[3][1], got[3][1])
    assert_step_equal(got, again[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["cluster", "grid"])
def test_cuda_joint_branch_with_narrow_cache_matches_plain(route):
    """A welded rod with a cache of width 1, whose joint row terms take
    more shared memory than its contact partials: on both barriers the
    resident launch equals the plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from test_torch_sweep_plan import narrow_cache_rod

    kernels.build()
    w, p, cap = narrow_cache_rod("cuda")
    w = run_steps(w, p, cap, 20)
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, cap.max_degree, p.bp_margin))
    bp, j, n, dc = w.bp, w.joints, w.bodies.n, w.contacts.other.shape[0]
    plan = solver_cuda.sweep_plan(n, dc, None, j.dj)
    assert (dc, j.dj, plan.route) == (1, 2, "cluster") and int(w.contacts.count.sum()) > 0
    if route == "grid":
        plan = dataclasses.replace(plan, cluster=0, grid=1)
    args = (bp.nb, bp.key, bp.thr, w.bodies, bp.anchor, bp.anchor_quat, p, 20, 4, bp.cand, j,
            None, cap.joint_colors)
    plain = solver_cuda.step_kernel_plain(w.contacts, *args)
    new, body, diag, rows = kernels.launch_step(solver_cuda.cache_leaves(w.contacts), *args,
                                                plan=plan)
    torch.cuda.synchronize()
    assert_step_equal(plain, (solver_cuda.args_to_cache(new), body, diag))
    assert torch.equal(plain[3][0], rows[0]) and torch.equal(plain[3][1], rows[1])


@pytest.mark.cuda
@pytest.mark.parametrize("gb, route", [(8, "cluster"), (40, "launches")])
def test_cuda_iterblock_grid_routes_match_plain(cuda_grid, gb, route):
    """K6 with logical blocks of 1024 bodies (one cluster each) and with the
    world as one logical block (no cluster holds it): both equal the plain
    version bit for bit."""
    w, p, cap = cuda_grid
    c = solver_grid.collide_grid(w.contacts, w.bp.nb, w.bp.key, w.bp.thr, w.bodies, p)[0]
    b, g = w.bodies, w.bodies.g
    assert solver_cuda.sweep_plan(b.n, c.other.shape[0], gb * 128).route == route
    _lv, _av, ip, iq, ps, qs, _s = solver.predict(b, p)

    def cg(a):
        return a.T.contiguous().reshape(a.shape[1], g, 128)

    spec = solver_grid.grid_specs(p, p.iterations, p.lhs_rebuild_every, cap.grid_residency)[0]
    args = (p, gb, spec, c, b, cg(ps), cg(qs), c.lam, c.penalty,
            c.stick.to(torch.float32), cg(ip), cg(iq))
    outs_p = solver_grid.iterblock_grid_plain(*args)
    outs_k = solver_grid.iterblock_grid(*args)
    torch.cuda.synchronize()
    for x, y in zip(outs_p, outs_k):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_cluster_launch_that_cannot_run_raises(cuda_stress):
    """A plan the card cannot take is an error, never a fallback: clusters
    that do not cover the logical block, and a cluster above 16 blocks."""
    sc, w = cuda_stress
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    bp = w.bp
    args = (solver_cuda.cache_leaves(w.contacts), bp.nb, bp.key, bp.thr, w.bodies, bp.anchor,
            bp.anchor_quat, sc.params, 20, 4, bp.cand)
    for plan in (forced_plan(64, 12, 512), forced_plan(32, 12, 1024)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernels.launch_step(*args, plan=plan)


# ---------------------------------------------------------------------------
# The joint route refused without rows, and the cache compaction, on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_grid_route_refused_without_rows(cuda_stress):
    """A cooperative joint launch on a contact-only world is an error."""
    sc, w = cuda_stress
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    bp = w.bp
    plan = solver_cuda.sweep_plan(1024, 12, None, 2)
    assert plan.route == "grid"
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.launch_step(solver_cuda.cache_leaves(w.contacts), bp.nb, bp.key, bp.thr,
                            w.bodies, bp.anchor, bp.anchor_quat, sc.params, 20, 4, bp.cand,
                            plan=plan)


@pytest.mark.cuda
def test_cuda_compacted_cache_matches_full_width_bit_exact():
    """tests/test_torch_cache_compaction.py through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from test_torch_cache_compaction import check_culled_equals_full_width

    kernels.build()
    check_culled_equals_full_width("cuda")


@pytest.mark.cuda
def test_cuda_compaction_overflow_is_counted_not_silent():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from test_torch_cache_compaction import check_overflow_counted

    kernels.build()
    check_overflow_counted("cuda")
