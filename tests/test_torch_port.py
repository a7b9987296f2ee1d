"""The PyTorch port on its own: isolation from JAX, devices, wrappers, the
kernel parameter contract, the smoke script's failure modes, and (on a
machine with an NVIDIA GPU) each CUDA kernel against its plain version.

No JAX here; the comparisons with the reference are test_torch_parity_*.py.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from avbd3d_tpu_torch import kernels, load_scene, run_steps, solver, solver_cuda
from avbd3d_tpu_torch.config import SolverParams
from avbd3d_tpu_torch.ops.broadphase import build_bp_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def test_port_imports_no_jax():
    code = ("import avbd3d_tpu_torch, avbd3d_tpu_torch.cli, avbd3d_tpu_torch.kernels, "
            "chip_smoke, sys; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'avbd3d_tpu.'))"
            " or m == 'avbd3d_tpu']; assert not bad, bad")
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
            sc.params, 10, 4)
    solver_cuda.reset_launch_counts()
    c1, b1, d1 = solver_cuda.step_kernel(*args)
    c2, b2, d2 = solver_cuda.step_kernel_plain(*args)
    lanes = solver_cuda.control_lanes(bp.nb, w.bodies, bp.anchor, bp.anchor_quat, sc.params)
    assert solver_cuda.step_kernel.launches == 0 and solver_cuda.control_lanes.launches == 0
    for x, y in zip(b1, b2):
        assert torch.equal(x, y)
    assert torch.equal(d1, d2) and torch.equal(c1.count, c2.count)
    assert int(d1[0, 5]) == 4              # the tilted cube lands on one face
    assert lanes.shape == (5,) and bool(torch.isfinite(lanes).all())


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
def test_cuda_step_kernel_matches_plain(cuda_stress):
    sc, w = cuda_stress
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    bp = w.bp
    args = (w.contacts, bp.nb, bp.key, bp.thr, w.bodies, bp.anchor, bp.anchor_quat,
            sc.params, 20, 4)
    cp, bp_, dp = solver_cuda.step_kernel_plain(*args)
    ck, bk, dk = solver_cuda.step_kernel(*args)
    torch.cuda.synchronize()
    for f in ("other", "count", "feature", "stick"):
        assert torch.equal(getattr(cp, f), getattr(ck, f)), f
    for x, y in zip(bp_, bk):
        assert float((x - y).abs().max()) <= 1e-5
    assert torch.equal(dp[0, 5:10], dk[0, 5:10])


@pytest.mark.cuda
def test_cuda_control_lanes_match_plain(cuda_stress):
    sc, w = cuda_stress
    b, bp = w.bodies, w.bp
    lk = solver_cuda.control_lanes(bp.nb, b, bp.anchor, bp.anchor_quat, sc.params)
    lp = solver_cuda.control_lanes_plain(bp.nb, b, bp.anchor, bp.anchor_quat, sc.params)
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-6)
