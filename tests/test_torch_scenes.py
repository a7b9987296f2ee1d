"""The port's large-N scenes and backend dispatch against the JAX reference.

Scene arrays are compared bit for bit (test_torch_parity_ops.py covers the
full Stress2048 and Stress4096 scenes); here the x-major ``order`` of the
stress construction, and ``solver.select_path`` against the reference's
dispatch (solver.py:334-372): which scenes take the fused path and which the
grid tier, and the reference's errors for a forced backend that does not
cover the scene.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from avbd3d_tpu import solver as jsolver
from avbd3d_tpu.models import scenes as jscenes

from avbd3d_tpu_torch import solver as tsolver
from avbd3d_tpu_torch.convert import world_from_arrays, world_to_arrays
from avbd3d_tpu_torch.models import scenes as tscenes

torch.set_num_threads(1)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("order", ["yzx", "xzy"])
def test_stress_order_matches_reference(order):
    """_scene_stress_n in both index orders, at a size with padding."""
    jw, jp, jcap, jn = jscenes._scene_stress_n(5, 3, 4, max_degree=28, cache_degree=16,
                                               order=order)
    arrays, tp, tcap, tn = tscenes._scene_stress_n(5, 3, 4, max_degree=28,
                                                   cache_degree=16, order=order)
    assert tn == jn and dataclasses.asdict(tcap) == dataclasses.asdict(jcap)
    a = flat(jax.device_get(dataclasses.asdict(jw)))
    b = flat(world_to_arrays(world_from_arrays(arrays, "cpu")))
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # x-major really relabels: body 1 and body 2 are x-neighbours in "yzx"
    # and y-neighbours in "xzy".
    pos = arrays["bodies"]["pos"].reshape(3, -1)
    d = np.abs(pos[:, 2] - pos[:, 1])
    assert (d[0] > 1.0) == (order == "yzx") and (d[1] > 1.0) == (order == "xzy")


@pytest.mark.parametrize("name,path", [("Stress1000", "fused"), ("Stress2048", "fused"),
                                       ("Stress4096", "grid"), ("Stack", "fused")])
def test_auto_dispatch(name, path):
    sc = tscenes.load_scene(name, "cpu")
    assert tsolver.select_path(sc.world, sc.cap) == path
    # Forcing the path a scene already takes changes nothing.
    forced = {"fused": "pallas", "grid": "grid"}[path]
    assert tsolver.select_path(sc.world, sc.cap.replace(backend=forced)) == path


def _reference_error(name, backend):
    sc = jscenes.load_scene(name)
    with pytest.raises(ValueError) as err:
        jsolver.step(sc.world, sc.params, sc.cap.replace(backend=backend))
    return str(err.value)


@pytest.mark.parametrize("name,backend", [("Stress4096", "pallas"), ("Stack", "grid")])
def test_forced_backend_errors_match_reference(name, backend):
    """A forced backend that does not cover the scene raises the
    reference's ValueError (Stress4096 is above the fused path's 2048
    bodies; Stack has G = 1, not a multiple of 8)."""
    want = _reference_error(name, backend)
    sc = tscenes.load_scene(name, "cpu")
    with pytest.raises(ValueError) as err:
        tsolver.step(sc.world, sc.params, sc.cap.replace(backend=backend))
    assert str(err.value) == want


def test_grid_and_xla_forced_on_a_fused_scene():
    sc = tscenes.load_scene("Stress1000", "cpu")     # G = 8: the grid tier covers it
    assert tsolver.select_path(sc.world, sc.cap.replace(backend="grid")) == "grid"
    assert tsolver.select_path(sc.world, sc.cap.replace(backend="xla")) == "xla"
    with pytest.raises(ValueError):
        tsolver.select_path(sc.world, sc.cap.replace(backend="tpu"))


@pytest.mark.parametrize("name,path", [("Stress1000", "fused"), ("Stress4096", "grid")])
def test_bp_window_dispatch(name, path):
    """``cap.bp_window > 0`` (the swept broadphase, the reference's
    solver.py:377-380 and solver_tpu.py:1696-1699) dispatches as 0 does,
    on a fused and on a grid scene, and a step runs on that path with the
    swept refresh (the first step always refreshes)."""
    from avbd3d_tpu_torch.ops.broadphase import candidate_lists_swept

    sc = tscenes.load_scene(name, "cpu")
    cap = sc.cap.replace(bp_window=504)
    assert sc.cap.bp_window == 0 and tsolver.select_path(sc.world, sc.cap) == path
    assert tsolver.select_path(sc.world, cap) == path
    calls = candidate_lists_swept.swept + candidate_lists_swept.fallbacks
    w = tsolver.step(sc.world, sc.params, cap)
    assert tsolver.step.last_path == path and tsolver.step.last_gates["refreshed"]
    assert candidate_lists_swept.swept + candidate_lists_swept.fallbacks == calls + 1
    assert int(w.diagnostics.as_dict()["sanitized"]) == 0
