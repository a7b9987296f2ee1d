"""The port's portable step on jointed worlds against the JAX reference's
``_step_impl``, on the CPU: RodJointed (hard welds, 2 colour sub-passes)
and SoftGrid (soft welds, contacts with the ground).

As tests/test_torch_parity_xla.py: one step of both from the same arrays,
the reference's op by op; integers identical (joint slot tables included),
poses and joint duals within that file's per-state rule.  SoftGrid's
trajectory is stepped op by op too: compiling the reference's portable step
with its joints takes more than 15 minutes on XLA:CPU.
"""

import pytest
import torch

from avbd3d_tpu.models import scenes as jscenes

from avbd3d_tpu_torch import solver as tsolver
from avbd3d_tpu_torch.convert import world_from_arrays
from test_torch_parity_xla import compare_portable_step, eager, jtree, port_config, portable

torch.set_num_threads(1)

ROD_STATES = (0, 6)
SOFT_STATES = (0, 2)


def trajectory(name, keep, compiled):
    sc = jscenes.load_scene(name)
    params = sc.params.replace(lhs_rebuild_every=1, ballistic=False)
    cap = sc.cap.replace(backend="xla")
    f = portable(params, cap) if compiled else eager(params, cap)
    states, w = {}, sc.world
    for i in range(max(keep) + 1):
        if i in keep:
            states[i] = w
        w = f(w)
    return params, cap, (f if compiled else None), states


@pytest.fixture(scope="module")
def rod():
    return trajectory("RodJointed", ROD_STATES, compiled=True)


@pytest.fixture(scope="module")
def soft():
    return trajectory("SoftGrid", SOFT_STATES, compiled=False)


CASES = [("rod", k) for k in ROD_STATES] + [("soft", k) for k in SOFT_STATES]


@pytest.mark.parametrize("scene,k", CASES, ids=[f"{s}-{k}" for s, k in CASES])
def test_one_jointed_portable_step_matches_reference(request, scene, k):
    params, cap, f, states = request.getfixturevalue(scene)
    err, tol = compare_portable_step(states[k], params, cap, f, joints=True)
    assert err <= tol


def test_soft_grid_portable_state_has_contacts(soft):
    """The SoftGrid cases include contact onset with the ground: the step
    from state 2 (the port's) finds the sheet's manifolds."""
    params, cap, _f, states = soft
    tparams, tcap = port_config(params, cap)
    w = tsolver._step_impl(world_from_arrays(jtree(states[2]), "cpu"), tparams, tcap)
    assert w.diagnostics.as_dict()["active_manifolds"] > 50
