"""The PyTorch port's step against the JAX reference, on the CPU.

The reference runs the way its own tests run it off-TPU: ``backend="pallas"``
goes through the kernel bodies' math twins (solver_tpu.py:957-1011).  States
are taken from reference trajectories of a 100-cube stress scene (the
Stress1000 construction and tuning at N = 128) and of TwoBlockDrop; each is
converted to the port, advanced one step by both, and compared.

Tolerances.  Integer outputs (slots, keys, thresholds, feature ids, counts)
must be identical.  Poses: a contact step runs 10-20 Jacobi sweeps whose
stick latches and active-set clamps are knife-edge branches, so float32
rounding differences grow within one step — at a landing state the
reference itself moves 1.3e-3 m when its input poses are nudged by one ulp
(measured).  Each state's pose tolerance is therefore max(1e-4 m, 4x the
reference's own one-ulp sensitivity at that state), measured in the test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avbd3d_tpu import solver as jsolver
from avbd3d_tpu import solver_tpu as jsolver_tpu
from avbd3d_tpu.models import scenes as jscenes

from avbd3d_tpu_torch import config as tconfig
from avbd3d_tpu_torch import solver as tsolver
from avbd3d_tpu_torch import solver_cuda
from avbd3d_tpu_torch.convert import world_from_arrays, world_to_arrays

torch.set_num_threads(1)

STRESS_STATES = (0, 1, 60, 125, 135, 150, 200)
TWO_BLOCK_STATES = (0, 30, 33, 60, 149)


def jtree(world):
    return jax.device_get(dataclasses.asdict(world))


def port_config(params, cap):
    return (tconfig.SolverParams(**dataclasses.asdict(params)),
            tconfig.Capacity(**dataclasses.asdict(cap)))


def trajectory(world, params, cap, keep):
    states, w = {}, world
    for i in range(max(keep) + 1):
        if i in keep:
            states[i] = w
        w = jsolver.step(w, params, cap)
    return states


@pytest.fixture(scope="module")
def stress():
    world, params, cap, _ = jscenes._scene_stress_n(5, 4, 5)
    cap = cap.replace(backend="pallas")
    return params, cap, trajectory(world, params, cap, STRESS_STATES)


@pytest.fixture(scope="module")
def two_block():
    sc = jscenes.load_scene("TwoBlockDrop")
    cap = sc.cap.replace(backend="pallas")
    return sc.params, cap, trajectory(sc.world, sc.params, cap, TWO_BLOCK_STATES)


def reference_gates(w, params):
    """The reference's branch decisions for the next step of ``w``: the
    refresh predicate (broadphase.py:222), the ballistic predicate
    (solver.py:406-411) and control_gates, all as JAX evaluates them."""
    dv = w.diagnostics.vec
    m = params.bp_margin
    need = bool((dv[14] > 0.5 * m) | (dv[15] > w.bp.slack + m))
    ballistic = bool(params.ballistic and (dv[5] == 0.0) & (dv[13] > params.collision_margin)
                     & (not need) & (w.bp.dropped == 0))
    gates = {"refreshed": need, "ballistic": ballistic}
    if not ballistic:
        stale_ok, calm = jsolver.control_gates(dv, jnp.bool_(need), params)
        gates.update(stale_ok=bool(stale_ok), calm=bool(calm))
    return gates


def nudged(w):
    """``w`` with every dynamic body's position moved by one float32 ulp."""
    pos = np.asarray(w.bodies.pos)
    dyn = np.asarray(w.bodies.inv_mass)[None] > 0
    up = np.where(dyn, np.nextafter(pos, np.float32(np.inf)), pos).astype(np.float32)
    return w.replace(bodies=w.bodies.replace(pos=jnp.asarray(up)))


def sensitivity(w, params, cap):
    a = jsolver.step(w, params, cap)
    b = jsolver.step(nudged(w), params, cap)
    dpos = float(jnp.max(jnp.abs(a.bodies.pos - b.bodies.pos)))
    flips = int(jnp.sum(a.contacts.stick != b.contacts.stick))
    return dpos, flips


CASES = [("stress", k) for k in STRESS_STATES] + [("two_block", k) for k in TWO_BLOCK_STATES]


@pytest.mark.parametrize("scene,k", CASES, ids=[f"{s}-{k}" for s, k in CASES])
def test_one_step_matches_reference(request, scene, k):
    params, cap, states = request.getfixturevalue(scene)
    jw = states[k]
    tparams, tcap = port_config(params, cap)
    tw = world_from_arrays(jtree(jw), "cpu")

    want = reference_gates(jw, params)
    j1 = jsolver.step(jw, params, cap)
    t1 = tsolver.step(tw, tparams, tcap)
    assert {g: bool(v) for g, v in tsolver.step.last_gates.items()} == want

    a, b = jtree(j1), world_to_arrays(t1)
    for group, names in (("contacts", ("other", "count", "feature")),
                         ("bp", ("nb", "key", "thr", "cand", "dropped"))):
        for name in names:
            np.testing.assert_array_equal(b[group][name], a[group][name],
                                          err_msg=f"{group}.{name}")
    assert int(b["step_index"]) == int(a["step_index"])

    sens, flips = sensitivity(jw, params, cap)
    tol = max(1e-4, 4.0 * sens)
    jb, tb = a["bodies"], b["bodies"]
    for name in ("pos", "quat", "prev_linvel", "prev_angvel"):
        np.testing.assert_allclose(tb[name], jb[name], atol=tol, rtol=0, err_msg=name)
    # Velocities are pose differences over dt (x 60).
    for name in ("linvel", "angvel"):
        np.testing.assert_allclose(tb[name], jb[name], atol=150 * tol, rtol=0, err_msg=name)
    stick_diff = int(np.sum(b["contacts"]["stick"] != a["contacts"]["stick"]))
    assert stick_diff <= 3 * flips + 2, (stick_diff, flips)

    jv, tv = a["diagnostics"]["vec"], b["diagnostics"]["vec"]
    counts = [5, 6, 7, 8, 9, 10]   # contacts, manifolds, bodies, sanitized, overflows
    np.testing.assert_array_equal(tv[counts], jv[counts])
    geometric = [0, 1, 13, 14, 15]  # penetration, drift, min gap, anchor deviations
    np.testing.assert_allclose(tv[geometric], jv[geometric], atol=2 * tol, rtol=0)
    speeds = [2, 3]
    np.testing.assert_allclose(tv[speeds], jv[speeds], atol=300 * tol, rtol=1e-4)
    speed_sq = [11, 12]
    np.testing.assert_allclose(tv[speed_sq], jv[speed_sq], atol=300 * tol, rtol=2e-3)


def test_states_cover_every_gate(stress, two_block):
    """The one-step cases above see a ballistic step, a refresh step, and
    contact steps of every kernel variant (calm, fresh, boost)."""
    seen = set()
    for params, cap, states in (stress, two_block):
        for w in states.values():
            g = reference_gates(w, params)
            seen.add("ballistic" if g["ballistic"] else "contact")
            if g["refreshed"]:
                seen.add("refreshed")
            if not g["ballistic"]:
                tp, _ = port_config(params, cap)
                seen.add(solver_cuda.select_variant(tp, g["stale_ok"], g["calm"]))
    assert {"ballistic", "contact", "refreshed", (10, 4), (20, 4), (20, 1)} <= seen, seen


def _k1_operands(w):
    b = w.bodies
    return w.contacts, w.bp.nb, w.bp.key, w.bp.thr, b


def test_step_kernel_halves_match_reference(stress):
    """K1's plain halves against the reference kernel bodies' math twins
    (collide_and_init_math, solve_loop_math) on a settling-pile state."""
    params, cap, states = stress
    jw = states[200]
    tparams, _ = port_config(params, cap)
    tw = world_from_arrays(jtree(jw), "cpu")

    # Collide half: one pass, no iteration -> integers identical, floats to
    # 1e-5 (rounding of the same operations in two libraries).
    jc, jkept, jdrop = jsolver_tpu.collide_and_init_math(*_k1_operands(jw), params)
    tc, tkept, tdrop = solver_cuda.collide_half(*_k1_operands(tw), tparams)
    assert int(tkept) == int(jkept) and int(tdrop) == int(jdrop)
    ja = jax.device_get(dataclasses.asdict(jc))
    for name in solver_cuda.CACHE_FIELDS:
        x, y = getattr(tc, name).numpy(), np.asarray(ja[name])
        if y.dtype.kind in "ib":
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5, err_msg=name)
    assert int(np.asarray(ja["count"]).sum()) > 100

    # Solve half from the same cache: 20 sweeps at cadence 4.
    contacts = world_from_arrays({**jtree(jw), "contacts": ja}, "cpu").contacts
    jb, jlam, jpen, jstick, jdiag = jsolver_tpu.solve_loop_math(jc, jw.bodies, params)[:5]
    tout = solver_cuda.solve_half(tparams, contacts, tw.bodies, params.iterations,
                                  params.lhs_rebuild_every)
    jb2 = jsolver_tpu.solve_loop_math(jc, nudged(jw).bodies, params)[0]
    tol = max(1e-4, 4.0 * float(jnp.max(jnp.abs(jb.pos - jb2.pos))))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jb.pos), atol=tol, rtol=0)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jb.quat), atol=tol, rtol=0)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jb.linvel), atol=150 * tol, rtol=0)
    np.testing.assert_array_equal(tout[9][0, 5:9].numpy(), np.asarray(jdiag)[0, 5:9])


def test_lockstep_50_steps_two_block_drop():
    """50 steps side by side with the reference on TwoBlockDrop at the
    deterministic cadence (lhs_rebuild_every=1, no ballistic path): the
    configuration tests/test_pallas_backend.py uses to compare backends,
    held to its bound of 2e-3 m (f32 op-order drift between two
    implementations of the same solver through contact onset)."""
    sc = jscenes.load_scene("TwoBlockDrop")
    params = sc.params.replace(lhs_rebuild_every=1, ballistic=False)
    cap = sc.cap.replace(backend="pallas")
    tparams, tcap = port_config(params, cap)
    jw = sc.world
    tw = world_from_arrays(jtree(jw), "cpu")
    drift = []
    for _ in range(50):
        want = reference_gates(jw, params)
        jw = jsolver.step(jw, params, cap)
        tw = tsolver.step(tw, tparams, tcap)
        assert {g: bool(v) for g, v in tsolver.step.last_gates.items()} == want
        drift.append(float(np.max(np.abs(tw.bodies.pos.numpy() - np.asarray(jw.bodies.pos)))))
    assert max(drift) < 2e-3, max(drift)
    d = tw.diagnostics.as_dict()
    assert d["sanitized"] == 0 and d["pair_overflow"] == 0
    assert d["active_manifolds"] == float(jw.diagnostics.vec[6])
