"""The grid step's stages around K5 and K6 (solver_grid.grid_gates,
grid_predict, grid_finalize): their plain versions against the JAX
reference on the CPU, and the wrappers' dispatch.  The kernels of
csrc/grid_stages.cu against their plain versions on the card are
tests/test_torch_port.py's (a file without JAX, which the card's machine
lacks) and chip_smoke.py's phase 20.

Inputs: test_torch_parity_grid.py's grid pile at G = 8 (N = 1024) with
fresh candidate lists, and states made from it with numpy seeds: bodies
moved and turned since their anchors and given velocities, a body below
``fall_freeze_y``, non-finite velocities and final poses, every body
static.  The reference's gates are its fall-freeze lines (solver.step),
``stale_lhs_ok(refine=False)`` and ``refresh_or_reuse``'s decision (its
cache's anchors moved); its prediction ``solver.predict``; its finalize
``solver._sanitize`` of the final poses and ``solver.finalize``, fed the
same slots, separations and duals as the port.  Tolerances: flags,
integers, counts and latches identical; floats within rtol 1e-5, atol
1e-5 (the same float32 operations rounded by two libraries).
"""

import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parity_grid import jtree, pile, tparams_of

import avbd3d_tpu_torch
from avbd3d_tpu import solver as jsolver
from avbd3d_tpu.ops import broadphase as jbp
from avbd3d_tpu_torch import kernels, solver, solver_cuda, solver_grid
from avbd3d_tpu_torch.config import Capacity
from avbd3d_tpu_torch.convert import world_from_arrays

torch.set_num_threads(1)

BODY_FIELDS = ("pos", "quat", "linvel", "angvel", "prev_linvel", "prev_angvel", "inv_mass")
STATES = ("pile", "moved", "fallen", "nonfinite", "static")
# The finalize's fold at two more separations of the moved state: one live
# slot's NaN (lanes 0 and 1 NaN) and every one +0 (lane 0 folds -0 against
# the +0 start: +0, its sign checked; lane 1 the slop).
SEP_STATES = ("nan_sep", "zero_sep")
# Poses the prediction's sanitizes meet, on the moved state: one dynamic
# body's pos.y NaN; one at pos.x 3.4e38 moving at linvel.x 3e38, whose pos
# + linvel dt passes the largest float32 at the scene's dt (the inertial
# position and the warm start infinite, the warm start sanitized).
POSE_STATES = ("nan_pose", "overflow")


@pytest.fixture(scope="module")
def base():
    """The grid pile of test_torch_parity_grid (G = 8, N = 1024), its
    params with the fall-freeze at y = -2 (reachable by a moved body),
    and the port's world of it."""
    jw, params, cap = pile(6, 3, 6, 1024, max_degree=16, cache_degree=8, seed=7,
                           spacing_y=0.998, vy=-0.1, vxz=0.0, tilt=0.01)
    assert jw.bodies.g == 8
    params = params.replace(fall_freeze_y=-2.0)
    return jw, params, cap


def state_arrays(jw, name: str) -> dict:
    """The body fields of state ``name`` as numpy arrays (C, G, 128)."""
    if name in POSE_STATES:
        return pose_arrays(state_arrays(jw, "moved"), name)
    b = jax.device_get(dataclasses.asdict(jw.bodies))
    a = {k: np.array(b[k], dtype=np.float32) for k in BODY_FIELDS}
    rng = np.random.default_rng(STATES.index(name) + 11)
    dyn = a["inv_mass"] > 0
    ids = np.flatnonzero(dyn.reshape(-1))
    if name == "pile":
        return a
    if name == "static":
        a["inv_mass"][:] = 0.0
        return a
    # Moved and turned since the anchors, with velocities.
    a["pos"] += dyn[None] * rng.uniform(-0.05, 0.05, a["pos"].shape).astype(np.float32)
    q = a["quat"] + dyn[None] * rng.normal(scale=0.02, size=a["quat"].shape).astype(np.float32)
    a["quat"] = (q / np.linalg.norm(q, axis=0, keepdims=True)).astype(np.float32)
    for k, s in (("linvel", 2.0), ("angvel", 3.0), ("prev_linvel", 2.0), ("prev_angvel", 3.0)):
        a[k] = (dyn[None] * rng.normal(scale=s, size=a[k].shape)).astype(np.float32)
    flat = {k: v.reshape(v.shape[0], -1) if v.ndim == 3 else v.reshape(-1) for k, v in a.items()}
    if name == "fallen":   # three bodies below fall_freeze_y (-2)
        flat["pos"][1, ids[:3]] = -2.5
    if name == "nonfinite":
        flat["linvel"][0, ids[0]] = np.nan
        flat["angvel"][2, ids[1]] = np.inf
        flat["angvel"][1, ids[2]] = 200.0    # above max_angular_speed: the clamp
    return a


def pose_arrays(a: dict, name: str) -> dict:
    """The body fields ``a`` at POSE_STATES' ``name``: the 8th dynamic
    body's pos.y NaN ("nan_pose"), or the first dynamic body at pos.x
    3.4e38 with linvel.x 3e38 ("overflow")."""
    ids = np.flatnonzero(a["inv_mass"].reshape(-1) > 0)
    pos, lv = a["pos"].reshape(3, -1), a["linvel"].reshape(3, -1)
    if name == "nan_pose":
        pos[1, ids[7]] = np.nan
    else:
        pos[0, ids[0]] = np.float32(3.4e38)
        lv[0, ids[0]] = np.float32(3.0e38)
    return a


def overflows(a: dict, dt: float) -> bool:
    """Whether the overflowed body's pos.x + linvel.x dt (float32) is
    infinite at ``dt``."""
    i = int(np.flatnonzero(a["inv_mass"].reshape(-1) > 0)[0])
    with np.errstate(over="ignore"):
        x = a["pos"].reshape(3, -1)[0, i] + a["linvel"].reshape(3, -1)[0, i] * np.float32(dt)
    return bool(np.isinf(np.float32(x)))


def worlds(base, name: str):
    """State ``name`` as the reference's World and the port's."""
    jw, _params, _cap = base
    a = state_arrays(jw, name)
    jw = jw.replace(bodies=jw.bodies.replace(**{k: jnp.asarray(v) for k, v in a.items()}))
    tw = world_from_arrays(jtree(jw), "cpu")
    return jw, tw


def reference_gates(jw, params, cap):
    """The reference grid step's fall-freeze (solver.step), then its refresh
    decision and unrefined speed gates.  Returns (frozen Bodies, need,
    stale_ok, calm)."""
    b = jw.bodies
    frozen = b.dynamic & (b.pos[1] < params.fall_freeze_y)
    b = b.replace(linvel=jnp.where(frozen[None], 0.0, b.linvel),
                  angvel=jnp.where(frozen[None], 0.0, b.angvel),
                  inv_mass=jnp.where(frozen, 0.0, b.inv_mass))
    new_bp = jbp.refresh_or_reuse(jw.bp, b, jw.exclusions, cap.max_degree, params.bp_margin)
    need = not np.array_equal(np.asarray(new_bp.anchor), np.asarray(jw.bp.anchor))
    calm_p = params.replace(lhs_stale_speed_max=min(params.impact_speed_min,
                                                    params.lhs_stale_speed_max))
    return (b, need, bool(jsolver.stale_lhs_ok(b, jw.bp, params, refine=False)),
            bool(jsolver.stale_lhs_ok(b, jw.bp, calm_p, refine=False)))


def test_gates_match_reference(base):
    """grid_gates' plain version against the reference at every state and at
    speed bounds on both sides of the states' speeds: the frozen fields, the
    refresh decision and both speed gates; every flag takes both values."""
    _jw, params, cap = base
    seen = set()
    for name in STATES:
        jw0, tw0 = worlds(base, name)
        for speed_max in (0.05, 1.0, 50.0):
            p = params.replace(lhs_stale_speed_max=speed_max, impact_speed_min=speed_max / 4)
            jb, need, stale_ok, calm = reference_gates(jw0, p, cap)
            tw, out = solver_grid.grid_gates(tw0, tparams_of(p))
            flags = [bool(x) for x in out[:3].tolist()]
            assert flags == [need, stale_ok, calm], (name, speed_max, flags)
            seen.update((k, v) for k, v in zip(("need", "stale_ok", "calm"), flags))
            for f in ("linvel", "angvel", "inv_mass"):
                np.testing.assert_array_equal(getattr(tw.bodies, f).numpy(),
                                              np.asarray(getattr(jb, f)), err_msg=f"{name} {f}")
            assert out.dtype == torch.float32 and out.shape == (6,)
        if name == "fallen":
            assert int((tw0.bodies.inv_mass > 0).sum() - (tw.bodies.inv_mass > 0).sum()) == 3
    assert seen == {(k, v) for k in ("need", "stale_ok", "calm") for v in (True, False)}, seen


@pytest.mark.parametrize("name", STATES + POSE_STATES)
def test_predict_matches_reference(base, name):
    """grid_predict's plain version against the reference's predict on the
    frozen state: velocities, inertial pose and warm start within the
    tolerance (a NaN or an infinity the same), the sanitize count identical
    (2 at the non-finite velocities; 1 at a NaN pose and at the overflowed
    one, whose warm start is sanitized and whose inertial position, which
    is not, is infinite at the scene's dt), and the stick latches' float
    copy."""
    _jw, params, cap = base
    jw, tw = worlds(base, name)
    jb = reference_gates(jw, params, cap)[0]
    tw, _ = solver_grid.grid_gates(tw, tparams_of(params))
    stick = torch.from_numpy(np.random.default_rng(5).random(
        tuple(tw.contacts.stick.shape)) < 0.3)
    got = solver_grid.grid_predict(tw.bodies, stick, tparams_of(params))
    want = jsolver.predict(jb, params)
    g = jb.g
    for label, x, y in zip(("linvel", "angvel", "ip", "iq", "ps"), got[:5],
                           [want[k] for k in (0, 1, 2, 3, 4)]):
        y = np.asarray(y).T.reshape(-1, g, 128)
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} {label}")
    np.testing.assert_array_equal(got[5].numpy(), stick.numpy().astype(np.float32))
    assert int(got[6]) == int(want[6]), (name, int(got[6]), int(want[6]))
    if name == "nonfinite":
        assert int(got[6]) == 2
    if name in POSE_STATES:
        assert int(got[6]) == 1, (name, int(got[6]))
    if name == "overflow":
        assert overflows(state_arrays(_jw, name), params.dt)
        assert np.isinf(np.asarray(want[2])).sum() == 1 and np.isfinite(got[4].numpy()).all()


def finalize_inputs(tw, params, name: str):
    """What the grid step hands its finalize at state ``name`` (frozen
    bodies): K5's plain cache, masks and dropped count from the state's
    lists, the prediction, K6-like final poses (the warm start moved by a
    seeded amount; at the non-finite state one NaN position and one
    infinite quaternion), separations, duals and 0 / 1 latches."""
    rng = np.random.default_rng((STATES + POSE_STATES).index(name) + 31)
    b, bp = tw.bodies, tw.bp
    lv, av, _ip, iq, ps, stickf, san = solver_grid.grid_predict(b, tw.contacts.stick, params)
    contacts, kept, once, dropped = solver_grid.collide_grid(tw.contacts, bp.nb, bp.key,
                                                             bp.thr, b, params, stickf=stickf)
    pos = ps + torch.from_numpy(rng.uniform(-1e-3, 1e-3, ps.shape).astype(np.float32))
    quat = iq + torch.from_numpy(rng.uniform(-1e-4, 1e-4, iq.shape).astype(np.float32))
    if name == "nonfinite":
        pos.view(3, -1)[1, 5] = float("nan")
        quat.view(4, -1)[0, 9] = float("inf")
    sep = torch.from_numpy(rng.uniform(-0.02, 0.03, (4,) + contacts.other.shape)
                           .astype(np.float32))
    lam = torch.from_numpy(rng.normal(scale=5.0, size=contacts.lam.shape).astype(np.float32))
    stick = torch.from_numpy((rng.random(contacts.stick.shape) < 0.4).astype(np.float32))
    contacts = contacts.replace(lam=lam, stick=stick)
    return (contacts, pos, quat, lv, av, san, sep, once, kept, bp.cand, dropped)


@pytest.mark.parametrize("name", STATES + SEP_STATES + POSE_STATES)
def test_finalize_matches_reference(base, name):
    """grid_finalize's plain version against the reference's _sanitize of
    the final poses and finalize on the same inputs: the new bodies within
    the tolerance, the latches and diagnostics lanes 5-15 identical (the
    sanitize count above 0 at the non-finite state), lanes 0-4 within the
    tolerance (a NaN matching a NaN); at SEP_STATES lanes 0 and 1 NaN, or 0
    and the slop."""
    _jw, params, cap = base
    tp = tparams_of(params)
    state = "moved" if name in SEP_STATES else name
    jw, tw = worlds(base, state)
    jb = reference_gates(jw, params, cap)[0]
    tw, _ = solver_grid.grid_gates(tw, tp)
    contacts, pos, quat, lv, av, san, sep, once, kept, cand, dropped = finalize_inputs(
        tw, tp, state)
    if name == "nan_sep":
        live = np.flatnonzero(((contacts.count > 0) & (contacts.other >= 0)).numpy())
        sep[0].view(-1)[int(live[len(live) // 2])] = float("nan")
    if name == "zero_sep":
        sep.zero_()
    out = solver_grid.grid_finalize(tw, tw.bodies, contacts, pos, quat, lv, av, san, sep,
                                    once, kept, cand, dropped, tp)
    n = jb.n

    def rows(t):
        return jnp.asarray(t.numpy().reshape(t.shape[0], n).T)

    pos0, quat0 = jb.pos_n3, jb.quat_n4
    jsan = jnp.int32(int(san))
    pos_f, jsan = jsolver._sanitize(rows(pos), pos0, jsan)
    quat_f, jsan = jsolver._sanitize(rows(quat), quat0, jsan)
    jc = jw.contacts.replace(**{f: jnp.asarray(getattr(contacts, f).numpy())
                                for f in solver_cuda.CACHE_FIELDS if f != "stick"},
                             stick=jnp.asarray(contacts.stick.numpy() > 0.5))
    overflow = jnp.int32(int(cand) - int(kept.sum()))
    ref = jsolver.finalize(jw.replace(bodies=jb), jb, jc, jw.joints, jw.springs, pos_f,
                           quat_f, pos0, quat0, rows(lv), rows(av), jc.lam,
                           jnp.asarray(sep.numpy()), jnp.asarray(once.numpy()), overflow,
                           jsan, params, degree_overflow=jnp.int32(int(dropped)))
    for f in ("pos", "quat", "linvel", "angvel", "prev_linvel", "prev_angvel"):
        np.testing.assert_allclose(getattr(out.bodies, f).numpy(),
                                   np.asarray(getattr(ref.bodies, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} {f}")
    np.testing.assert_array_equal(out.contacts.stick.numpy(), np.asarray(ref.contacts.stick))
    tv, jv = out.diagnostics.vec.numpy(), np.asarray(ref.diagnostics.vec)
    np.testing.assert_array_equal(tv[5:], jv[5:], err_msg=name)
    np.testing.assert_allclose(tv[:5], jv[:5], rtol=1e-5, atol=1e-5, err_msg=name)
    assert out.step_index == tw.step_index + 1
    if name == "nonfinite":
        assert tv[8] >= 2, tv
    if name == "pile":
        assert tv[6] > 50 and tv[9] >= 0, tv
    if name == "nan_sep":
        assert np.isnan(tv[:2]).all() and not np.isnan(tv[2:]).any(), tv
    if name == "zero_sep":
        assert tv[0] == 0.0 and tv[1] == np.float32(params.penetration_slop), tv
        assert not np.signbit(tv[0]) and not np.signbit(jv[0]), (tv, jv)


class _NoKernels(types.ModuleType):
    """Stands in for avbd3d_tpu_torch.kernels: any use fails."""

    def __getattr__(self, name):
        raise AssertionError(f"kernels.{name} used on CPU tensors")


def test_cpu_tensors_take_the_plain_versions(base, monkeypatch):
    """On CPU tensors the three wrappers run their plain versions, the
    kernels module is never touched and no count moves; a grid step
    neither, with one host read."""
    trap = _NoKernels("avbd3d_tpu_torch.kernels")
    monkeypatch.setitem(sys.modules, "avbd3d_tpu_torch.kernels", trap)
    monkeypatch.setattr(avbd3d_tpu_torch, "kernels", trap)
    solver_grid.reset_launch_counts()
    _jw, params, cap = base
    tp = tparams_of(params)
    _jw1, tw = worlds(base, "fallen")
    got_w, got = solver_grid.grid_gates(tw, tp)
    want_w, want = solver_grid.grid_gates_plain(tw, tp)
    assert torch.equal(got, want) and torch.equal(got_w.bodies.inv_mass,
                                                  want_w.bodies.inv_mass)
    b = got_w.bodies
    pred = solver_grid.grid_predict(b, tw.contacts.stick, tp)
    plain = solver_grid.grid_predict_plain(b, tw.contacts.stick, tp)
    assert all(torch.equal(x, y) for x, y in zip(pred, plain))
    args = finalize_inputs(got_w, tp, "fallen")
    out = solver_grid.grid_finalize(got_w, b, *args, tp)
    ref = solver_grid.grid_finalize_plain(got_w, b, *args, tp)
    assert torch.equal(out.diagnostics.vec, ref.diagnostics.vec)
    assert all(torch.equal(getattr(out.bodies, f), getattr(ref.bodies, f)) for f in BODY_FIELDS)
    solver.step.host_reads = 0
    grid_cap = Capacity(**dataclasses.asdict(cap)).replace(backend="grid")
    stepped = solver.step(tw, tp, grid_cap)
    assert solver.step.last_path == "grid" and solver.step.host_reads == 1
    assert torch.isfinite(stepped.bodies.pos).all()
    assert (solver_grid.grid_gates.launches, solver_grid.grid_predict.launches,
            solver_grid.grid_finalize.launches) == (0, 0, 0)


@pytest.fixture
def no_build(monkeypatch):
    """kernels._lib fails the test if a launcher reaches the build."""
    def refuse():
        raise AssertionError("the launcher built the kernels before checking its operands")

    monkeypatch.setattr(kernels, "_lib", refuse)


def test_stage_launchers_reject_bad_operands_before_building(base, no_build):
    """Each stage launcher checks dtype, shape and device of its operands
    before it builds or launches anything."""
    _jw, params, _cap = base
    tp = tparams_of(params)
    _jw1, tw = worlds(base, "moved")
    b, bp = tw.bodies, tw.bp
    with pytest.raises(ValueError, match="shape"):
        kernels.launch_grid_gates(b, bp.anchor[:2], bp.anchor_quat, bp.slack, tp)
    with pytest.raises(TypeError, match="dtype"):
        kernels.launch_grid_gates(b, bp.anchor, bp.anchor_quat, bp.slack.double(), tp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.launch_grid_gates(b, bp.anchor, bp.anchor_quat, bp.slack, tp)
    stick = tw.contacts.stick
    with pytest.raises(TypeError, match="dtype"):
        kernels.launch_grid_predict(b, stick.float(), tp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.launch_grid_predict(b, stick, tp)
    args = finalize_inputs(tw, tp, "moved")
    contacts = args[0]
    with pytest.raises(TypeError, match="dtype"):
        kernels.launch_grid_finalize(b, *args[1:5], args[5], contacts.replace(
            stick=contacts.stick > 0.5), *args[6:], tp)
    with pytest.raises(ValueError, match="shape"):
        kernels.launch_grid_finalize(b, args[1][:2], *args[2:5], args[5], contacts, *args[6:],
                                     tp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.launch_grid_finalize(b, *args[1:5], args[5], contacts, *args[6:], tp)


def test_stage_trace_attributes_launches_to_the_innermost_stage():
    """utils/stage_trace.attribute on a made-up trace: each launch call goes
    to the innermost stage range around it, each kernel on the card to its
    launch call by id, a range's host time less the ranges inside it, and
    the profiler's mirror of a range on the device is no kernel."""
    from torch.autograd import DeviceType

    from avbd3d_tpu_torch.utils import stage_trace

    def ev(name, start, end, dev=DeviceType.CPU, eid=0):
        return types.SimpleNamespace(name=name, device_type=dev, is_async=False, id=eid,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    cuda = DeviceType.CUDA
    events = [ev("step (other)", 0, 100), ev("predict", 10, 40), ev("K6", 50, 90),
              ev("cudaLaunchKernel", 12, 13, eid=1), ev("cudaLaunchKernel", 20, 21, eid=2),
              ev("cudaLaunchKernel", 60, 61, eid=3), ev("cudaLaunchKernel", 95, 96, eid=4),
              ev("cudaMemcpyAsync", 41, 42, eid=5),
              ev("k_grid_predict", 14, 19, cuda, 1), ev("k_sweeps<1024>", 62, 80, cuda, 3),
              ev("void k_x", 22, 24, cuda, 2), ev("predict", 10, 40, cuda, 9)]
    out = stage_trace.attribute(events, {"step (other)", "predict", "K6"})
    assert (out["predict"]["launches"], out["K6"]["launches"],
            out["step (other)"]["launches"]) == (2, 1, 1)
    assert out["step (other)"]["copies"] == 1
    assert (out["predict"]["kernels"], out["predict"]["device_us"]) == (2, 7.0)
    assert dict(out["predict"]["by_kernel"]) == {"k_grid_predict": 1, "k_x": 1}
    assert (out["K6"]["device_us"], out["step (other)"]["host_us"]) == (18.0, 30.0)
    assert "unmatched" not in out
