"""The fused path's stages around K1 and K2 (solver.step_gates,
solver.ballistic_step) and K1's diagnostics row in the state layout: their
plain versions against the JAX reference on the CPU, and the wrappers'
dispatch.  The kernels of csrc/fused_stages.cu and K1's new tail against
their plain versions on the card are tests/test_torch_port.py's (a file
without JAX, which the card's machine lacks) and chip_smoke.py's phase 21.

Inputs: a pile of cubes 1.6 m apart at N = 1024 (a contact-free pile in
free fall, built as test_torch_parity_grid.py builds its piles), and states
made from it with numpy seeds:
bodies moved and turned and given velocities, a body below
``fall_freeze_y``, non-finite velocities and an angular speed above the
80 rad/s clamp, every body static.  The reference's gates are its
fall-freeze lines (solver.step, avbd3d_tpu/solver.py:325-333) and the
values the port's host read copies (diagnostics lanes 0-15, bp.slack,
bp.dropped); its ballistic step ``solver._ballistic_step``.  K1's row in
the state layout is held against the reference's ``step_pallas`` (its
assembly, solver_tpu.py:1142-1152) run through the kernel bodies' math
twins as tests/test_torch_parity_step.py runs it, on a touching 128-body
pile's first step.  Tolerances: flags, integers, counts and frozen fields
identical; floats within rtol 1e-5, atol 1e-5 (the same float32 operations
rounded by two libraries); K1's row, whose float lanes come out of 20
sweeps, as test_torch_parity_step.py holds a step: the count lanes
identical, each float lane within 2e-4 + 1e-4 relative + 4x the
reference's own change when its poses move one float32 ulp.
"""

import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_grid_stages import overflows, pose_arrays
from test_torch_parity_grid import STRESS, jtree, pile, tparams_of

import avbd3d_tpu_torch
from avbd3d_tpu import solver as jsolver
from avbd3d_tpu import solver_tpu as jsolver_tpu
from avbd3d_tpu.config import SolverParams as JParams
from avbd3d_tpu.models import scenes as jscenes
from avbd3d_tpu.ops import broadphase as jbp
from avbd3d_tpu_torch import kernels, solver, solver_cuda
from avbd3d_tpu_torch.config import Capacity
from avbd3d_tpu_torch.convert import world_from_arrays
from avbd3d_tpu_torch.ops.broadphase import refresh_scalar

torch.set_num_threads(1)

BODY_FIELDS = ("pos", "quat", "linvel", "angvel", "prev_linvel", "prev_angvel", "inv_mass")
STATES = ("falling", "moved", "fallen", "nonfinite", "static")
# Poses the prediction's sanitizes meet, on the moved state: one dynamic
# body's pos.y NaN; one at pos.x 3.4e38 moving at linvel.x 3e38, whose pos
# + linvel dt passes the largest float32 at the scene's dt (test_torch_grid_
# stages.py's pose_arrays).
POSE_STATES = ("nan_pose", "overflow")


def spread_pile(nx, ny, nz, min_bodies, seed):
    """Ground + an nx*ny*nz pile of unit cubes 1.6 m apart in every
    direction, the lowest layer 2 m above the ground, jittered in position,
    tilt and velocity from a numpy seed, with fresh candidate lists: no two
    bodies within the collision margin (a pile in free fall).  Returns the
    reference World and its params / cap (the Stress tuning)."""
    rng = np.random.default_rng(seed)
    sb = jscenes.SceneBuilder()
    sb.add_body((100, 1, 100), 0.0, 0.5, (0, -0.5, 0))
    for y in range(ny):
        for z in range(nz):
            for x in range(nx):
                axis = rng.normal(size=3)
                axis /= np.linalg.norm(axis)
                ang = rng.uniform(0.0, 0.05)
                q = (*(axis * np.sin(ang / 2)), np.cos(ang / 2))
                v = tuple(rng.uniform(-0.1, 0.1, 3) + (0.0, -2.0, 0.0))
                sb.add_body((1, 1, 1), 1.0, 0.5,
                            tuple(np.array([(x - (nx - 1) / 2) * 1.6, 2.5 + y * 1.6,
                                            (z - (nz - 1) / 2) * 1.6])
                                  + rng.uniform(-0.02, 0.02, 3)), q, v)
    world, params, cap, _ = sb.build(JParams(**STRESS), max_degree=16, min_bodies=min_bodies,
                                     cache_degree=8)
    bp = jbp.build_bp_cache(world.bodies, world.exclusions, cap.max_degree, params.bp_margin)
    return world.replace(bp=bp), params, cap


@pytest.fixture(scope="module")
def base():
    """A 6 x 3 x 6 spread pile at N = 1024 in free fall, its params with
    the fall-freeze at y = -2 (reachable by a moved body)."""
    jw, params, cap = spread_pile(6, 3, 6, 1024, seed=9)
    assert jw.bodies.n == 1024
    return jw, params.replace(fall_freeze_y=-2.0), cap


def state_arrays(jw, name: str) -> dict:
    """The body fields of state ``name`` as numpy arrays (C, G, 128)."""
    if name in POSE_STATES:
        return pose_arrays(state_arrays(jw, "moved"), name)
    b = jax.device_get(dataclasses.asdict(jw.bodies))
    a = {k: np.array(b[k], dtype=np.float32) for k in BODY_FIELDS}
    rng = np.random.default_rng(STATES.index(name) + 21)
    dyn = a["inv_mass"] > 0
    ids = np.flatnonzero(dyn.reshape(-1))
    if name == "falling":
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


def worlds(base, name: str):
    """State ``name`` as the reference's World and the port's, with a
    diagnostics vector and a cache slack drawn from the seed (the values the
    host read copies)."""
    jw, _params, _cap = base
    a = state_arrays(jw, name)
    rng = np.random.default_rng((STATES + POSE_STATES).index(name) + 41)
    vec = rng.uniform(0.0, 10.0, 16).astype(np.float32)
    jw = jw.replace(bodies=jw.bodies.replace(**{k: jnp.asarray(v) for k, v in a.items()}),
                    bp=jw.bp.replace(slack=jnp.float32(rng.uniform(0.0, 1.0))),
                    diagnostics=jw.diagnostics.replace(vec=jnp.asarray(vec)))
    return jw, world_from_arrays(jtree(jw), "cpu")


def reference_freeze(jw, params):
    """The reference step's fall-freeze (avbd3d_tpu/solver.py:325-333)."""
    b = jw.bodies
    frozen = b.dynamic & (b.pos[1] < params.fall_freeze_y)
    return jw.replace(bodies=b.replace(linvel=jnp.where(frozen[None], 0.0, b.linvel),
                                       angvel=jnp.where(frozen[None], 0.0, b.angvel),
                                       inv_mass=jnp.where(frozen, 0.0, b.inv_mass)))


@pytest.mark.parametrize("name", STATES)
def test_gates_match_reference(base, name):
    """step_gates' plain version against the reference's fall-freeze and the
    values the host read copies: the frozen fields identical, the control
    vector lanes 0-15, slack and dropped; the world it was given unchanged;
    without the fall-freeze (fall_freeze_y <= -1e8) the bodies its own."""
    _jw, params, _cap = base
    jw, tw = worlds(base, name)
    linvel = tw.bodies.linvel.clone()
    got_w, vec = solver.step_gates(tw, tparams_of(params))
    ref = reference_freeze(jw, params)
    for f in ("linvel", "angvel", "inv_mass"):
        np.testing.assert_array_equal(getattr(got_w.bodies, f).numpy(),
                                      np.asarray(getattr(ref.bodies, f)), err_msg=f"{name} {f}")
    assert vec.dtype == torch.float32 and vec.shape == (18,)
    want = np.concatenate([np.asarray(jw.diagnostics.vec), [np.asarray(jw.bp.slack)],
                           [np.float32(np.asarray(jw.bp.dropped))]]).astype(np.float32)
    np.testing.assert_array_equal(vec.numpy(), want)
    assert torch.equal(tw.bodies.linvel.nan_to_num(), linvel.nan_to_num())
    frozen = int((tw.bodies.inv_mass > 0).sum() - (got_w.bodies.inv_mass > 0).sum())
    assert frozen == (3 if name == "fallen" else 0), (name, frozen)
    off_w, off_vec = solver.step_gates(tw, tparams_of(params.replace(fall_freeze_y=-1e9)))
    assert off_w.bodies.inv_mass is tw.bodies.inv_mass and torch.equal(off_vec, vec)


@pytest.mark.parametrize("name", STATES + POSE_STATES)
def test_ballistic_step_matches_reference(base, name):
    """ballistic_step's plain version against the reference's
    _ballistic_step on the frozen state: the new bodies within the
    tolerance (a NaN or an infinity the same), diagnostics lanes 5-10
    identical (the sanitize count above 0 at the non-finite state; 2 at a
    NaN pose and at the overflowed one: the warm start and the linear
    finalize, the inertial position infinite there at the scene's dt),
    lanes 0-4 and the control block 11-15 within the tolerance, the contact
    cache and the step index carried."""
    _jw, params, cap = base
    jw, tw = worlds(base, name)
    jw = reference_freeze(jw, params)
    tw, _vec = solver.step_gates(tw, tparams_of(params))
    out = solver.ballistic_step(tw, tparams_of(params))
    ref = jsolver._ballistic_step(jw, params, cap)
    for f in BODY_FIELDS:
        np.testing.assert_allclose(getattr(out.bodies, f).numpy(),
                                   np.asarray(getattr(ref.bodies, f)), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} {f}")
    tv, jv = out.diagnostics.vec.numpy(), np.asarray(ref.diagnostics.vec)
    np.testing.assert_array_equal(tv[5:11], jv[5:11], err_msg=name)
    np.testing.assert_allclose(tv[:5], jv[:5], rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(tv[11:], jv[11:], rtol=1e-5, atol=1e-5, err_msg=name)
    assert out.contacts is tw.contacts and out.step_index == tw.step_index + 1
    if name == "nonfinite":
        assert tv[8] >= 2, tv
    if name in POSE_STATES:
        assert tv[8] == 2, (name, tv)
    if name == "overflow":
        assert overflows(state_arrays(_jw, name), params.dt)
        assert np.isinf(out.bodies.pos.numpy()).sum() == 1, name
    if name == "falling":
        assert tv[13] > params.collision_margin and tv[7] == 108, tv


@pytest.fixture(scope="module")
def touching():
    """A 4 x 2 x 4 pile (N = 128) whose layers touch: the port's world with
    the cache and the gates of its first step as the port's step prepares
    them (the scalar-gated refresh, the variant), K1's operands, and the
    reference's step_pallas of it through the kernel bodies' math twins,
    also from its poses one float32 ulp up (the reference's own
    sensitivity, test_torch_parity_step.py's ``nudged``)."""
    jw, params, cap = pile(4, 2, 4, 128, max_degree=16, cache_degree=8, seed=3)
    cap = cap.replace(backend="pallas")
    step = jax.jit(jsolver_tpu.step_pallas, static_argnums=(1, 2))
    ref = step(jw, params, cap).diagnostics.vec
    pos = np.asarray(jw.bodies.pos)
    up = np.where(np.asarray(jw.bodies.inv_mass)[None] > 0, np.nextafter(pos, np.float32(np.inf)),
                  pos).astype(np.float32)
    ref_up = step(jw.replace(bodies=jw.bodies.replace(pos=jnp.asarray(up))), params,
                  cap).diagnostics.vec
    tw = world_from_arrays(jtree(jw), "cpu")
    tp = tparams_of(params)
    dv = solver.control_vector(tw).numpy()
    bp, refreshed = refresh_scalar(tw.bp, dv, tw.bodies, tw.exclusions, cap.max_degree,
                                   tp.bp_margin)
    gates = solver.control_gates(dv, refreshed, tp)
    args = (tw.contacts, bp.nb, bp.key, bp.thr, tw.bodies, bp.anchor, bp.anchor_quat, tp,
            *solver_cuda.select_variant(tp, *gates), bp.cand)
    return {"world": tw.replace(bp=bp), "params": tp, "gates": gates, "args": args,
            "ref": np.asarray(ref), "ref_up": np.asarray(ref_up)}


def test_k1_state_row_matches_reference(touching):
    """K1's plain version: row 1 is row 0 in the state layout (lanes 0-8,
    the pair overflow cand - kept as an int32 difference and as the float
    one the port took before, the dropped manifolds, the control lanes),
    the rest of the row 0, and equals the reference's assembled
    diagnostics after step_pallas (count lanes identical, the others within
    the tolerance of the module docstring)."""
    args = touching["args"]
    cand = args[10]
    _c, _b, diag, _rows = solver_cuda.step_kernel_plain(*args)
    row0, row1 = diag[0], diag[1]
    want = torch.cat([row0[:9], (cand.to(torch.float32) - row0[9]).reshape(1), row0[15:16],
                      row0[10:15]])
    assert torch.equal(row1[:16], want) and not row1[16:].any()
    assert float(row1[9]) == float(cand - row0[9].to(torch.int32))
    tv, jv = row1[:16].numpy(), touching["ref"]
    np.testing.assert_array_equal(tv[5:11], jv[5:11])
    assert tv[5] > 50 and tv[7] == 32, tv
    sens = np.abs(touching["ref_up"] - jv)
    floats = [0, 1, 2, 3, 4, 11, 12, 13, 14, 15]
    np.testing.assert_array_less(np.abs(tv - jv)[floats],
                                 (4.0 * sens + 1e-4 * np.abs(jv) + 2e-4)[floats])


def test_step_fused_diagnostics_are_k1_row(touching):
    """step_fused's diagnostics are K1's row 1 as it is (no reordering op),
    its contacts the kernel's cache with bool latches."""
    contacts, _b, diag, _rows = solver_cuda.step_kernel_plain(*touching["args"])
    out = solver_cuda.step_fused(touching["world"], touching["params"], Capacity(),
                                 *touching["gates"])
    assert out.contacts.stick.dtype == torch.bool
    assert torch.equal(out.contacts.stick, contacts.stick)
    assert torch.equal(out.diagnostics.vec, diag[1, :16])


class _NoKernels(types.ModuleType):
    """Stands in for avbd3d_tpu_torch.kernels: any use fails."""

    def __getattr__(self, name):
        raise AssertionError(f"kernels.{name} used on CPU tensors")


def test_cpu_tensors_take_the_plain_versions(base, monkeypatch):
    """On CPU tensors the two wrappers, K1 and K2 with
    ``out`` run their plain versions, the kernels module is never touched
    and no count moves; a fused step neither, with one host read."""
    trap = _NoKernels("avbd3d_tpu_torch.kernels")
    monkeypatch.setitem(sys.modules, "avbd3d_tpu_torch.kernels", trap)
    monkeypatch.setattr(avbd3d_tpu_torch, "kernels", trap)
    solver_cuda.reset_launch_counts()
    _jw, params, cap = base
    tp = tparams_of(params)
    _jw1, tw = worlds(base, "fallen")
    got_w, got = solver.step_gates(tw, tp)
    want_w, want = solver.step_gates_plain(tw, tp)
    assert torch.equal(got, want) and torch.equal(got_w.bodies.inv_mass, want_w.bodies.inv_mass)
    out = solver.ballistic_step(got_w, tp)
    ref = solver._ballistic_step(got_w, tp)
    assert torch.equal(out.diagnostics.vec, ref.diagnostics.vec)
    assert all(torch.equal(getattr(out.bodies, f), getattr(ref.bodies, f)) for f in BODY_FIELDS)
    bp = got_w.bp
    lanes = torch.zeros(16)
    back = solver_cuda.control_lanes(bp.nb, out.bodies, bp.anchor, bp.anchor_quat, tp,
                                     out=lanes[11:])
    assert back.data_ptr() == lanes[11:].data_ptr()
    assert torch.equal(lanes[11:], out.diagnostics.vec[11:]) and not lanes[:11].any()
    solver.step.host_reads = 0
    fused_cap = Capacity(**dataclasses.asdict(cap)).replace(backend="pallas")
    stepped = solver.step(got_w, tp, fused_cap)
    assert solver.step.last_path == "fused" and solver.step.host_reads == 1
    assert solver.step.last_gates["ballistic"] is False
    assert torch.isfinite(stepped.bodies.pos).all()
    assert (solver.step_gates.launches, solver.ballistic_step.launches,
            solver_cuda.step_kernel.launches, solver_cuda.control_lanes.launches) == (0, 0, 0, 0)


@pytest.fixture
def no_build(monkeypatch):
    """kernels._lib fails the test if a launcher reaches the build."""
    def refuse():
        raise AssertionError("the launcher built the kernels before checking its operands")

    monkeypatch.setattr(kernels, "_lib", refuse)


def test_fused_launchers_reject_bad_operands_before_building(base, touching, no_build):
    """The fused path's launchers check dtype, shape and device of their
    operands before they build or launch anything: the gates, the
    ballistic step, K2's ``out`` and K1's bool latches and ``cand``."""
    _jw, params, _cap = base
    tp = tparams_of(params)
    _jw1, tw = worlds(base, "moved")
    b, bp, vec = tw.bodies, tw.bp, tw.diagnostics.vec
    with pytest.raises(ValueError, match="shape"):
        kernels.launch_step_gates(b, vec[:15], bp.slack, bp.dropped, tp)
    with pytest.raises(TypeError, match="dtype"):
        kernels.launch_step_gates(b, vec, bp.slack, bp.dropped.float(), tp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.launch_step_gates(b, vec, bp.slack, bp.dropped, tp)
    c = tw.contacts
    with pytest.raises(TypeError, match="dtype"):
        kernels.launch_ballistic_step(b, c.replace(count=c.count.float()), tp)
    with pytest.raises(ValueError, match="shape"):
        kernels.launch_ballistic_step(b, c.replace(lam=c.lam[:4]), tp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.launch_ballistic_step(b, c, tp)
    with pytest.raises(ValueError, match="shape"):
        kernels.launch_control(bp.nb, b, bp.anchor, bp.anchor_quat, tp, out=vec[10:])
    args = touching["args"]
    old, rest = args[0], args[1:]
    plan = solver_cuda.sweep_plan(old.other.shape[1] * 128, old.other.shape[0])
    floats = solver_cuda.cache_to_args(old)
    with pytest.raises(TypeError, match="cache"):
        kernels.launch_step(floats, *rest, plan=plan)
    with pytest.raises(TypeError, match="cand"):
        kernels.launch_step(solver_cuda.cache_leaves(old), *rest[:9], args[10].float(),
                            plan=plan)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.launch_step(solver_cuda.cache_leaves(old), *rest, plan=plan)
