"""The application layer of the PyTorch port against the JAX reference, on
the CPU: ``pick``, checkpoint save/load/resume (and checkpoints crossing
between the two packages), ``reset_control``, the OBJ export and the
render overlays.

States are made by the port (its plain kernel versions) and handed to the
reference as the same arrays, so no reference step is compiled here.
Float comparisons are held to 1e-5 (the same float32 formulas in two
libraries); indices, counts and checkpoint contents must be identical.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avbd3d_tpu import queries as jqueries
from avbd3d_tpu import state as jstate
from avbd3d_tpu.models import scenes as jscenes
from avbd3d_tpu.ops import broadphase as jbp
from avbd3d_tpu.utils import checkpoint as jcheckpoint
from avbd3d_tpu.utils import export as jexport
from avbd3d_tpu.utils import overlay as joverlay

import avbd3d_tpu_torch as port
from avbd3d_tpu_torch import load_scene, pick, run_steps, state
from avbd3d_tpu_torch.convert import world_from_arrays, world_to_arrays
from avbd3d_tpu_torch.utils import overlay
from avbd3d_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from avbd3d_tpu_torch.utils.export import export_obj

torch.set_num_threads(1)


def jtree(world):
    return jax.device_get(dataclasses.asdict(world))


def jax_world(tw):
    """The reference's World holding the port world's arrays."""
    a = world_to_arrays(tw)

    def build(cls, tree):
        return cls(**{k: jnp.asarray(v) for k, v in tree.items()})

    return jstate.World(
        bodies=build(jstate.Bodies, a["bodies"]), contacts=build(jstate.Contacts, a["contacts"]),
        joints=build(jstate.Joints, a["joints"]), springs=build(jstate.Springs, a["springs"]),
        exclusions=jnp.asarray(a["exclusions"]), bp=build(jbp.BroadphaseCache, a["bp"]),
        step_index=jnp.asarray(a["step_index"]),
        diagnostics=jstate.Diagnostics(vec=jnp.asarray(a["diagnostics"]["vec"])))


def assert_worlds_equal(a, b):
    """Every leaf of two port worlds bitwise equal (NaN-free states)."""
    ta, tb = world_to_arrays(a), world_to_arrays(b)
    for group in ta:
        if isinstance(ta[group], dict):
            for name in ta[group]:
                np.testing.assert_array_equal(ta[group][name], tb[group][name],
                                              err_msg=f"{group}.{name}")
                assert ta[group][name].dtype == tb[group][name].dtype, f"{group}.{name}"
        else:
            np.testing.assert_array_equal(ta[group], tb[group], err_msg=group)


def test_package_exports_match_reference():
    import avbd3d_tpu

    for name in ("Joints", "Springs", "pick"):
        assert name in avbd3d_tpu.__all__ and name in port.__all__
        assert getattr(port, name) is not None


# ---------------------------------------------------------------------------
# pick
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stack_pair():
    jw = jscenes.load_scene("Stack").world
    return jw, world_from_arrays(jtree(jw), "cpu")


RAYS = {
    "top hit": ((0.0, 20.0, 0.0), (0.0, -1.0, 0.0)),
    "ground miss": ((30.0, 5.0, 0.0), (0.0, -1.0, 0.0)),       # the slab is static
    "pointing away": ((0.0, 20.0, 0.0), (0.0, 1.0, 0.0)),
    "side hit, unnormalized": ((-10.0, 0.6, 0.1), (3.0, 0.0, 0.0)),
    "oblique": ((4.0, 12.0, 3.0), (-0.4, -0.8, -0.3)),
    "zero direction": ((0.0, 20.0, 0.0), (0.0, 0.0, 0.0)),
}


@pytest.mark.parametrize("ray", list(RAYS))
def test_pick_matches_reference(stack_pair, ray):
    jw, tw = stack_pair
    origin, direction = RAYS[ray]
    ji, jt, jp = jax.device_get(jqueries.pick(jw.bodies, origin, direction))
    ti, tt, tp = pick(tw.bodies, origin, direction)
    assert int(ti) == int(ji)
    assert abs(float(tt) - float(jt)) <= 1e-5
    if int(ji) >= 0:
        np.testing.assert_allclose(tp.numpy(), jp, atol=1e-5, rtol=0)
    want_hit = ray in ("top hit", "side hit, unnormalized", "oblique")
    assert (int(ti) >= 0) == want_hit
    if ray == "top hit":
        assert int(ti) == 10 and bool(tw.bodies.dynamic.reshape(-1)[int(ti)])


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_block_30():
    sc = load_scene("TwoBlockDrop", device="cpu")
    return sc, run_steps(sc.world, sc.params, sc.cap, 30)


def test_checkpoint_round_trip_is_bit_exact(two_block_30, tmp_path):
    sc, w = two_block_30
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, w, sc.params, sc.cap)
    w2, p2, c2 = load_checkpoint(path, "cpu")
    assert p2 == sc.params and c2 == sc.cap and w2.step_index == 30
    assert isinstance(w2.step_index, int)
    assert_worlds_equal(w, w2)
    assert int(w.diagnostics.as_dict()["active_contacts"]) > 0


def test_checkpoint_round_trip_with_joints(tmp_path):
    sc = load_scene("RodJointed", device="cpu")
    path = str(tmp_path / "rod.npz")
    save_checkpoint(path, sc.world, sc.params, sc.cap)
    w2, p2, c2 = load_checkpoint(path, "cpu")
    assert p2 == sc.params and c2 == sc.cap
    assert (w2.joints.dj, c2.joint_colors) == (sc.world.joints.dj, sc.cap.joint_colors) == (2, 2)
    assert_worlds_equal(sc.world, w2)


def test_resumed_run_equals_uninterrupted(two_block_30, tmp_path):
    sc, w = two_block_30
    path = str(tmp_path / "pause.npz")
    save_checkpoint(path, w, sc.params, sc.cap)
    straight = run_steps(w, sc.params, sc.cap, 5)
    w2, p2, c2 = load_checkpoint(path, "cpu")
    resumed = run_steps(w2, p2, c2, 5)
    assert resumed.step_index == 35
    assert_worlds_equal(straight, resumed)


@pytest.mark.parametrize("name", ["Stack", "RodJointed", "SoftGrid"])
def test_reference_checkpoint_loads_in_the_port(name, tmp_path):
    """A checkpoint the JAX package wrote loads into the world that
    ``world_from_arrays`` makes of the same scene, with equal config."""
    jsc = jscenes.load_scene(name)
    path = str(tmp_path / "ref.npz")
    jcheckpoint.save_checkpoint(path, jsc.world, jsc.params, jsc.cap)
    w, p, c = load_checkpoint(path, "cpu")
    assert_worlds_equal(world_from_arrays(jtree(jsc.world), "cpu"), w)
    assert dataclasses.asdict(p) == dataclasses.asdict(jsc.params)
    assert dataclasses.asdict(c) == dataclasses.asdict(jsc.cap)


def test_port_checkpoint_loads_in_the_reference(two_block_30, tmp_path):
    sc, w = two_block_30
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, w, sc.params, sc.cap)
    jw, jp, jc = jcheckpoint.load_checkpoint(path)
    got, want = jtree(jw), world_to_arrays(w)
    for group in ("bodies", "contacts", "joints", "springs", "bp"):
        for leaf in want[group]:
            np.testing.assert_array_equal(got[group][leaf], want[group][leaf])
    assert int(got["step_index"]) == 30
    assert dataclasses.asdict(jp) == dataclasses.asdict(sc.params)


def test_checkpoint_rejects_foreign_keys(tmp_path):
    path = str(tmp_path / "bad.npz")
    np.savez(path, __meta__=np.frombuffer(b"{}", dtype=np.uint8), other=np.zeros(3))
    with pytest.raises(ValueError, match="unexpected key"):
        load_checkpoint(path, "cpu")


# ---------------------------------------------------------------------------
# reset_control, export, overlays
# ---------------------------------------------------------------------------

def test_reset_control_matches_reference():
    vec = np.arange(16, dtype=np.float32) + 0.5
    want = np.asarray(jstate.reset_control(jstate.Diagnostics(vec=jnp.asarray(vec))).vec)
    diag = state.Diagnostics(vec=torch.from_numpy(vec.copy()))
    got = state.reset_control(diag)
    np.testing.assert_array_equal(got.vec.numpy(), want)
    np.testing.assert_array_equal(diag.vec.numpy(), vec)          # the input is untouched
    assert got.vec.dtype == torch.float32


@pytest.fixture(scope="module")
def stack_settling():
    sc = load_scene("Stack", device="cpu")
    return sc, run_steps(sc.world, sc.params, sc.cap, 40)


def obj_counts(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return {tag: sum(1 for ln in lines if ln.startswith(tag + " "))
            for tag in ("v", "f", "l", "o", "usemtl")}


def test_export_obj_counts_match_reference(stack_settling, tmp_path):
    sc, w = stack_settling
    ours, theirs = str(tmp_path / "port.obj"), str(tmp_path / "ref.obj")
    export_obj(ours, w, sc.n_real)
    jexport.export_obj(theirs, jax_world(w), sc.n_real)
    got, want = obj_counts(ours), obj_counts(theirs)
    assert got == want
    assert got["v"] > 8 * sc.n_real and got["f"] > 6 * sc.n_real and got["l"] > 0
    assert os.path.exists(str(tmp_path / "port.mtl"))
    with open(ours) as f, open(theirs) as g:
        a = [ln for ln in f if ln.startswith("v ")]
        b = [ln for ln in g if ln.startswith("v ")]
    va = np.array([[float(x) for x in ln.split()[1:]] for ln in a])
    vb = np.array([[float(x) for x in ln.split()[1:]] for ln in b])
    np.testing.assert_allclose(va, vb, atol=1e-5, rtol=0)


def test_export_sequence_steps_and_writes_frames(tmp_path):
    from avbd3d_tpu_torch.utils.export import export_sequence

    sc = load_scene("Ground", device="cpu")
    w = export_sequence(str(tmp_path / "f"), sc.world, sc.params, sc.cap, sc.n_real,
                        n_frames=2, steps_per_frame=2)
    assert w.step_index == 4
    assert sorted(os.listdir(tmp_path)) == ["f00000.mtl", "f00000.obj", "f00001.mtl",
                                            "f00001.obj"]
    assert obj_counts(str(tmp_path / "f00001.obj"))["v"] == 8


def assert_overlays_match(tw):
    jw = jax_world(tw)
    mid, normal, stick = overlay.contact_overlay(tw)
    jmid, jnormal, jstick = joverlay.contact_overlay(jw)
    assert mid.shape == jmid.shape and stick.dtype == bool
    np.testing.assert_allclose(mid, jmid, atol=1e-5, rtol=0)
    np.testing.assert_allclose(normal, jnormal, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(stick, jstick)
    for ours, theirs in ((overlay.joint_overlay, joverlay.joint_overlay),
                         (overlay.spring_overlay, joverlay.spring_overlay)):
        a, b = ours(tw), theirs(jw)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    return mid, overlay.joint_overlay(tw), overlay.spring_overlay(tw)


def test_overlays_match_reference_settled_two_block_drop():
    sc = load_scene("TwoBlockDrop", device="cpu")
    w = run_steps(sc.world, sc.params, sc.cap, 150)
    mid, joints, springs = assert_overlays_match(w)
    d = w.diagnostics.as_dict()
    assert d["active_manifolds"] == 2 and mid.shape == (int(d["active_contacts"]), 3)
    assert joints.shape == (0, 2, 3) and springs.shape == (0, 2, 3)


def test_overlays_match_reference_rod_jointed():
    sc = load_scene("RodJointed", device="cpu")
    w = run_steps(sc.world, sc.params, sc.cap, 1)
    _mid, joints, _springs = assert_overlays_match(w)
    assert joints.shape == (14, 2, 3)
    # A hard weld holds its two anchors together.
    assert float(np.abs(joints[:, 0] - joints[:, 1]).max()) < 0.05


def test_overlays_match_reference_springs_and_world_anchor():
    """A spring between two bodies and a joint anchored to the world
    (body_a == -1): the dense tables' other two cases."""
    sb = port.SceneBuilder()
    a = sb.add_body((1, 1, 1), 0.0, 0.5, (0.0, 5.0, 0.0))
    b = sb.add_body((1, 1, 1), 1.0, 0.5, (0.0, 3.0, 0.0))
    sb.add_spring(a, b, (0, 0.1, 0), (0, 0.2, 0), stiffness=100.0)
    sb.add_world_joint(b, (0.0, 3.5, 0.0))
    arrays, _p, _cap, _ = sb.build(port.SolverParams())
    _mid, joints, springs = assert_overlays_match(world_from_arrays(arrays, "cpu"))
    assert joints.shape == (1, 2, 3) and springs.shape == (1, 2, 3)
    np.testing.assert_allclose(joints[0, 0], (0.0, 3.5, 0.0), atol=1e-6)
