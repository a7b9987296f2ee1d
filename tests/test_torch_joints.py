"""The port's joints, springs and jointed scenes against the JAX reference.

Same inputs, made from a seed with numpy, go through the reference
(``avbd3d_tpu``) and its port (``avbd3d_tpu_torch``): the SceneBuilder's
joint/spring/ignore API and the jointed scenes (every leaf identical), the
row functions of ops/joints.py and ops/springs.py on random replicated
joint sets (world joints, soft and hard rows, empty slots; integer masks
identical, floats within rtol 1e-5 of the reference and an absolute floor
of 1e-5 of each array's largest value, since the DJ sums run in another
order), plus the port-side dispatch of jointed worlds.  JAX runs eagerly
here; the whole-step comparisons are in test_torch_parity_joints.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avbd3d_tpu import config as jconfig
from avbd3d_tpu.models import scenes as jscenes
from avbd3d_tpu.ops import joints as jjoints
from avbd3d_tpu.ops import replicated as jrep
from avbd3d_tpu.ops import springs as jsprings

from avbd3d_tpu_torch import cli
from avbd3d_tpu_torch import config as tconfig
from avbd3d_tpu_torch import solver as tsolver
from avbd3d_tpu_torch.convert import world_from_arrays, world_to_arrays
from avbd3d_tpu_torch.models import scenes as tscenes
from avbd3d_tpu_torch.ops import joints as tjoints
from avbd3d_tpu_torch.ops import springs as tsprings
from avbd3d_tpu_torch.utils import profile_cuda, weld_sign_probe

torch.set_num_threads(1)

JOINT_SCENES = ["Rod (WIP)", "Soft Body (WIP)", "RodJointed", "SoftGrid"]


def flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, pre + k + "."))
        else:
            out[pre + k] = np.asarray(v)
    return out


def assert_same_world(jworld, arrays):
    a = flat(jax.device_get(dataclasses.asdict(jworld)))
    b = flat(world_to_arrays(world_from_arrays(arrays, "cpu")))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("name", JOINT_SCENES)
def test_joint_scene_matches_reference(name):
    """Every leaf (slots, sides, world flags, colours, exclusions, anchors)
    and the capacity plan identical to the reference's."""
    jw, jp, jcap, jn = jscenes.SCENES[name]()
    arrays, tp, tcap, tn = tscenes.SCENES[name]()
    assert tn == jn and tp == tconfig.SolverParams(**dataclasses.asdict(jp))
    assert dataclasses.asdict(tcap) == dataclasses.asdict(jcap)
    assert_same_world(jw, arrays)
    assert list(tscenes.SCENES) == list(jscenes.SCENES)


def random_builders(seed, n=40, n_joints=30, n_world=4, n_springs=10):
    """The same random world on both SceneBuilders: tilted boxes, a static
    body, hard and soft body-body joints, world joints, springs and ignore
    markers (bodies with fewer joints than the slot degree keep empty
    slots)."""
    rng = np.random.default_rng(seed)
    sbs = (jscenes.SceneBuilder(), tscenes.SceneBuilder())
    for i in range(n):
        q = rng.normal(size=4)
        q = tuple(float(x) for x in q / np.linalg.norm(q))
        pos = tuple(float(x) for x in rng.uniform(-3.0, 3.0, 3))
        for sb in sbs:
            sb.add_body((0.5, 1.0, 0.5), 0.0 if i == 0 else 1.0, 0.5, pos, q)
    inf = float("inf")
    for _ in range(n_joints):
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        ra, rb = (tuple(float(x) for x in rng.uniform(-0.5, 0.5, 3)) for _ in range(2))
        k_lin, k_ang = (inf, inf) if rng.random() < 0.5 else (500.0, 300.0)
        for sb in sbs:
            sb.add_joint(a, b, ra, rb, k_lin, k_ang)
    for _ in range(n_world):
        b = int(rng.integers(1, n))
        anchor = tuple(float(x) for x in rng.uniform(-3.0, 3.0, 3))
        k = inf if rng.random() < 0.5 else 800.0
        for sb in sbs:
            sb.add_world_joint(b, anchor, k, k)
    for _ in range(n_springs):
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        ra, rb = (tuple(float(x) for x in rng.uniform(-0.3, 0.3, 3)) for _ in range(2))
        k = float(rng.uniform(50.0, 5000.0))
        for sb in sbs:
            sb.add_spring(a, b, ra, rb, k)
    for _ in range(5):
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        for sb in sbs:
            sb.ignore_collision(a, b)
    return sbs


def test_custom_builder_world_matches_reference():
    """A world joint, springs and ignore pairs through the builder API: the
    dense views, the replicated slots, the greedy colouring, the exclusion
    table and the capacity plan are identical to the reference's."""
    jsb, tsb = random_builders(0)
    jw, _jp, jcap, _ = jsb.build(jconfig.SolverParams())
    arrays, _tp, tcap, _ = tsb.build(tconfig.SolverParams())
    assert dataclasses.asdict(tcap) == dataclasses.asdict(jcap)
    assert tcap.joint_degree > 0 and tcap.spring_degree > 0 and tcap.joint_colors > 1
    assert (arrays["joints"]["world"] > 0).sum() == 4
    assert_same_world(jw, arrays)


def test_jointed_world_round_trips():
    """world_from_arrays / world_to_arrays keep a non-empty joint and spring
    set leaf for leaf, and the containers carry dj / ds."""
    _jsb, tsb = random_builders(1)
    arrays = tsb.build(tconfig.SolverParams())[0]
    w = world_from_arrays(arrays, "cpu")
    assert w.joints.dj == arrays["joints"]["other"].shape[0] > 0
    assert w.springs.ds == arrays["springs"]["other"].shape[0] > 0
    back = world_to_arrays(w)
    for group in ("joints", "springs"):
        for k, v in arrays[group].items():
            np.testing.assert_array_equal(back[group][k], v, err_msg=f"{group}.{k}")


@pytest.fixture(scope="module")
def row_inputs():
    """A random jointed world on both sides, random poses (unit quats),
    joint duals and penalties, from one seed."""
    jsb, tsb = random_builders(2)
    jw = jsb.build(jconfig.SolverParams())[0]
    tw = world_from_arrays(tsb.build(tconfig.SolverParams())[0], "cpu")
    rng = np.random.default_rng(3)
    g = tw.bodies.g
    pos = rng.uniform(-3.0, 3.0, (3, g, 128)).astype(np.float32)
    q = rng.normal(size=(4, g, 128))
    quat = (q / np.linalg.norm(q, axis=0)).astype(np.float32)
    dj, ds = tw.joints.dj, tw.springs.ds
    lam = rng.normal(0.0, 50.0, (6, dj, g, 128)).astype(np.float32)
    pen = rng.uniform(2.0e4, 1.0e6, (6, dj, g, 128)).astype(np.float32)
    s_pen = rng.uniform(2.0e4, 1.0e6, (ds, g, 128)).astype(np.float32)
    jpose = {"pos": tuple(jnp.asarray(pos[k]) for k in range(3)),
             "quat": tuple(jnp.asarray(quat[k]) for k in range(4))}
    tpose = {"pos": tuple(torch.from_numpy(pos[k].copy()) for k in range(3)),
             "quat": tuple(torch.from_numpy(quat[k].copy()) for k in range(4))}
    jparams = jconfig.SolverParams(joint_dual_rate=0.3)
    tparams = tconfig.SolverParams(joint_dual_rate=0.3)
    return {"jw": jw, "tw": tw, "jpose": jpose, "tpose": tpose, "lam": lam, "pen": pen,
            "s_pen": s_pen, "jparams": jparams, "tparams": tparams}


def close(t, j, name):
    """Integers and masks identical; floats to rtol 1e-5 with an absolute
    floor of 1e-5 of the array's largest magnitude."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, (name, t.shape, j.shape)
    if j.dtype.kind in "ib":
        np.testing.assert_array_equal(t, j, err_msg=name)
    else:
        scale = float(np.max(np.abs(j[np.isfinite(j)]), initial=0.0))
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * max(scale, 1e-6), err_msg=name)


def close_tree(t, j, name):
    if isinstance(j, dict):
        for k in j:
            close_tree(t[k], j[k], f"{name}.{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), name
        for i, (a, b) in enumerate(zip(t, j)):
            close_tree(a, b, f"{name}[{i}]")
    else:
        close(t, j, name)


def _joint_case(fn, d):
    jj, tj = d["jw"].joints, d["tw"].joints
    jg = jjoints.joint_geometry(jj, d["jpose"], jrep.xla_gather)
    tg = tjoints.joint_geometry(tj, d["tpose"])
    lam, pen = d["lam"], d["pen"]
    jl, jp = jnp.asarray(lam), jnp.asarray(pen)
    tl, tp = torch.from_numpy(lam.copy()), torch.from_numpy(pen.copy())
    if fn == "decay":
        for post in (False, True):
            for ema in (0.0, 0.05):
                jpar = d["jparams"].replace(post_stabilize=post, joint_ema_rate=ema)
                tpar = d["tparams"].replace(post_stabilize=post, joint_ema_rate=ema)
                a = jjoints.joint_decay(jj.replace(lam=jl, penalty=jp), jpar)
                b = tjoints.joint_decay(tj.replace(lam=tl, penalty=tp), tpar)
                close(b.lam, a.lam, f"lam post={post} ema={ema}")
                close(b.penalty, a.penalty, f"penalty post={post} ema={ema}")
        return
    if fn == "geometry":
        close_tree(tg, jg, "geom")
        assert int(jnp.sum(jg["valid"])) < jg["valid"].size      # empty slots present
        assert bool(jnp.any(jg["is_world"]))
        return
    jf = jjoints.joint_force(jg, jj, jl, jp)
    tf = tjoints.joint_force(tg, tj, tl, tp)
    if fn == "force":
        close_tree(tf, jf, "f")
    elif fn == "accumulate":
        close_tree(tjoints.joint_accumulate(tg, tf, tp), jjoints.joint_accumulate(jg, jf, jp),
                   "acc")
    elif fn == "dual":
        a = jjoints.joint_dual(jg, jj, jl, jp, d["jparams"].beta, d["jparams"])
        b = tjoints.joint_dual(tg, tj, tl, tp, d["tparams"].beta, d["tparams"])
        close_tree(b, a, "dual")
    elif fn == "dual_ema":
        close(tjoints.joint_dual_ema(tg, tj, tl, tp, d["tparams"]),
              jjoints.joint_dual_ema(jg, jj, jl, jp, d["jparams"]), "ema")


@pytest.mark.parametrize("fn", ["decay", "geometry", "force", "accumulate", "dual",
                                "dual_ema"])
def test_joint_rows_match_reference(row_inputs, fn):
    _joint_case(fn, row_inputs)


@pytest.mark.parametrize("fn", ["decay", "geometry", "force", "accumulate"])
def test_spring_rows_match_reference(row_inputs, fn):
    d = row_inputs
    js, ts = d["jw"].springs, d["tw"].springs
    jpen, tpen = jnp.asarray(d["s_pen"]), torch.from_numpy(d["s_pen"].copy())
    if fn == "decay":
        a = jsprings.spring_decay(js.replace(penalty=jpen), d["jparams"])
        b = tsprings.spring_decay(ts.replace(penalty=tpen), d["tparams"])
        close(b.penalty, a.penalty, "penalty")
        return
    jg = jsprings.spring_geometry(js, d["jpose"], jrep.xla_gather)
    tg = tsprings.spring_geometry(ts, d["tpose"])
    if fn == "geometry":
        close_tree(tg, jg, "geom")
        return
    jf, tf = jsprings.spring_force(jg, jpen), tsprings.spring_force(tg, tpen)
    if fn == "force":
        close(tf, jf, "f")
    else:
        close_tree(tsprings.spring_accumulate(tg, tf, tpen),
                   jsprings.spring_accumulate(jg, jf, jpen), "acc")


def spring_world(with_spring: bool):
    """test_components.py's spring world: a static box and a box 2 m below
    it, linked by a spring of stiffness 100 (or not linked)."""
    sb = tscenes.SceneBuilder()
    a = sb.add_body((1, 1, 1), 0.0, 0.5, (0.0, 5.0, 0.0))
    b = sb.add_body((1, 1, 1), 1.0, 0.5, (0.0, 3.0, 0.0))
    if with_spring:
        sb.add_spring(a, b, (0, 0, 0), (0, 0, 0), stiffness=100.0)
    arrays, p, cap, _ = sb.build(tconfig.SolverParams())
    return world_from_arrays(arrays, "cpu"), p, cap


def test_ballistic_gate_off_for_jointed_worlds():
    """The ballistic fast path needs dj == 0 and ds == 0 (the reference's
    ballistic_able): a contact-free spring world runs the fused step every
    step, the same world without the spring goes ballistic."""
    for with_spring in (True, False):
        w, p, cap = spring_world(with_spring)
        seen = []
        for _ in range(4):
            w = tsolver.step(w, p, cap)
            seen.append(tsolver.step.last_gates["ballistic"])
        assert tsolver.step.last_path == "fused"
        assert any(seen) != with_spring, (with_spring, seen)
    assert w.diagnostics.as_dict()["active_manifolds"] == 0


def test_jointed_dispatch():
    """Jointed worlds take the fused path up to 2048 bodies; above it the
    portable path, as the reference runs its XLA path there; the grid tier
    is contact-only."""
    w = tscenes.load_scene("RodJointed", "cpu")
    assert tsolver.select_path(w.world, w.cap) == "fused"
    sb = tscenes.SceneBuilder()
    for i in range(2100):
        sb.add_body((0.5, 0.5, 0.5), 1.0, 0.5, (float(i), 1.0, 0.0))
    sb.add_joint(0, 1, (0.5, 0, 0), (-0.5, 0, 0))
    arrays, _p, cap, _ = sb.build(tconfig.SolverParams())
    big = world_from_arrays(arrays, "cpu")
    assert big.bodies.g % 8 == 0 and big.joints.dj == 1
    assert tsolver.select_path(big, cap) == "xla"
    with pytest.raises(ValueError, match="contact-only"):
        tsolver.select_path(big, cap.replace(backend="grid"))


def test_cli_defaults_to_the_card_and_takes_spaced_names(capsys):
    """--device defaults to cuda and raises without CUDA (no quiet
    fallback); a scene name with spaces runs with --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--nogfx", "--scene", "Stack", "--steps", "1"])
    assert cli.main(["--nogfx", "--scene", "Rod (WIP)", "--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "scene 'Rod (WIP)'" in out and out.count("Diagnostics:") == 2


def test_profiler_runs_plain_versions_on_cpu(capsys):
    """utils/profile_cuda on CPU tensors: the per-phase table from the
    plain versions, timed with the host clock and labelled cpu."""
    rows = profile_cuda.main(["TwoBlockDrop", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    names = [r[0] for r in rows]
    assert names == ["full step", "broadphase", "kernel A", "kernel B its=10",
                     "kernel B its=5", "kernel B its=1"]
    assert all(r[1] > 0.0 for r in rows) and "(cpu" in out
    assert f"reps={profile_cuda.CPU_REPS} " in out


def test_weld_sign_probe_finds_the_angular_rows():
    """utils/weld_sign_probe negates the angular row force by editing a copy
    of the package: each statement it edits is in the plain version and
    in K1 exactly once."""
    for rel, subs in weld_sign_probe._EDITS.items():
        with open(os.path.join(weld_sign_probe._PKG, rel)) as f:
            src = f.read()
        for old, new in subs:
            assert src.count(old) == 1 and new not in src, (rel, old)
