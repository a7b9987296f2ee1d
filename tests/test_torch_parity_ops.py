"""The PyTorch port against the JAX reference, module by module (CPU).

Same inputs, made from a seed with numpy, go through the reference function
(``avbd3d_tpu``) and its port (``avbd3d_tpu_torch``).  Integer outputs must
be identical; float tolerances are stated at each comparison.  JAX runs
eagerly here (no step compile); the whole-step comparisons live in
test_torch_parity_step.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avbd3d_tpu import cm as jcm
from avbd3d_tpu import config as jconfig
from avbd3d_tpu import maths as jmaths
from avbd3d_tpu.models import scenes as jscenes
from avbd3d_tpu.ops import broadphase as jbp
from avbd3d_tpu.ops import replicated as jrep
from avbd3d_tpu.ops.narrowphase_cm import collide_pairs_cm as j_collide

from avbd3d_tpu_torch import cm as tcm
from avbd3d_tpu_torch import config as tconfig
from avbd3d_tpu_torch import maths as tmaths
from avbd3d_tpu_torch.convert import world_from_arrays, world_to_arrays
from avbd3d_tpu_torch.models import scenes as tscenes
from avbd3d_tpu_torch.ops import broadphase as tbp
from avbd3d_tpu_torch.ops.narrowphase_cm import collide_pairs_cm as t_collide

torch.set_num_threads(1)


def jtree(world):
    """The reference World's leaves as nested dicts of numpy arrays."""
    return jax.device_get(dataclasses.asdict(world))


def flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, pre + k + "."))
        else:
            out[pre + k] = np.asarray(v)
    return out


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("cls", ["SolverParams", "Capacity"])
def test_config_defaults_match_reference(cls):
    ref = {f.name: f.default for f in dataclasses.fields(getattr(jconfig, cls))}
    ours = {f.name: f.default for f in dataclasses.fields(getattr(tconfig, cls))}
    assert ours == ref


@pytest.mark.parametrize("name", ["Stack", "TwoBlockDrop", "Stress1000"])
def test_scene_arrays_match_reference(name):
    """Numpy-only scene builder == the reference's arrays, bit for bit."""
    ref = jscenes.load_scene(name)
    ours = tscenes.load_scene(name, "cpu")
    assert ours.params == tconfig.SolverParams(**dataclasses.asdict(ref.params))
    assert dataclasses.asdict(ours.cap) == dataclasses.asdict(ref.cap)
    assert ours.n_real == ref.n_real
    a, b = flat(jtree(ref.world)), flat(world_to_arrays(ours.world))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_convert_round_trip_is_bit_exact():
    ref = jscenes.load_scene("TwoBlockDrop").world
    rng = np.random.default_rng(0)
    # Non-trivial leaves: random contact state and poses.
    c = ref.contacts
    ref = ref.replace(
        contacts=c.replace(
            lam=jnp.asarray(rng.normal(size=c.lam.shape).astype(np.float32)),
            stick=jnp.asarray(rng.random(c.stick.shape) > 0.5),
            feature=jnp.asarray(rng.integers(-1, 1 << 26, c.feature.shape, dtype=np.int32))),
        bodies=ref.bodies.replace(
            pos=jnp.asarray(rng.normal(size=ref.bodies.pos.shape).astype(np.float32))),
    )
    tree = jtree(ref)
    back = flat(world_to_arrays(world_from_arrays(tree, "cpu")))
    for k, v in flat(tree).items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_ops_and_solve66_match_reference():
    """Elementwise float math; the two libraries round each op alike, so
    rtol 1e-5 leaves room only for a different library reduction order."""
    rng = np.random.default_rng(1)
    q1, q2 = _rand_quats(rng, 256), _rand_quats(rng, 256)
    v = rng.normal(size=(256, 3)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmaths.quat_mul(T(q1), T(q2)).numpy(),
                               np.asarray(jmaths.quat_mul(q1, q2)), **tol)
    qs = (q1 * rng.uniform(0.5, 2.0, (256, 1))).astype(np.float32)
    qs[:4] = 1e-4   # degenerate quats fall back to the identity
    np.testing.assert_allclose(tmaths.quat_normalize(T(qs)).numpy(),
                               np.asarray(jmaths.quat_normalize(qs)), **tol)
    np.testing.assert_allclose(tmaths.quat_vec_doubled(T(q1)).numpy(),
                               np.asarray(jmaths.quat_vec_doubled(q1)), **tol)
    for x, y in zip(tcm.q_mul(tuple(T(q1.T)), tuple(T(q2.T))),
                    jcm.q_mul(tuple(q1.T), tuple(q2.T))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **tol)
    for x, y in zip(tcm.q_rotate(tuple(T(q1.T)), tuple(T(v.T))),
                    jcm.q_rotate(tuple(q1.T), tuple(v.T))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **tol)

    # 6x6 block systems like the solver's: SPD plus a few singular pivots.
    m = rng.normal(size=(512, 6, 6)).astype(np.float32)
    a = (m @ m.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)).astype(np.float32)
    a[:8, 0, :] = 0.0
    a[:8, :, 0] = 0.0
    rhs = rng.normal(size=(512, 6)).astype(np.float32)
    sym = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    a_ll = tuple(a[:, i, j] for i, j in sym)
    a_la = tuple(a[:, i, 3 + j] for i in range(3) for j in range(3))
    a_aa = tuple(a[:, 3 + i, 3 + j] for i, j in sym)
    b_l, b_a = tuple(rhs[:, k] for k in range(3)), tuple(rhs[:, 3 + k] for k in range(3))
    jd = jmaths.solve66_cm(a_ll, a_la, a_aa, b_l, b_a)
    td = tmaths.solve66_cm(*[tuple(T(x) for x in grp) for grp in (a_ll, a_la, a_aa, b_l, b_a)])
    for jj, tt in zip(jd, td):
        for x, y in zip(jj, tt):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5, atol=1e-5)


def _random_pairs(seed, p=2048):
    """Seeded box-pair poses around contact (as tests/test_narrowphase_twins)."""
    rng = np.random.default_rng(seed)
    size_a = rng.uniform(0.4, 2.5, (p, 3)).astype(np.float32)
    size_b = rng.uniform(0.4, 2.5, (p, 3)).astype(np.float32)
    qa, qb = _rand_quats(rng, p), _rand_quats(rng, p)
    pa = rng.uniform(-1, 1, (p, 3)).astype(np.float32)
    dirs = rng.normal(size=(p, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    gap = rng.uniform(-0.3, 0.1, (p, 1)).astype(np.float32)
    rad = (np.linalg.norm(size_a, axis=-1, keepdims=True)
           + np.linalg.norm(size_b, axis=-1, keepdims=True)) * 0.35
    pb = (pa + dirs * (rad + gap)).astype(np.float32)
    # Axis-aligned resting pairs: the exact-tie cases of a settled pile.
    k = p // 8
    qa[:k] = qb[:k] = np.array([0, 0, 0, 1], np.float32)
    pb[:k] = pa[:k] + np.array([0.0, 1.0, 0.0], np.float32) * (
        (size_a[:k, 1:2] + size_b[:k, 1:2]) * 0.5 - 0.004)
    return pa, qa, size_a * 0.5, pb, qb, size_b * 0.5


def test_collide_pairs_cm_matches_reference_on_pose_fuzz():
    """15-axis SAT + clipped manifold: counts, masks and feature ids
    identical; points and normals within 1e-5 (one float32 ulp at the
    coordinates' magnitude, for XLA vs ATen rounding of the same ops)."""
    pa, qa, ha, pb, qb, hb = _random_pairs(0)
    margin = 0.02

    def cmp(x):
        return tuple(x[:, k] for k in range(x.shape[1]))

    ref = jax.jit(lambda *a: j_collide(
        {"pos": a[0], "quat": a[1], "half": a[2]},
        {"pos": a[3], "quat": a[4], "half": a[5]}, margin))(
        *[cmp(jnp.asarray(x)) for x in (pa, qa, ha, pb, qb, hb)])
    ours = t_collide({"pos": cmp(T(pa)), "quat": cmp(T(qa)), "half": cmp(T(ha))},
                     {"pos": cmp(T(pb)), "quat": cmp(T(qb)), "half": cmp(T(hb))}, margin)
    np.testing.assert_array_equal(ours["count"].numpy(), np.asarray(ref["count"]))
    assert int(np.asarray(ref["count"]).sum()) > 2048    # many real manifolds
    for s in range(4):
        np.testing.assert_array_equal(ours["slot_ok"][s].numpy(), np.asarray(ref["slot_ok"][s]))
        np.testing.assert_array_equal(ours["feature"][s].numpy(), np.asarray(ref["feature"][s]))
        for key in ("x_a", "x_b"):
            for k in range(3):
                np.testing.assert_allclose(ours[key][s][k].numpy(), np.asarray(ref[key][s][k]),
                                           atol=1e-5, rtol=1e-5)
    for k in range(3):
        np.testing.assert_allclose(ours["normal"][k].numpy(), np.asarray(ref["normal"][k]),
                                   atol=1e-5)


def _pile_state(seed, n_cols=5, n_layers=4):
    """A settled-pile-like 100-cube state from a seed: columns of cubes in
    light contact (overlap ~1e-3) with small tilts and velocities, on the
    ground slab, inside the Stress1000 capacity plan (N = 128)."""
    arrays, params, cap, n_real = tscenes._scene_stress_n(n_cols, n_layers, n_cols)
    rng = np.random.default_rng(seed)
    b = arrays["bodies"]
    n = n_real - 1
    ix, iy, iz = np.meshgrid(np.arange(n_cols), np.arange(n_layers), np.arange(n_cols),
                             indexing="ij")
    pos = np.stack([(ix.ravel() - 2) * 1.005, 0.5 + iy.ravel() * 0.999,
                    (iz.ravel() - 2) * 1.03], -1)[:n]
    pos = pos + rng.normal(scale=2e-3, size=pos.shape)
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    ang = rng.uniform(0, 0.03, (n, 1))
    quat = np.concatenate([ax * np.sin(ang / 2), np.cos(ang / 2)], -1)
    lv = rng.normal(scale=0.1, size=(n, 3))
    av = rng.normal(scale=0.1, size=(n, 3))
    for leaf, val in (("pos", pos), ("quat", quat), ("linvel", lv), ("angvel", av)):
        b[leaf][:, 0, 1:1 + n] = val.T.astype(np.float32)
    return arrays, params, cap


@pytest.mark.parametrize("state", ["stress1000_initial", "pile"])
def test_broadphase_matches_reference(state):
    """candidate_lists / symmetric_filter / control_lanes: slots, keys,
    thresholds and counts identical; slack and the control lanes within
    rtol 1e-5 (the mean displacement is a library-ordered sum)."""
    if state == "pile":
        arrays, params, cap = _pile_state(3)
    else:
        arrays, params, cap, _ = tscenes.scene_stress1000()
    b = arrays["bodies"]
    jd = jnp.asarray(b["inv_mass"]) > 0
    td = T(b["inv_mass"]) > 0
    jh = tuple(jnp.asarray(b["size"][k]) * 0.5 for k in range(3))
    th = tuple(T(b["size"][k]) * 0.5 for k in range(3))
    excl = arrays["exclusions"]
    ref = jbp.candidate_lists(jnp.asarray(b["pos"]), jnp.asarray(b["quat"]), jh,
                              jnp.asarray(b["radius"]), jd, jnp.asarray(excl),
                              cap.max_degree, params.bp_margin)
    ours = tbp.candidate_lists(T(b["pos"]), T(b["quat"]), th, T(b["radius"]), td, T(excl),
                               cap.max_degree, params.bp_margin)
    for name, x, y in zip(("nb", "key", "thr", "cand"), ours[:4], ref[:4]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
    np.testing.assert_allclose(float(ours[4]), float(ref[4]), rtol=1e-6)
    if state == "pile":
        assert int(ref[3]) > 300    # a dense candidate set

    jf = jbp.symmetric_filter(ref[0], ref[1], ref[2], jd, jrep.xla_gather)
    tf = tbp.symmetric_filter(ours[0], ours[1], ours[2], td)
    np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf[0]))
    assert int(tf[1]) == int(jf[1])

    # Control lanes, at the anchor poses and after a seeded displacement.
    rng = np.random.default_rng(5)
    moved = b["pos"] + rng.normal(scale=0.01, size=b["pos"].shape).astype(np.float32)
    for pos in (b["pos"], moved):
        lv = tuple(b["linvel"][k] for k in range(3))
        av = tuple(b["angvel"][k] for k in range(3))
        jl = jbp.control_lanes(ref[0], tuple(jnp.asarray(pos)), tuple(jnp.asarray(b["quat"])),
                               jh, jnp.asarray(b["radius"]), tuple(map(jnp.asarray, lv)),
                               tuple(map(jnp.asarray, av)), jd, jnp.asarray(b["pos"]),
                               jnp.asarray(b["quat"]), params, jrep.xla_gather)
        tl = tbp.control_lanes(ours[0], tuple(T(pos)), tuple(T(b["quat"])), th, T(b["radius"]),
                               tuple(map(T, lv)), tuple(map(T, av)), td, T(b["pos"]),
                               T(b["quat"]), params)
        np.testing.assert_allclose(tl.numpy(), np.array([float(x) for x in jl]),
                                   rtol=1e-5, atol=1e-7)

