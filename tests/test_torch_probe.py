"""The broadphase probe (K7's plain version) and the refined stale-Hessian
gate of the PyTorch port against the JAX reference, on the CPU.

States come from trajectories of the port (the 8-cube swarm of
tests/test_fastpaths.py dropped from y = 30 and from y = 2, TwoBlockDrop,
Stack; the low swarm lands at step 34 and bounces) and from seeded random
poses at G = 2, D = 8; the same arrays go
through ``avbd3d_tpu.ops.broadphase.bp_probe`` (with ``xla_gather``, as the
reference's own tests run it off the TPU; once through ``bp_probe_tpu`` in
interpret mode) and through the port.

Tolerances.  ``n_slots`` and ``near`` must be identical.  ``min_sep`` is a
difference of projections of metre-sized boxes: the two libraries round the
same float32 operations (XLA may contract or reorder a sum, PyTorch's CPU
``sqrt`` is not correctly rounded), so it is held to 1e-5 absolute.  The
gates are booleans and must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avbd3d_tpu import solver as jsolver
from avbd3d_tpu import solver_tpu as jsolver_tpu
from avbd3d_tpu import state as jstate
from avbd3d_tpu.config import SolverParams as JParams
from avbd3d_tpu.ops import broadphase as jbp
from avbd3d_tpu.ops import replicated as jrep

from avbd3d_tpu_torch import SceneBuilder, kernels, load_scene, solver, solver_cuda
from avbd3d_tpu_torch.config import SolverParams
from avbd3d_tpu_torch.convert import world_from_arrays
from avbd3d_tpu_torch.models.scenes import SCENES
from avbd3d_tpu_torch.ops import broadphase as tbp

torch.set_num_threads(1)


def swarm(y0: float):
    """Ground + 8 separated cubes falling coherently from y = ``y0``
    (tests/test_fastpaths._swarm_scene drops them from 30)."""
    sb = SceneBuilder()
    sb.add_body((100, 1, 100), 0.0, 0.5, (0, -0.5, 0))
    for i in range(8):
        sb.add_body((1, 1, 1), 1.0, 0.5,
                    (3.0 * (i % 3) - 3.0, y0 + (i // 3) * 3.0, 2.0 * (i % 2)))
    arrays, params, cap, _ = sb.build(SolverParams(), max_degree=8)
    return world_from_arrays(arrays, "cpu"), params, cap


def trajectory(world, params, cap, keep):
    """{k: (pre-step world k, world k + 1)} for k in ``keep``, plus the
    per-step record (pre-step bodies, post-step world) of the whole run."""
    states, record, w = {}, [], world
    for i in range(max(keep) + 1):
        nxt = solver.step(w, params, cap)
        record.append((w.bodies, nxt))
        if i in keep:
            # Probe the slots the step used (its refreshed cache) at the
            # pre-step poses, as the reference's probe test does.
            states[i] = w.replace(bp=nxt.bp)
        w = nxt
    return states, record


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for label, y0, keep in (("swarm_low", 2.0, (0, 20, 34, 60)), ("swarm_high", 30.0, (10,))):
        w, p, cap = swarm(y0)
        states, record = trajectory(w, p, cap, keep)
        out[label] = (p, cap, states, record)
    for label, name, keep in (("two_block", "TwoBlockDrop", (0, 35, 80)),
                              ("stack", "Stack", (5, 40))):
        sc = load_scene(name, device="cpu")
        states, record = trajectory(sc.world, sc.params, sc.cap, keep)
        out[label] = (sc.params, sc.cap, states, record)
    return out


STATES = [("swarm_low", 0), ("swarm_low", 20), ("swarm_low", 34), ("swarm_low", 60),
          ("swarm_high", 10), ("two_block", 0), ("two_block", 35), ("two_block", 80),
          ("stack", 5), ("stack", 40)]
IDS = [f"{s}-{k}" for s, k in STATES]


def jax_bodies(b):
    return jstate.Bodies(**{f.name: jnp.asarray(getattr(b, f.name).numpy())
                            for f in dataclasses.fields(b)})


def jax_cache(bp):
    return jbp.BroadphaseCache(**{f.name: jnp.asarray(getattr(bp, f.name).numpy())
                                  for f in dataclasses.fields(bp)})


def jax_params(p):
    return JParams(**dataclasses.asdict(p))


def jax_probe(nb, b, p):
    g_len = float(sum(x * x for x in p.gravity) ** 0.5)
    return jbp.bp_probe(
        nb, tuple(b.pos[k] for k in range(3)), tuple(b.quat[k] for k in range(4)),
        tuple(b.size[k] * 0.5 for k in range(3)), b.radius,
        tuple(b.linvel[k] for k in range(3)), tuple(b.angvel[k] for k in range(3)),
        p.dt, p.collision_margin, g_len, jrep.xla_gather)


def assert_probe_equal(got, want):
    t_sep, t_n, t_near = got
    j_sep, j_n, j_near = want
    assert t_n.dtype == torch.int32 and t_near.dtype == torch.bool
    assert int(t_n) == int(j_n)
    np.testing.assert_array_equal(t_near.numpy(), np.asarray(j_near))
    assert abs(float(t_sep) - float(j_sep)) <= 1e-5, (float(t_sep), float(j_sep))


@pytest.mark.parametrize("scene,k", STATES, ids=IDS)
def test_bp_probe_matches_reference(worlds, scene, k):
    p, _cap, states, _ = worlds[scene]
    w = states[k]
    got = solver_cuda.bp_probe(w.bp.nb, w.bodies, p)          # CPU: the plain version
    want = jax_probe(jnp.asarray(w.bp.nb.numpy()), jax_bodies(w.bodies), p)
    assert_probe_equal(got, want)
    assert solver_cuda.bp_probe.launches == 0


def test_states_cover_near_and_far(worlds):
    """The states above see no candidate slot at all (free fall far from
    everything), no near body, some (the landing) and a slot in contact."""
    seen = set()
    for scene, k in STATES:
        p, _cap, states, _ = worlds[scene]
        w = states[k]
        sep, n, near = solver_cuda.bp_probe(w.bp.nb, w.bodies, p)
        seen.add("slots" if int(n) > 0 else "no slots")
        seen.add("near" if bool(near.any()) else "far")
        seen.add("touching" if float(sep) <= p.collision_margin else "apart")
    assert seen == {"slots", "no slots", "near", "far", "touching", "apart"}


def random_state(seed, g=2, d=8):
    rng = np.random.default_rng(seed)
    n = g * 128
    f32 = np.float32

    def cg(a):
        return np.ascontiguousarray(a.T.reshape(a.shape[1], g, 128)).astype(f32)

    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    size = rng.uniform(0.5, 1.5, size=(n, 3))
    nb = rng.integers(0, n, size=(d, g, 128)).astype(np.int32)
    nb[rng.random((d, g, 128)) < 0.3] = -1
    return {
        "nb": nb, "pos": cg(rng.uniform(-4.0, 4.0, size=(n, 3))), "quat": cg(quat),
        "half": cg(size * 0.5), "radius": (0.5 * np.linalg.norm(size, axis=1)).reshape(g, 128).astype(f32),
        "linvel": cg(rng.normal(scale=3.0, size=(n, 3))),
        "angvel": cg(rng.normal(scale=2.0, size=(n, 3))),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bp_probe_random_poses_match_reference(seed):
    s = random_state(seed)
    p = SolverParams()
    g_len = float(sum(x * x for x in p.gravity) ** 0.5)

    def args(conv):
        return (conv(s["nb"]), tuple(conv(s["pos"][k]) for k in range(3)),
                tuple(conv(s["quat"][k]) for k in range(4)),
                tuple(conv(s["half"][k]) for k in range(3)), conv(s["radius"]),
                tuple(conv(s["linvel"][k]) for k in range(3)),
                tuple(conv(s["angvel"][k]) for k in range(3)),
                p.dt, p.collision_margin, g_len)

    got = tbp.bp_probe(*args(torch.from_numpy))
    want = jbp.bp_probe(*args(jnp.asarray), jrep.xla_gather)
    assert_probe_equal(got, want)
    assert 0 < int(got[2].sum()) < 256 and float(got[0]) < 0.0


def test_bp_probe_matches_reference_kernel_in_interpret_mode(worlds):
    """The reference's Pallas probe kernel itself (interpret mode off the
    TPU) at G = 1, D = 8, on the landing swarm."""
    p, _cap, states, _ = worlds["swarm_low"]
    w = states[34]
    want = jsolver_tpu.bp_probe_tpu(jnp.asarray(w.bp.nb.numpy()), jax_bodies(w.bodies),
                                    jax_params(p))
    assert_probe_equal(solver_cuda.bp_probe(w.bp.nb, w.bodies, p), jax.device_get(want))


def test_bp_probe_without_slots():
    """A world with no valid slot: (1e9, 0, all False)."""
    sc = load_scene("Ground", device="cpu")
    w = solver.step(sc.world, sc.params, sc.cap)
    sep, n, near = solver_cuda.bp_probe(w.bp.nb, w.bodies, sc.params)
    assert float(sep) == 1.0e9 and int(n) == 0 and not bool(near.any())
    assert near.shape == (w.bodies.g, 128)


@pytest.mark.parametrize("scene,k", STATES, ids=IDS)
def test_stale_lhs_ok_matches_reference(worlds, scene, k):
    """Refined and unrefined gates on either side of the fastest body's
    speed: identical to the reference's, and refinement only ever opens
    the gate."""
    p, _cap, states, _ = worlds[scene]
    w = states[k]
    jb, jc = jax_bodies(w.bodies), jax_cache(w.bp)
    lv = w.bodies.linvel
    top = float(torch.sqrt(torch.where(w.bodies.dynamic, lv[0] ** 2 + lv[1] ** 2 + lv[2] ** 2,
                                       0.0).max()))
    for th in ((0.5 * top, 1.5 * top) if top > 0.0 else (0.1, 1.0)):
        pt = p.replace(lhs_stale_speed_max=th)
        pj = jax_params(pt)
        refined = solver.stale_lhs_ok(w.bodies, w.bp, pt)
        plain = solver.stale_lhs_ok(w.bodies, w.bp, pt, refine=False)
        assert refined.shape == () and refined.dtype == torch.bool
        assert bool(refined) == bool(jsolver.stale_lhs_ok(jb, jc, pj))
        assert bool(plain) == bool(jsolver.stale_lhs_ok(jb, jc, pj, refine=False))
        assert bool(refined) or not bool(plain)
        if top > 0.0:
            assert bool(plain) == (th > top)


def test_refinement_opens_the_gate_in_free_fall(worlds):
    """Free fall far above the ground: every body is fast, none is near a
    partner, so only the refined gate allows the stale cadence."""
    p, _cap, states, _ = worlds["swarm_high"]
    w = states[10]
    pt = p.replace(lhs_stale_speed_max=0.5)
    assert bool(solver.stale_lhs_ok(w.bodies, w.bp, pt))
    assert not bool(solver.stale_lhs_ok(w.bodies, w.bp, pt, refine=False))


def test_probe_proves_no_contacts(worlds):
    """The safe direction, on the port alone: along the swarm's 61 steps
    (a fall, a landing at step 34, a bounce, a second landing),
    ``min_sep > collision_margin`` with every candidate probed
    (``n_slots == bp.cand``) implies the step finds zero contacts; both
    outcomes occur."""
    p, _cap, _states, record = worlds["swarm_low"]
    proven, contacts_seen = 0, 0
    for bodies, nxt in record:
        sep, n, _near = solver_cuda.bp_probe(nxt.bp.nb, bodies, p)
        active = int(nxt.diagnostics.as_dict()["active_contacts"])
        contacts_seen += active > 0
        if float(sep) > p.collision_margin and int(n) == int(nxt.bp.cand):
            proven += 1
            assert active == 0
    assert proven >= 10 and contacts_seen >= 2


def test_probe_reach_constant_is_the_probes_own():
    """The probe adds 4 * dt * dt * |g| (the reference's bp_probe), the
    control lanes 4 * dt**2 * |g|; the kernel's parameter block holds the
    latter, so ``launch_bp_probe`` overrides it with the former.  For every
    shipped scene the two round to the same float32, so either is right."""
    for name in SCENES:
        arrays_params = SCENES[name]()[1]
        dt = arrays_params.dt
        g_len = float(sum(x * x for x in arrays_params.gravity) ** 0.5)
        block = dict(zip(kernels._PARAM_NAMES, kernels.param_block(arrays_params)))
        assert np.float32(block["reach_const"]) == np.float32(4.0 * dt * dt * g_len), name
