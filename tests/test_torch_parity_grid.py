"""The port's grid tier against the JAX reference's grid twins, on the CPU.

The reference runs its grid tier off-TPU through the kernel bodies' math
twins (``_collide_grid_math``, ``_iterblock_grid_call_math``, both taking
the block size ``gb`` as an argument) with the same block decomposition,
including the bounded cross-block pose lag.  Here ``gb = 1`` on N = 256
(two logical blocks of 128 bodies) puts cross-block contacts at a CPU-cheap
size.  The twins run eagerly (``jax.disable_jit``): op by op, as the port
runs, and without a long XLA compile.  Inputs: a touching pile of cubes,
jittered from a numpy seed, or states of a reference trajectory.

Tolerances.  Integer outputs (slots, keys, thresholds, feature ids, counts,
masks, and the stick latches of one K6 launch) must be identical.  One
collide pass: floats within rtol 1e-5 (the same operations rounded by two
libraries).  Poses after iterations: max(1e-4 m, 4x the reference's own
change when its dynamic bodies' positions are nudged by one float32 ulp,
measured in the test), the rule of test_torch_parity_step.py; a whole
step's carried lambda and penalty, 4x the reference's own change under the
same nudge (at least 1e-4).  The K6 launch
is 2 iterations (``grid_specs`` at residency 2): a latch whose tangential
lambda sits on the friction cone is decided by the rounding of
``tan_sq <= limit**2 + 1e-8``, and over 4 iterations the reference itself
flips ~300 of them under a one-ulp nudge; over 2 the port's latches and
poses equal the reference's exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avbd3d_tpu import solver as jsolver
from avbd3d_tpu import solver_tpu as jsolver_tpu
from avbd3d_tpu.config import SolverParams as JParams
from avbd3d_tpu.models import scenes as jscenes
from avbd3d_tpu.ops import broadphase as jbp

from avbd3d_tpu_torch import config as tconfig
from avbd3d_tpu_torch import solver as tsolver
from avbd3d_tpu_torch import solver_cuda, solver_grid
from avbd3d_tpu_torch.convert import world_from_arrays, world_to_arrays
from avbd3d_tpu_torch.ops import broadphase as tbp
from avbd3d_tpu_torch.state import Bodies, Contacts

torch.set_num_threads(1)

STRESS = dict(iterations=20, beta=30000.0, gamma=0.995, lhs_fresh_rebuild_every=4)


def jtree(world):
    return jax.device_get(dataclasses.asdict(world))


def tparams_of(params):
    return tconfig.SolverParams(**dataclasses.asdict(params))


def pile(nx, ny, nz, min_bodies, max_degree, cache_degree, seed, spacing_y=0.995,
         vy=-0.5, vxz=0.1, tilt=0.03):
    """Ground + an nx*ny*nz pile of unit cubes whose layers touch
    (``spacing_y`` < 1), jittered in position, tilt and velocity from a
    numpy seed, body indices y-major (a logical block of 128 bodies holds
    about 128 / (nx*nz) layers, so layer contacts cross blocks).  Returns
    the reference World with fresh candidate lists, and its params/cap."""
    rng = np.random.default_rng(seed)
    sb = jscenes.SceneBuilder()
    sb.add_body((100, 1, 100), 0.0, 0.5, (0, -0.5, 0))
    for y in range(ny):
        for z in range(nz):
            for x in range(nx):
                jit = rng.uniform(-0.02, 0.02, 3)
                axis = rng.normal(size=3)
                axis /= np.linalg.norm(axis)
                ang = rng.uniform(0.0, tilt)
                q = (*(axis * np.sin(ang / 2)), np.cos(ang / 2))
                v = (rng.uniform(-vxz, vxz), vy + rng.uniform(-0.1, 0.1),
                     rng.uniform(-vxz, vxz))
                sb.add_body((1, 1, 1), 1.0, 0.5,
                            ((x - (nx - 1) / 2) * 1.01 + jit[0],
                             0.499 + y * spacing_y + jit[1],
                             (z - (nz - 1) / 2) * 1.01 + jit[2]), q, v)
    world, params, cap, _ = sb.build(JParams(**STRESS), max_degree=max_degree,
                                     min_bodies=min_bodies, cache_degree=cache_degree)
    b = world.bodies
    bp = jbp.build_bp_cache(b, world.exclusions, cap.max_degree, params.bp_margin)
    return world.replace(bp=bp), params, cap


def nudged_pos(pos, inv_mass):
    """Every dynamic body's position moved up by one float32 ulp."""
    p = np.asarray(pos)
    dyn = np.asarray(inv_mass)[None] > 0
    return jnp.asarray(np.where(dyn, np.nextafter(p, np.float32(np.inf)), p).astype(np.float32))


@pytest.fixture(scope="module")
def small():
    """N = 256 (G = 2), gb = 1: the reference's K5 on the fresh pile, then
    on the pile moved a little with the first result as the old cache (the
    warmstart match)."""
    jw, params, cap = pile(8, 3, 8, 256, max_degree=16, cache_degree=10, seed=3,
                           spacing_y=0.998, vy=-0.1, vxz=0.0, tilt=0.01)
    assert jw.bodies.g == 2
    b, bp = jw.bodies, jw.bp
    moved = b.replace(pos=b.pos + jnp.asarray(
        np.random.default_rng(4).uniform(-2e-3, 2e-3, b.pos.shape).astype(np.float32))
        * (b.inv_mass > 0)[None])
    with jax.disable_jit():
        c1 = jsolver_tpu._collide_grid_math(jw.contacts, bp.nb, bp.key, bp.thr, b, params, 1)
        c2 = jsolver_tpu._collide_grid_math(c1[0], bp.nb, bp.key, bp.thr, moved, params, 1)
    return jw, moved, params, c1, c2


def _check_collide(tout, jout, label):
    tc, tkept, tonce, tdrop = tout
    jc, jkept, jonce, jdrop = jout
    ja = jax.device_get(dataclasses.asdict(jc))
    for name in solver_cuda.CACHE_FIELDS:
        x, y = getattr(tc, name).numpy(), np.asarray(ja[name])
        if y.dtype.kind in "ib":
            np.testing.assert_array_equal(x, y, err_msg=f"{label}: {name}")
        else:
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5, err_msg=f"{label}: {name}")
    np.testing.assert_array_equal(tkept.numpy(), np.asarray(jkept), err_msg=f"{label}: kept")
    np.testing.assert_array_equal(tonce.numpy(), np.asarray(jonce), err_msg=f"{label}: once")
    assert int(tdrop) == int(jdrop), label


def to_port(cls, jobj):
    """A reference state container (Bodies, Contacts) as the port's."""
    return cls(**{k: torch.from_numpy(np.array(v))
                  for k, v in jax.device_get(dataclasses.asdict(jobj)).items()})


def test_collide_grid_matches_reference(small):
    """K5's plain version vs _collide_grid_math (gb = 1, two blocks):
    a fresh pile, then the warmstart match against the first cache."""
    jw, moved, params, c1, c2 = small
    tparams = tparams_of(params)
    tw = world_from_arrays(jtree(jw), "cpu")
    bp = tw.bp
    t1 = solver_grid.collide_grid(tw.contacts, bp.nb, bp.key, bp.thr, tw.bodies, tparams)
    _check_collide(t1, c1, "fresh")
    t2 = solver_grid.collide_grid(to_port(Contacts, c1[0]), bp.nb, bp.key, bp.thr,
                                  to_port(Bodies, moved), tparams)
    _check_collide(t2, c2, "warmstart")
    count, other = t2[0].count.numpy(), t2[0].other.numpy()
    own = np.arange(256).reshape(1, 2, 128)
    cross = (other >= 0) & (other // 128 != own // 128) & (other > 0)
    assert int(count.sum()) > 1000 and int(cross.sum()) > 100, (count.sum(), cross.sum())


@pytest.fixture(scope="module")
def launch(small):
    """One K6 launch (the first spec of the Stress cadence at residency 2)
    on the warmstarted cache, by the reference with gb = 1, and again with
    every dynamic launch-start position nudged one ulp (the tolerance)."""
    jw, moved, params, c1, c2 = small
    jc = c2[0]
    b = moved
    g = b.g

    def cg(a):
        return jnp.moveaxis(a, 0, 1).reshape(a.shape[1], g, 128)

    spec = jsolver_tpu._grid_specs(params, params.iterations, params.lhs_rebuild_every, 2)[0]
    with jax.disable_jit():
        _lv, _av, ip, iq, ps, qs, _s = jsolver.predict(b, params)
        args = (jc, b, cg(ps), cg(qs), jc.lam, jc.penalty, jc.stick.astype(jnp.float32),
                cg(ip), cg(iq))
        ref = jsolver_tpu._iterblock_grid_call_math(params, 1, spec, *args)
        ref_nudged = jsolver_tpu._iterblock_grid_call_math(
            params, 1, spec, args[0], args[1], nudged_pos(args[2], b.inv_mass), *args[3:])
    return params, spec, args, ref, ref_nudged


def test_grid_specs_match_reference():
    for post in (False, True):
        for n_iters, k, r in ((20, 4, 4), (20, 1, 4), (10, 4, 3), (7, 2, 4), (20, 4, 1)):
            p = JParams(post_stabilize=post)
            assert solver_grid.grid_specs(tparams_of(p), n_iters, k, r) == \
                jsolver_tpu._grid_specs(p, n_iters, k, r), (post, n_iters, k, r)
    for g, gb in ((8, 8), (16, 16), (24, 8), (40, 8), (48, 16)):
        assert solver_grid.pick_gb(g) == jsolver_tpu._pick_gb(g) == gb
    with pytest.raises(ValueError):
        solver_grid.pick_gb(12)


def test_iterblock_grid_matches_reference(launch):
    """K6's plain version vs _iterblock_grid_call_math for one 2-iteration
    launch at gb = 1: stick latches identical; poses within max(1e-4 m, 4x
    the reference's one-ulp sensitivity)."""
    params, spec, args, ref, ref_nudged = launch
    tparams = tparams_of(params)
    t = [torch.from_numpy(np.array(jax.device_get(a))) for a in args[2:]]
    tc = to_port(Contacts, args[0])
    tb = to_port(Bodies, args[1])
    out = solver_grid.iterblock_grid(tparams, 1, spec, tc, tb, *t)
    sens = max(float(jnp.max(jnp.abs(ref[0] - ref_nudged[0]))),
               float(jnp.max(jnp.abs(ref[1] - ref_nudged[1]))))
    tol = max(1e-4, 4.0 * sens)
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]), err_msg="stick")
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=tol, rtol=0,
                               err_msg="pos")
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=tol, rtol=0,
                               err_msg="quat")
    np.testing.assert_allclose(out[5].numpy(), np.asarray(ref[5]), atol=2 * tol, rtol=0,
                               err_msg="sep")
    # The launch moved the pile, and the cross-block lag is in play: the
    # same launch as one logical block (gb = 2) gives other poses.
    assert float(np.abs(out[0].numpy() - t[0].numpy()).max()) > 1e-4
    one_block = solver_grid.iterblock_grid(tparams, 2, spec, tc, tb, *t)
    assert float((one_block[0] - out[0]).abs().max()) > tol


# ---------------------------------------------------------------------------
# The whole grid step
# ---------------------------------------------------------------------------

def _reference_gates(jw, params, cap):
    """The reference grid step's decisions: the refresh predicate
    (refresh_or_reuse) and the unrefined speed gates (stale_lhs_ok)."""
    b = jw.bodies
    new_bp = jbp.refresh_or_reuse(jw.bp, b, jw.exclusions, cap.max_degree, params.bp_margin)
    refreshed = not np.array_equal(np.asarray(new_bp.anchor), np.asarray(jw.bp.anchor))
    calm_p = params.replace(lhs_stale_speed_max=min(params.impact_speed_min,
                                                    params.lhs_stale_speed_max))
    return {"refreshed": refreshed,
            "stale_ok": bool(jsolver.stale_lhs_ok(b, jw.bp, params, refine=False)),
            "calm": bool(jsolver.stale_lhs_ok(b, jw.bp, calm_p, refine=False))}


def _grid_trajectory(g, keep):
    jw, params, cap = pile(6, 3, 6, g * 128, max_degree=16, cache_degree=8, seed=7,
                           spacing_y=0.998, vy=-0.1, vxz=0.0, tilt=0.01)
    cap = cap.replace(backend="grid")
    assert jw.bodies.g == g
    states, w = {}, jw
    for i in range(max(keep) + 1):
        if i in keep:
            states[i] = w
        w = jsolver.step(w, params, cap)
    return params, cap, states


GRID_STATES = (0, 3, 6)


@pytest.fixture(scope="module")
def grid_one_block():
    return _grid_trajectory(8, GRID_STATES)


def _check_step(params, cap, jw):
    tparams = tparams_of(params)
    tcap = tconfig.Capacity(**dataclasses.asdict(cap))
    tw = world_from_arrays(jtree(jw), "cpu")
    want = _reference_gates(jw, params, cap)
    j1 = jsolver.step(jw, params, cap)
    t1 = tsolver.step(tw, tparams, tcap)
    assert tsolver.step.last_path == "grid"
    assert tsolver.step.last_gates == want
    a, b = jtree(j1), world_to_arrays(t1)
    for group, names in (("contacts", ("other", "count", "feature")),
                         ("bp", ("nb", "key", "thr", "cand", "dropped"))):
        for name in names:
            np.testing.assert_array_equal(b[group][name], a[group][name],
                                          err_msg=f"{group}.{name}")
    nudged = jw.bodies.replace(pos=nudged_pos(jw.bodies.pos, jw.bodies.inv_mass))
    j2 = jsolver.step(jw.replace(bodies=nudged), params, cap)
    tol = max(1e-4, 4.0 * float(jnp.max(jnp.abs(j1.bodies.pos - j2.bodies.pos))))
    for name in ("pos", "quat", "prev_linvel", "prev_angvel"):
        np.testing.assert_allclose(b["bodies"][name], a["bodies"][name], atol=tol, rtol=0,
                                   err_msg=name)
    for name in ("linvel", "angvel"):   # pose differences over dt
        np.testing.assert_allclose(b["bodies"][name], a["bodies"][name], atol=150 * tol,
                                   rtol=0, err_msg=name)
    # The carried duals, within 4x the reference's own change under the nudge.
    nudged_c = jtree(j2)["contacts"]
    for name in ("lam", "penalty"):
        sens = float(np.abs(np.asarray(nudged_c[name]) - a["contacts"][name]).max())
        np.testing.assert_allclose(b["contacts"][name], a["contacts"][name],
                                   atol=max(1e-4, 4.0 * sens), rtol=0, err_msg=name)
    jv, tv = a["diagnostics"]["vec"], b["diagnostics"]["vec"]
    np.testing.assert_array_equal(tv[[5, 6, 7, 8, 9, 10]], jv[[5, 6, 7, 8, 9, 10]])
    np.testing.assert_array_equal(tv[11:], jv[11:])        # CONTROL_RESET
    np.testing.assert_allclose(tv[[0, 1]], jv[[0, 1]], atol=2 * tol, rtol=0)
    return tv


@pytest.mark.parametrize("k", GRID_STATES)
def test_grid_step_matches_reference(grid_one_block, k):
    """solver.step with backend="grid" at G = 8 (one logical block) vs the
    reference's step(backend="grid") from the same state."""
    params, cap, states = grid_one_block
    tv = _check_step(params, cap, states[k])
    if k == GRID_STATES[-1]:
        assert tv[6] > 50, tv      # a pile in contact


@pytest.mark.slow
def test_grid_step_multiblock_matches_reference():
    """The same at G = 24: three logical blocks of 1024 bodies (gb = 8)."""
    params, cap, states = _grid_trajectory(24, (0, 4))
    for k in (0, 4):
        _check_step(params, cap, states[k])


def test_refresh_and_stale_gates_match_reference(grid_one_block):
    """refresh_needed / refresh_or_reuse and stale_lhs_ok take the
    reference's decisions, including thresholds placed on the float32
    boundary of the state's top speed."""
    params, cap, states = grid_one_block
    first = states[GRID_STATES[0]]
    stale_bp = jbp.empty_bp_cache(first.bodies.g, cap.max_degree)   # anchors far away
    seen = set()
    for jw in list(states.values()) + [first.replace(bp=stale_bp)]:
        tw = world_from_arrays(jtree(jw), "cpu")
        want = _reference_gates(jw, params, cap)
        need = bool(tbp.refresh_needed(tw.bp, tw.bodies, params.bp_margin))
        assert need == want["refreshed"]
        seen.add(need)
        bp, refreshed = tbp.refresh_or_reuse(tw.bp, need, tw.bodies, tw.exclusions,
                                             cap.max_degree, params.bp_margin)
        assert refreshed == need and (bp is not tw.bp) == need
        lv = jw.bodies.linvel
        v2 = float(jnp.max(jnp.where(jw.bodies.dynamic, lv[0] ** 2 + lv[1] ** 2 + lv[2] ** 2, 0)))
        top = float(np.sqrt(v2))
        for th in (0.1, 1.0, top, np.nextafter(top, 0.0), np.nextafter(top, 10.0)):
            p = params.replace(lhs_stale_speed_max=float(th))
            j = bool(jsolver.stale_lhs_ok(jw.bodies, jw.bp, p, refine=False))
            t = bool(tsolver.stale_lhs_ok(tw.bodies, tw.bp, tparams_of(p), refine=False))
            assert t == j, (th, v2)
            seen.add(("stale", j))
    assert {True, False, ("stale", True), ("stale", False)} <= seen, seen


def test_blocked_candidate_lists_match_reference():
    """Row-blocked candidate_lists (G = 24, N = 3072 > BLOCK_ROWS: blocks of
    1536 rows) vs the reference's, on test_grid_backend.py's construction.
    Identity is what holds (asserted); the reference's own looser criterion
    (keys equal up to +-N on < 1% of slots) is not needed."""
    rng = np.random.default_rng(11)
    g, d, n_real, margin = 24, 4, 500, 0.04
    n = g * 128
    pos = np.zeros((n, 3), np.float32)
    pos[:n_real] = rng.uniform(-6, 6, (n_real, 3)).astype(np.float32)
    pos[n_real:, 1] = -1e6
    radius = np.full(n, -1e9, np.float32)
    radius[:n_real] = rng.uniform(0.5, 1.2, n_real).astype(np.float32)
    half = np.zeros((n, 3), np.float32)
    half[:n_real] = rng.uniform(0.3, 0.9, (n_real, 3)).astype(np.float32)
    quat = np.zeros((n, 4), np.float32)
    quat[:, 3] = 1.0
    dynamic = np.zeros(n, bool)
    dynamic[:n_real] = rng.random(n_real) < 0.8
    arrays = (pos.T.reshape(3, g, 128), quat.T.reshape(4, g, 128),
              tuple(half[:, k].reshape(g, 128) for k in range(3)), radius.reshape(g, 128),
              dynamic.reshape(g, 128), np.zeros((0, g, 128), np.int32))
    ref = jax.jit(jbp.candidate_lists, static_argnames=("degree",))(
        *[jnp.asarray(a) if not isinstance(a, tuple) else tuple(map(jnp.asarray, a))
          for a in arrays], d, margin)
    out = tbp.candidate_lists(*[torch.from_numpy(a) if not isinstance(a, tuple)
                                else tuple(map(torch.from_numpy, a)) for a in arrays],
                              d, margin)
    for name, x, y in zip(("nb", "key", "thr", "cand", "slack"), out, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
    assert int(out[3]) > 500
