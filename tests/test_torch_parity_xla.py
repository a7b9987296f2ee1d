"""The port's portable step (``backend="xla"``) against the JAX reference's
``_step_impl``, on the CPU.

States come from reference trajectories of the portable path (jitted
``_step_impl``) on TwoBlockDrop and the 100-cube stress scene at N = 128 (the
Stress1000 construction and tuning, as test_torch_parity_step.py).  At each,
the port's ``_step_impl`` and the reference's run one step from the same
arrays.  The compared reference step runs op by op (``jax.disable_jit``),
which is how the port evaluates: compiled XLA:CPU contracts and reassociates
float operations, and at stress state 200 that alone moves one pair's SAT
feature ids (measured: the reference's own narrowphase gives the port's ids
op by op and the other ids compiled).

Tolerances, the per-state rule of test_torch_parity_step.py: integer outputs
(slots, keys, thresholds, feature ids, counts) identical; poses within
max(1e-4 m, 4x the reference's own one-ulp sensitivity at that state,
measured here), velocities 150x that (pose differences over dt).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avbd3d_tpu import solver as jsolver
from avbd3d_tpu.models import scenes as jscenes
from avbd3d_tpu.ops import broadphase as jbroadphase
from avbd3d_tpu.ops import replicated as jrep

from avbd3d_tpu_torch import config as tconfig
from avbd3d_tpu_torch import solver as tsolver
from avbd3d_tpu_torch import solver_cuda
from avbd3d_tpu_torch.comm import LocalComm
from avbd3d_tpu_torch.convert import world_from_arrays, world_to_arrays
from avbd3d_tpu_torch.ops import broadphase as tbroadphase
from avbd3d_tpu_torch.ops import replicated as trep
from avbd3d_tpu_torch.models import scenes as tscenes

torch.set_num_threads(1)

STRESS_STATES = (0, 60, 125, 135, 150, 200)
TWO_BLOCK_STATES = (0, 30, 33, 60)


def jtree(world):
    return jax.device_get(dataclasses.asdict(world))


def port_config(params, cap):
    return (tconfig.SolverParams(**dataclasses.asdict(params)),
            tconfig.Capacity(**dataclasses.asdict(cap)))


def portable(params, cap):
    """The reference's portable step, jitted."""
    return jax.jit(lambda w: jsolver._step_impl(w, params, cap, jrep.xla_gather))


def trajectory(world, params, cap, keep):
    f = portable(params, cap)
    states, w = {}, world
    for i in range(max(keep) + 1):
        if i in keep:
            states[i] = w
        w = f(w)
    return f, states


@pytest.fixture(scope="module")
def stress():
    world, params, cap, _ = jscenes._scene_stress_n(5, 4, 5)
    cap = cap.replace(backend="xla")
    f, states = trajectory(world, params, cap, STRESS_STATES)
    return params, cap, f, states


@pytest.fixture(scope="module")
def two_block():
    sc = jscenes.load_scene("TwoBlockDrop")
    cap = sc.cap.replace(backend="xla")
    f, states = trajectory(sc.world, sc.params, cap, TWO_BLOCK_STATES)
    return sc.params, cap, f, states


def nudged(w):
    """``w`` with every dynamic body's position moved by one float32 ulp."""
    pos = np.asarray(w.bodies.pos)
    dyn = np.asarray(w.bodies.inv_mass)[None] > 0
    up = np.where(dyn, np.nextafter(pos, np.float32(np.inf)), pos).astype(np.float32)
    return w.replace(bodies=w.bodies.replace(pos=jnp.asarray(up)))


def eager(params, cap):
    """The reference's portable step, op by op."""
    def f(w):
        with jax.disable_jit():
            return jsolver._step_impl(w, params, cap, jrep.xla_gather)
    return f


def compare_portable_step(jw, params, cap, f=None, joints=False):
    """One ``_step_impl`` of both from ``jw``, held to the per-state rule;
    the port makes one host read.  ``f``: the reference step the one-ulp
    sensitivity is measured with (None: the op-by-op step).  Returns (pose
    error, tolerance)."""
    tparams, tcap = port_config(params, cap)
    j1 = eager(params, cap)(jw)
    reads = tsolver.step.host_reads
    t1 = tsolver._step_impl(world_from_arrays(jtree(jw), "cpu"), tparams, tcap)
    assert tsolver.step.host_reads == reads + 1
    a, b = jtree(j1), world_to_arrays(t1)
    groups = [("contacts", ("other", "count", "feature")),
              ("bp", ("nb", "key", "thr", "cand", "dropped"))]
    if joints:
        groups += [("joints", ("other", "side", "world", "color")),
                   ("springs", ("other", "side", "world"))]
    for group, names in groups:
        for name in names:
            np.testing.assert_array_equal(b[group][name], a[group][name],
                                          err_msg=f"{group}.{name}")
    assert int(b["step_index"]) == int(a["step_index"])

    j0, j2 = (j1, eager(params, cap)(nudged(jw))) if f is None else (f(jw), f(nudged(jw)))
    sens = max(float(jnp.max(jnp.abs(getattr(j0.bodies, k) - getattr(j2.bodies, k))))
               for k in ("pos", "quat"))
    tol = max(1e-4, 4.0 * sens)
    jb, tb = a["bodies"], b["bodies"]
    for name in ("pos", "quat", "prev_linvel", "prev_angvel"):
        np.testing.assert_allclose(tb[name], jb[name], atol=tol, rtol=0, err_msg=name)
    for name in ("linvel", "angvel"):
        np.testing.assert_allclose(tb[name], jb[name], atol=150 * tol, rtol=0, err_msg=name)
    jv, tv = a["diagnostics"]["vec"], b["diagnostics"]["vec"]
    np.testing.assert_array_equal(tv[[5, 6, 7, 8, 9, 10]], jv[[5, 6, 7, 8, 9, 10]])
    np.testing.assert_allclose(tv[[0, 1, 13, 14, 15]], jv[[0, 1, 13, 14, 15]], atol=2 * tol,
                               rtol=0)
    np.testing.assert_allclose(tv[[2, 3]], jv[[2, 3]], atol=300 * tol, rtol=1e-4)
    np.testing.assert_allclose(tv[[11, 12]], jv[[11, 12]], atol=300 * tol, rtol=2e-3)
    if joints and a["joints"]["lam"].size:
        # Duals scale with the penalty: the lambda error is the force error
        # penalty * C, so it is held relative to the joint force.
        jl, tl = a["joints"]["lam"], b["joints"]["lam"]
        scale = max(1.0, float(np.max(np.abs(jl))))
        np.testing.assert_allclose(tl, jl, atol=tol * scale, rtol=0, err_msg="j_lam")
        np.testing.assert_allclose(b["joints"]["penalty"], a["joints"]["penalty"],
                                   rtol=max(1e-4, tol), atol=0, err_msg="j_pen")
    if joints and a["springs"]["penalty"].size:
        np.testing.assert_array_equal(b["springs"]["penalty"], a["springs"]["penalty"])
    return float(np.max(np.abs(tb["pos"] - jb["pos"]))), tol


CASES = [("stress", k) for k in STRESS_STATES] + [("two_block", k) for k in TWO_BLOCK_STATES]


@pytest.mark.parametrize("scene,k", CASES, ids=[f"{s}-{k}" for s, k in CASES])
def test_one_portable_step_matches_reference(request, scene, k):
    params, cap, f, states = request.getfixturevalue(scene)
    compare_portable_step(states[k], params, cap, f)


def test_states_cover_the_portable_gates(stress, two_block):
    """The one-step cases above see a refresh step and every sweep plan
    (calm, fresh, boost)."""
    seen = set()
    for params, cap, _f, states in (stress, two_block):
        tparams, _ = port_config(params, cap)
        for w in states.values():
            dv = np.concatenate([np.asarray(w.diagnostics.vec),
                                 [float(w.bp.slack), float(w.bp.dropped)]])
            refreshed = tbroadphase.refresh_due(dv, params.bp_margin)
            seen.add("refreshed" if refreshed else "reused")
            stale_ok, calm = tsolver.control_gates(dv, refreshed, tparams)
            seen.add(solver_cuda.select_variant(tparams, stale_ok, calm))
    assert {"refreshed", "reused", (10, 4), (20, 4), (20, 1)} <= seen, seen


@pytest.mark.parametrize("name", ["TwoBlockDrop", "Stack"])
def test_lockstep_portable_path(name):
    """40 steps of ``step`` with ``backend="xla"`` side by side with the
    reference's (ballistic path and refreshes included): the same gates on
    every step, positions within 2e-3 m (the bound of tests/
    test_pallas_backend.py for two implementations of the same solver
    through contact onset), one host read per step."""
    sc = jscenes.load_scene(name)
    cap = sc.cap.replace(backend="xla")
    tparams, tcap = port_config(sc.params, cap)
    jw = sc.world
    tw = world_from_arrays(jtree(jw), "cpu")
    drift, reads = [], tsolver.step.host_reads
    for _ in range(40):
        dv = np.concatenate([np.asarray(jw.diagnostics.vec),
                             [float(jw.bp.slack), float(jw.bp.dropped)]])
        jw = jsolver.step(jw, sc.params, cap)
        tw = tsolver.step(tw, tparams, tcap)
        assert tsolver.step.last_path == "xla"
        assert tsolver.step.last_gates["refreshed"] == tbroadphase.refresh_due(
            dv, sc.params.bp_margin)
        drift.append(float(np.max(np.abs(tw.bodies.pos.numpy() - np.asarray(jw.bodies.pos)))))
    assert tsolver.step.host_reads == reads + 40
    assert max(drift) < 2e-3, max(drift)
    d = tw.diagnostics.as_dict()
    assert d["sanitized"] == 0 and d["pair_overflow"] == 0 and d["degree_overflow"] == 0
    assert d["active_manifolds"] == float(jw.diagnostics.vec[6])


def test_portable_path_tracks_the_fused_path():
    """50 Stack steps on the port's two paths (the fused step's plain
    version and the portable step): the same solver in two
    formulations, held to the reference's backend bound of 2e-3 m."""
    sc = tscenes.load_scene("Stack", "cpu")
    wf, wx = sc.world, sc.world
    worst = 0.0
    for _ in range(50):
        wf = tsolver.step(wf, sc.params, sc.cap)
        assert tsolver.step.last_path == "fused"
        wx = tsolver.step(wx, sc.params, sc.cap.replace(backend="xla"))
        assert tsolver.step.last_path == "xla"
        worst = max(worst, float((wf.bodies.pos - wx.bodies.pos).abs().max()))
    assert worst < 2e-3, worst
    for w in (wf, wx):
        d = w.diagnostics.as_dict()
        assert d["sanitized"] == 0 and d["active_manifolds"] > 0


def test_neighbor_lists_match_reference(stress):
    """The one-call broadphase (candidates + symmetric filter) at a pile
    state: neighbours and overflow identical."""
    params, cap, _f, states = stress
    jw = states[200]
    b = jw.bodies
    half = tuple(b.size[k] * 0.5 for k in range(3))
    jnb, jover = jbroadphase.neighbor_lists(b.pos, b.quat, half, b.radius, b.dynamic,
                                            jw.exclusions, cap.max_degree)
    tb = world_from_arrays(jtree(jw), "cpu")
    t = tb.bodies
    tnb, tover = tbroadphase.neighbor_lists(t.pos, t.quat, tuple(t.size[k] * 0.5 for k in range(3)),
                                            t.radius, t.dynamic, tb.exclusions, cap.max_degree)
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))
    assert int(tover) == int(jover)
    assert int((tnb >= 0).sum()) > 100


def _same(a, b):
    if isinstance(a, dict):
        return all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    return a == b


def test_seam_defaults_are_the_identity(stress):
    """Every seam the portable path threads (``gather``, ``own_iota``,
    ``n_total``, ``comm``), passed explicitly as the identity, gives the
    bits the defaults give: the fused path's plain version, which calls
    these functions with the defaults, computes what it computed before the
    seams existed.  Then one fused plain step and one portable step, each
    twice, are bit-identical."""
    params, cap, _f, states = stress
    tparams, tcap = port_config(params, cap.replace(backend="auto"))
    w = world_from_arrays(jtree(states[150]), "cpu")
    b = w.bodies
    g, n = b.g, b.n
    comm = LocalComm()
    iota = trep.body_iota(g, "cpu")

    def other_gather(table, idx):
        return table.reshape(-1)[idx.reshape(-1).long()].reshape(idx.shape)

    half = tuple(b.size[k] * 0.5 for k in range(3))
    args = (b.pos, b.quat, half, b.radius, b.dynamic, w.exclusions, tcap.max_degree,
            tparams.bp_margin)
    assert _same(tbroadphase.candidate_lists(*args),
                 tbroadphase.candidate_lists(*args, comm=comm))
    bp = tbroadphase.build_bp_cache(b, w.exclusions, tcap.max_degree, tparams.bp_margin)
    assert _same(bp, tbroadphase.build_bp_cache(b, w.exclusions, tcap.max_degree,
                                                 tparams.bp_margin, comm))
    filt = tbroadphase.symmetric_filter(bp.nb, bp.key, bp.thr, b.dynamic)
    assert _same(filt, tbroadphase.symmetric_filter(bp.nb, bp.key, bp.thr, b.dynamic,
                                                    other_gather, iota, n))
    tables = solver_cuda.body_tables(b)
    nb = filt[0]
    assert _same(trep.collide_and_init(w.contacts, nb, tables, tparams),
                 trep.collide_and_init(w.contacts, nb, tables, tparams, other_gather, iota))
    consts = trep.pair_constants(w.contacts.other, tables)
    assert _same(consts, trep.pair_constants(w.contacts.other, tables, other_gather))
    pose = {"pos": tables["pos"], "quat": tables["quat"]}
    assert _same(trep.eval_geometry(w.contacts, pose, consts),
                 trep.eval_geometry(w.contacts, pose, consts, other_gather, iota))
    geom = trep.eval_geometry(w.contacts, pose, consts)
    rows = trep.eval_rows(geom, w.contacts, consts, w.contacts.lam, w.contacts.penalty,
                          w.contacts.stick, torch.tensor(tparams.alpha), tparams)
    f = trep.primal_force(rows, w.contacts.penalty)
    iiw = [b.inv_inertia[k] for k in range(3)] * 2
    assert _same(trep.body_system(geom, f, w.contacts.penalty, iiw),
                 {**trep.body_forces(geom, f),
                  **trep.body_matrix(geom, f, w.contacts.penalty, iiw)})
    dynf = b.dynamic.to(torch.float32)
    assert _same(trep.once_mask(w.contacts.other, dynf),
                 trep.once_mask(w.contacts.other, dynf, other_gather, iota))
    lanes = (bp.nb, tuple(b.pos[k] for k in range(3)), tuple(b.quat[k] for k in range(4)),
             half, b.radius, tuple(b.linvel[k] for k in range(3)),
             tuple(b.angvel[k] for k in range(3)), b.dynamic, bp.anchor, bp.anchor_quat,
             tparams)
    assert _same(tbroadphase.control_lanes(*lanes),
                 tbroadphase.control_lanes(*lanes, gather=other_gather, comm=comm))
    for backend in ("auto", "xla"):
        c = tcap.replace(backend=backend)
        assert _same(tsolver.step(w, tparams, c), tsolver.step(w, tparams, c))
