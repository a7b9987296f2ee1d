"""The port's swept broadphase (``candidate_lists_swept``, ``bp_window`` > 0).

Same inputs, made from a seed with numpy, go through the port's sweep, the
port's matrix path (``candidate_lists``) and the reference's
``candidate_lists`` (and its ``candidate_lists_swept`` where a case pins one
of its faults).  Candidate slots, keys, thresholds and counts must be
identical; the sweep's slack is at most the matrix's and positive (it is
exact unless a slim static body makes it a bound), and within 1e-6
relative of the reference's swept slack where that is not poisoned.  Every
case asserts which branch it took through the sweep's counters: windows of
248 and more with N = 1024 take the sweep; window 128 and a pair straddling
a window edge within an ulp of touching take the fallback.

Then the wiring: a step with ``bp_window = 248`` equals a step with 0 bit
for bit on the fused, grid and portable paths of a pile whose only static
body is fat along the sweep axis (so the slack is exact), and a batch of
three worlds of which one falls back equals each world's own steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avbd3d_tpu.ops import broadphase as jbp

from avbd3d_tpu_torch import SceneBuilder, SolverParams, solver
from avbd3d_tpu_torch.convert import world_from_arrays
from avbd3d_tpu_torch.ops import broadphase as tbp
from avbd3d_tpu_torch.parallel import batched_step, replicate_world, world_at
from avbd3d_tpu_torch.parallel.batched import with_tensors, world_tensors

torch.set_num_threads(1)

G, D, MARGIN = 8, 16, 0.04
_ref_matrix = jax.jit(jbp.candidate_lists, static_argnames=("degree",))
_ref_swept = jax.jit(jbp.candidate_lists_swept,
                     static_argnames=("degree", "margin", "window"))


def _cg(a, g):
    return np.ascontiguousarray(a.T).reshape(a.shape[1], g, 128)


def random_world(rng, n_real, spread, static_frac=0.1, excl_pairs=0, g=G):
    """The reference test's fixture shape (tests/test_swept_broadphase.py):
    random boxes with random orientations, a fat ground slab, statics,
    exclusions, padding.  numpy arrays in the candidate_lists argument
    order."""
    n = g * 128
    pos = np.zeros((n, 3), np.float32)
    pos[:n_real] = rng.uniform(-spread, spread, (n_real, 3)).astype(np.float32)
    pos[n_real:, 1] = -1e6
    radius = np.full(n, -1e9, np.float32)
    radius[:n_real] = rng.uniform(0.6, 1.1, n_real).astype(np.float32)
    half = np.zeros((n, 3), np.float32)
    half[:n_real] = rng.uniform(0.3, 0.8, (n_real, 3)).astype(np.float32)
    quat = np.zeros((n, 4), np.float32)
    q = rng.normal(size=(n_real, 4)).astype(np.float32)
    quat[:n_real] = q / np.linalg.norm(q, axis=1, keepdims=True)
    quat[n_real:, 3] = 1.0
    dynamic = np.zeros(n, bool)
    dynamic[:n_real] = rng.random(n_real) >= static_frac
    pos[0] = (0, -spread, 0)
    half[0] = (4 * spread, 0.5, 4 * spread)
    radius[0] = float(np.linalg.norm(half[0]))
    quat[0] = (0, 0, 0, 1)
    dynamic[0] = False
    excl = np.full((2, n), -1, np.int32)
    used = np.zeros(n, np.int32)
    for _ in range(excl_pairs):
        i, j = rng.integers(1, n_real, 2)
        if i == j or used[i] >= 2 or used[j] >= 2:
            continue
        excl[used[i], i], excl[used[j], j] = j, i
        used[i] += 1
        used[j] += 1
    return (_cg(pos, g), _cg(quat, g), tuple(half[:, k].reshape(g, 128) for k in range(3)),
            radius.reshape(g, 128), dynamic.reshape(g, 128), excl.reshape(2, g, 128))


def box_grid(pos, half, dynamic, g=G):
    """Unrotated boxes (``pos``, ``half`` (N_real, 3)) padded to g * 128."""
    n, n_real = g * 128, len(pos)
    p = np.zeros((n, 3), np.float32)
    p[:n_real], p[n_real:, 1] = pos, -1e6
    h = np.zeros((n, 3), np.float32)
    h[:n_real] = half
    quat = np.tile(np.float32([0, 0, 0, 1]), (n, 1))
    radius = np.full(n, -1e9, np.float32)
    radius[:n_real] = np.linalg.norm(half, axis=1)
    dyn = np.zeros(n, bool)
    dyn[:n_real] = dynamic
    excl = np.full((2, n), -1, np.int32)
    return (_cg(p, g), _cg(quat, g), tuple(h[:, k].reshape(g, 128) for k in range(3)),
            radius.reshape(g, 128), dyn.reshape(g, 128), excl.reshape(2, g, 128))


def equal_cube_pile():
    """The fat ground and 10 x 3 x 8 unrotated unit cubes stacked in
    columns: equal extents (ties in the fat top-k) and equal AABB minima
    (ties in the sort)."""
    pos = [(0.0, -0.5, 0.0)] + [((x - 4.5) * 1.02, 0.5 + y * 1.0, (z - 3.5) * 1.02)
                                for y in range(3) for z in range(8) for x in range(10)]
    half = [(50.0, 0.5, 50.0)] + [(0.5, 0.5, 0.5)] * 240
    return box_grid(np.float32(pos), np.float32(half), [False] + [True] * 240)


def slabs(d, n_slabs=8, per=128):
    """``n_slabs`` slabs of 128 boxes (1 x 0.4 x 0.4, apart within a slab)
    at x = k * d, all dynamic: with d a float32 ulp above 1.04, boxes of
    adjacent slabs touch to within an ulp of the margin.  Chunk t of the
    sweep is slab t."""
    yz = np.float32([(0.5 * (i % 12), 0.5 * (i // 12)) for i in range(per)])
    pos = np.concatenate([np.concatenate([np.full((per, 1), np.float32(k) * d, np.float32), yz], 1)
                          for k in range(n_slabs)])
    half = np.tile(np.float32([0.5, 0.2, 0.2]), (len(pos), 1))
    return box_grid(pos, half, np.ones(len(pos), bool), g=n_slabs * per // 128)


def to_torch(args):
    return tuple(tuple(torch.from_numpy(np.array(h)) for h in a) if isinstance(a, tuple)
                 else torch.from_numpy(np.array(a)) for a in args)


def to_jax(args):
    return tuple(tuple(map(jnp.asarray, a)) if isinstance(a, tuple) else jnp.asarray(a)
                 for a in args)


def run_swept(targs, window):
    """The port's swept lists and the branch they took (True: swept)."""
    before = (tbp.candidate_lists_swept.swept, tbp.candidate_lists_swept.fallbacks)
    out = tbp.candidate_lists_swept(*targs, D, MARGIN, window)
    after = (tbp.candidate_lists_swept.swept, tbp.candidate_lists_swept.fallbacks)
    assert after[0] + after[1] == before[0] + before[1] + 1
    return out, after[0] == before[0] + 1


def check(args, window, swept_expected=True):
    """The port's sweep against the port's matrix and the reference's
    matrix; returns (swept lists, matrix lists, reference swept lists)."""
    targs = to_torch(args)
    swept, took_sweep = run_swept(targs, window)
    assert took_sweep == swept_expected
    matrix = tbp.candidate_lists(*targs, D, MARGIN)
    ref = _ref_matrix(*to_jax(args), D, MARGIN)
    for name, s, m, r in zip(("nb", "key", "thr", "cand"), swept[:4], matrix[:4], ref[:4]):
        assert torch.equal(s, m) and s.is_contiguous(), name     # the kernels need contiguous
        np.testing.assert_array_equal(s.numpy(), np.asarray(r), err_msg=name)
    assert 0.0 < float(swept[4]) <= float(matrix[4])
    np.testing.assert_allclose(float(matrix[4]), float(ref[4]), rtol=1e-6)
    ref_swept = _ref_swept(*to_jax(args), degree=D, margin=MARGIN, window=window)
    if float(ref_swept[4]) > 0.0:
        np.testing.assert_allclose(float(swept[4]), float(ref_swept[4]), rtol=1e-6)
    return swept, matrix, ref_swept


@pytest.mark.parametrize("seed,n_real,spread,window", [(3, 900, 14.0, 504), (3, 900, 14.0, 1024),
                                                       (5, 500, 14.0, 248),
                                                       (6, 600, 20.0, 248)])
def test_swept_matches_matrix_dense(seed, n_real, spread, window):
    check(random_world(np.random.default_rng(seed), n_real, spread, excl_pairs=1), window)


def test_swept_matches_matrix_with_exclusions_and_statics():
    args = random_world(np.random.default_rng(4), 500, 16.0, static_frac=0.3, excl_pairs=40)
    assert (args[5] >= 0).sum() > 40
    check(args, 248)


def test_swept_equal_cube_pile_ties():
    """Equal extents and equal AABB minima: the ground is the only fat
    body whatever order topk gives the tied cube extents, and the stable
    sort keeps stacked cubes in body order; the results do not depend on
    either order."""
    args = equal_cube_pile()
    swept, matrix, _ = check(args, 248)
    last = tbp.candidate_lists_swept.last
    assert int(last["axis"]) == 0
    fat = last["fat"].reshape(-1)
    assert bool(fat[0]) and int(fat.sum()) == 1
    assert int(matrix[3]) > 1000
    assert float(swept[4]) == float(matrix[4])     # the only static body is fat


def test_swept_window_128_falls_back():
    """A window of 128 is one chunk wide: with a dense scene the guard
    fires on every chunk with dynamic rows, and the fallback gives the
    matrix path's lists."""
    check(random_world(np.random.default_rng(7), 900, 14.0, excl_pairs=1), 128,
          swept_expected=False)


def test_swept_slack_not_poisoned():
    """n = 1024, 300 real bodies, window 256: chunks past the real bodies
    have no dynamic rows and windows whose left edge is a padding
    sentinel.  The reference adds their bound anyway (its
    broadphase.py:640), so its slack is about -1e30 and its cache would
    refresh every step; the port gates each chunk's bound on its dynamic
    rows."""
    args = random_world(np.random.default_rng(1), 300, 14.0)
    swept, matrix, ref_swept = check(args, 256)
    assert float(ref_swept[4]) < -1e29
    assert 0.0 < float(swept[4]) <= float(matrix[4])


@pytest.mark.parametrize("window,swept_expected", [(248, False), (504, True)])
def test_swept_one_ulp_pair_at_window_edge(window, swept_expected):
    """Adjacent slabs touch to within an ulp of the margin, so some of
    their pairs are candidates and some are not.  Window 248 cuts slab
    t + 1 (and t - 1) in two: a pair straddles the edge and the guard
    fires; window 504 holds both neighbouring slabs whole and cuts the next
    ones, apart by a slab: the guard passes.  Either way the lists are the
    matrix path's."""
    d = np.nextafter(np.float32(1.04), np.float32(2.0))
    args = slabs(d)
    _swept, matrix, _ = check(args, window, swept_expected)
    assert 0 < int(matrix[3]) < 7 * 128 * 2


def test_sweep_under_vmap_matches_each_world():
    """``sweep_lists`` under ``torch.func.vmap`` (as ``batched_step`` runs
    it) over two worlds with exclusions, one of which falls back: each
    world's lists and guard are its own call's, bit for bit."""
    worlds = [to_torch(random_world(np.random.default_rng(4), 500, 16.0, static_frac=0.3,
                                    excl_pairs=40)),
              to_torch(random_world(np.random.default_rng(7), 900, 14.0, excl_pairs=20))]

    def stacked(i):
        parts = [w[i] for w in worlds]
        if isinstance(parts[0], tuple):
            return tuple(torch.stack(h) for h in zip(*parts))
        return torch.stack(parts)

    def one(*args):
        lists, info = tbp.sweep_lists(*args, D, MARGIN, 248)
        return lists, info["need_fallback"]

    lists_b, need_b = torch.func.vmap(one)(*(stacked(i) for i in range(6)))
    assert need_b.tolist() == [False, True]
    for i, w in enumerate(worlds):
        lists, need = one(*w)
        assert bool(need) == bool(need_b[i])
        for a, b in zip(lists, lists_b):
            assert torch.equal(a, b[i])


# ---------------------------------------------------------------------------
# Wiring: the step paths and the batch
# ---------------------------------------------------------------------------

def wide_pile(nx, ny, nz, min_bodies):
    """Ground + a pile of unit cubes wider in x than tall, layers overlapping
    by 2 mm (contacts from the first step): the sweep runs along x, where
    the 100 x 1 x 100 ground is fat, the only static body."""
    sb = SceneBuilder()
    sb.add_body((100, 1, 100), 0.0, 0.5, (0, -0.5, 0))
    for y in range(ny):
        for z in range(nz):
            for x in range(nx):
                sb.add_body((1, 1, 1), 1.0, 0.5,
                            ((x - (nx - 1) / 2) * 1.01, 0.499 + y * 0.998,
                             (z - (nz - 1) / 2) * 1.01 + 0.003 * y))
    params = SolverParams(iterations=8, beta=30000.0, gamma=0.995, lhs_fresh_rebuild_every=4)
    arrays, params, cap, _ = sb.build(params, max_degree=28, cache_degree=16,
                                      min_bodies=min_bodies)
    return world_from_arrays(arrays, "cpu"), params, cap


def leaves_equal(a, b):
    ta, tb = world_tensors(a), world_tensors(b)
    return [k for k in ta if not torch.equal(ta[k], tb[k])]


@pytest.mark.parametrize("backend", ["pallas", "grid", "xla"])
def test_step_with_window_equals_step_without(backend):
    w0, p, cap = wide_pile(10, 2, 4, 1024)
    cap = cap.replace(backend=backend)
    path = {"pallas": "fused", "grid": "grid", "xla": "xla"}[backend]
    swept0 = tbp.candidate_lists_swept.swept
    ws, wm = w0, w0
    for _ in range(3):
        ws = solver.step(ws, p, cap.replace(bp_window=248))
        assert solver.step.last_path == path
        wm = solver.step(wm, p, cap)
        assert leaves_equal(ws, wm) == []
    assert tbp.candidate_lists_swept.swept > swept0
    last = tbp.candidate_lists_swept.last
    assert int(last["axis"]) == 0 and bool(last["fat"].reshape(-1)[0])
    assert int(ws.diagnostics.as_dict()["active_manifolds"]) > 0


def test_batched_step_with_a_fallback_world_matches_single_runs():
    """Three worlds; the third holds a dynamic fat plank, so its guard
    fires while the other two keep the sweep.  Each world equals its own
    ``solver.step(..., backend="xla")`` bit for bit."""
    w0, p, cap = wide_pile(8, 2, 4, 256)
    cap = cap.replace(bp_window=248)
    worlds = replicate_world(w0, 3)
    lv = world_tensors(worlds)
    lv["bodies.linvel"] = lv["bodies.linvel"].clone()
    lv["bodies.linvel"][1, 1] -= 0.3 * (w0.bodies.inv_mass > 0)
    lv["bodies.size"] = lv["bodies.size"].clone()
    lv["bodies.size"][2, 0, 0, 1] = 12.0        # body 1 of world 2: a plank 12 m long
    lv["bodies.radius"] = lv["bodies.radius"].clone()
    lv["bodies.radius"][2, 0, 1] = float(np.linalg.norm([12.0, 1.0, 1.0]) / 2)
    worlds = with_tensors(worlds, lv)
    singles = [world_at(worlds, i) for i in range(3)]

    c = tbp.candidate_lists_swept
    base = (c.swept, c.fallbacks)
    for _ in range(2):
        singles = [solver.step(s, p, cap.replace(backend="xla")) for s in singles]
    single_counts = (c.swept - base[0], c.fallbacks - base[1])
    base = (c.swept, c.fallbacks)
    for _ in range(2):
        worlds = batched_step(worlds, p, cap)
    assert (c.swept - base[0], c.fallbacks - base[1]) == single_counts
    assert single_counts[0] >= 2 and single_counts[1] >= 1
    for i, s in enumerate(singles):
        assert leaves_equal(world_at(worlds, i), s) == [], i
