"""The broadphase refresh (ops/broadphase.candidate_lists, refresh_needed):
the plain versions against the JAX reference, the wrappers' dispatch and
the launchers' operand checks.  The kernels of csrc/bp_refresh.cu against
their plain versions on the card are tests/test_torch_port.py's (a file
without JAX, which the card's machine lacks) and chip_smoke.py's phase 19.

Inputs are made from numpy seeds.  Tolerances: slots, keys, thresholds and
counts identical; the slack (a min of identically computed floats) bit for
bit; the refresh predicate's bool equal.  The reference's candidate_lists
and refresh_or_reuse are jitted once per shape (its own tests run them so);
the latter's decision is read from its cache's anchors (moved: refreshed).
"""

import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avbd3d_tpu.config import SolverParams as JParams
from avbd3d_tpu.models import scenes as jscenes
from avbd3d_tpu.ops import broadphase as jbp

import avbd3d_tpu_torch
from avbd3d_tpu_torch import kernels, solver, solver_cuda
from avbd3d_tpu_torch.config import Capacity, SolverParams
from avbd3d_tpu_torch.convert import world_from_arrays
from avbd3d_tpu_torch.ops import broadphase as tbp

torch.set_num_threads(1)

_ref_lists = jax.jit(jbp.candidate_lists, static_argnames=("degree",))
_ref_reuse = jax.jit(jbp.refresh_or_reuse, static_argnames=("degree", "margin"))


def random_bodies(seed, g, n_real, box, degree, margin, static_frac=0.2, n_excl=0,
                  all_static=False):
    """A box of ``n_real`` jittered, tilted boxes (half extents 0.3-0.8 m,
    a fifth static) in a world of ``g`` groups, the rest padding (negative
    radius, parked 1e6 m below); ``n_excl`` exclusion columns listing each
    body's index neighbours.  Returns the candidate_lists arguments as
    numpy arrays (halves as a 3-tuple) and (degree, margin)."""
    rng = np.random.default_rng(seed)
    n = g * 128
    pos = np.zeros((n, 3), np.float32)
    pos[:n_real] = rng.uniform(-box, box, (n_real, 3))
    pos[n_real:, 1] = -1e6
    half = np.full((n, 3), 0.5, np.float32)
    half[:n_real] = rng.uniform(0.3, 0.8, (n_real, 3))
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0.0, np.pi, (n, 1))
    quat = np.concatenate([axis * np.sin(ang / 2), np.cos(ang / 2)], 1).astype(np.float32)
    radius = np.full(n, -1e9, np.float32)
    radius[:n_real] = np.linalg.norm(half[:n_real], axis=1)
    dynamic = np.zeros(n, bool)
    if not all_static:
        dynamic[:n_real] = rng.random(n_real) >= static_frac
    excl = np.full((n_excl, n), -1, np.int32)
    ids = np.arange(n_real)
    for e in range(n_excl):
        partner = ids + (1 if e % 2 == 0 else -1) * (e // 2 + 1)
        ok = (partner >= 0) & (partner < n_real)
        excl[e, ids[ok]] = partner[ok]
    arrays = (pos.T.reshape(3, g, 128).copy(), quat.T.reshape(4, g, 128).copy(),
              tuple(half[:, k].reshape(g, 128).copy() for k in range(3)),
              radius.reshape(g, 128), dynamic.reshape(g, 128), excl.reshape(n_excl, g, 128))
    return arrays, degree, margin


def to_torch(arrays):
    return [tuple(map(torch.from_numpy, a)) if isinstance(a, tuple) else torch.from_numpy(a)
            for a in arrays]


def to_jax(arrays):
    return [tuple(map(jnp.asarray, a)) if isinstance(a, tuple) else jnp.asarray(a)
            for a in arrays]


def masked_per_row(arrays, margin):
    """Each row's masked columns (candidate_lists_plain's mask, rows in
    blocks of 512)."""
    pos, quat, half, radius, dynamic, _excl = to_torch(arrays)
    n = radius.numel()
    c, wh = pos.reshape(3, n), tbp.world_halves_rows(quat, half).reshape(3, n)
    radius, dynamic = radius.reshape(n), dynamic.reshape(n)
    jj = torch.arange(n)[None]
    out = []
    for r0 in range(0, n, 512):
        sl = slice(r0, r0 + 512)
        gap = tbp._cheb_gap(c[:, sl, None], wh[:, sl, None], c[:, None], wh[:, None], margin)
        mask = ((gap <= 0.0) & tbp._real_pair(radius[sl, None], radius[None], margin)
                & (torch.arange(r0, r0 + 512)[:, None] != jj) & dynamic[sl, None])
        out.append(mask.sum(1))
    return torch.cat(out)


def cache_of(arrays, lists):
    """``cache_from_lists`` of the port's lists (its dropped count)."""
    pos, quat = (torch.from_numpy(a) for a in arrays[:2])
    return tbp.cache_from_lists(types.SimpleNamespace(pos=pos, quat=quat), lists)


CASES = {
    # N = 1024 (Stress1000's width): a loose box, most rows below the width.
    "n1024": dict(seed=1, g=8, n_real=900, box=7.0, degree=24, margin=0.05),
    # N = 5120, G = 40 (Stress4096's width): rows in four blocks of 1280.
    "n5120_blocked": dict(seed=2, g=40, n_real=4097, box=11.0, degree=28, margin=0.05),
    # More partners than the width: dropped slots, every threshold a key.
    "crowded": dict(seed=3, g=8, n_real=1000, box=3.5, degree=8, margin=0.1),
    # Exclusion columns (each body's index neighbours, as a chain lists them).
    "exclusions": dict(seed=4, g=8, n_real=700, box=3.0, degree=24, margin=0.05, n_excl=4),
    # N = 5120, D = 28, crowded: hundreds of rows hold more masked columns
    # than the lists kernel's per-row buffer (its exact cut to the D smallest).
    "n5120_over_buffer": dict(seed=6, g=40, n_real=5000, box=6.0, degree=28, margin=0.1),
    # No dynamic body: nothing listed, no slack.
    "no_dynamic": dict(seed=5, g=8, n_real=900, box=4.0, degree=24, margin=0.05,
                       all_static=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_candidate_lists_match_reference(case):
    """The plain version (what CPU tensors take) against the reference's
    candidate_lists: nb, key, thr, cand and dropped identical, slack bit for
    bit; each case holds what it is named for."""
    arrays, degree, margin = random_bodies(**CASES[case])
    ref = _ref_lists(*to_jax(arrays), degree=degree, margin=margin)
    out = tbp.candidate_lists(*to_torch(arrays), degree, margin)
    ref = [np.asarray(x) for x in ref]
    for name, x, y in zip(("nb", "key", "thr", "cand"), out, ref):
        np.testing.assert_array_equal(x.numpy(), y, err_msg=name)
    assert out[4].numpy().view(np.int32) == ref[4].view(np.int32), (float(out[4]), ref[4])
    dropped = int(ref[3]) - int((ref[0] >= 0).sum())
    assert int(cache_of(arrays, out).dropped) == dropped

    nb, thr, cand = ref[0], ref[2], int(ref[3])
    padding = arrays[3] < 0
    assert padding.any() and (nb[:, padding] == -1).all()
    if case == "no_dynamic":
        assert cand == 0 and (nb == -1).all() and (thr == tbp.INT32_MAX).all()
        assert float(ref[4]) == np.float32(1e9)
        return
    assert cand > 0 and float(ref[4]) < 1e9
    # Rows with fewer partners than the width: empty slots, no threshold.
    assert (thr == tbp.INT32_MAX).any() and (nb == -1).any()
    if case == "crowded":
        assert dropped > 0 and (thr < tbp.INT32_MAX).sum() > 500
    if case == "n5120_over_buffer":
        assert (masked_per_row(arrays, margin) > kernels.BP_ROW_BUFFER).sum() > 100
    if case == "exclusions":
        free = _ref_lists(*to_jax(arrays[:5] + (arrays[5][:0],)), degree=degree, margin=margin)
        assert int(free[3]) > cand          # the exclusions removed listed pairs


def pile_world(seed, nx, ny, nz, g):
    """The reference's pile of jittered unit cubes on a ground slab with
    fresh candidate lists (JAX world, params, cap)."""
    rng = np.random.default_rng(seed)
    sb = jscenes.SceneBuilder()
    sb.add_body((100, 1, 100), 0.0, 0.5, (0, -0.5, 0))
    for y in range(ny):
        for z in range(nz):
            for x in range(nx):
                axis = rng.normal(size=3)
                axis /= np.linalg.norm(axis)
                ang = rng.uniform(0.0, 0.05)
                sb.add_body((1, 1, 1), 1.0, 0.5,
                            ((x - (nx - 1) / 2) * 1.01 + rng.uniform(-0.02, 0.02),
                             0.499 + y * 0.998, (z - (nz - 1) / 2) * 1.01),
                            (*(axis * np.sin(ang / 2)), np.cos(ang / 2)))
    world, params, cap, _ = sb.build(JParams(), max_degree=16, min_bodies=g * 128,
                                     cache_degree=8)
    bp = jbp.build_bp_cache(world.bodies, world.exclusions, cap.max_degree, params.bp_margin)
    return world.replace(bp=bp), params, cap


@pytest.mark.parametrize("shift", [0.0, 1e-3, 0.03, 0.3])
def test_refresh_needed_matches_reference(shift):
    """The predicate (the plain version on CPU tensors) against the
    reference's refresh_or_reuse (refreshed: its cache's anchors moved),
    with every dynamic body moved and turned by a seeded amount of scale
    ``shift`` since its anchor: small moves reuse the lists, large ones
    refresh them."""
    jw, params, cap = pile_world(6, 6, 3, 6, 1)
    rng = np.random.default_rng(int(shift * 1e4))
    b = jw.bodies
    dyn = np.asarray(b.inv_mass)[None] > 0
    pos = np.asarray(b.pos) + dyn * rng.normal(scale=shift, size=b.pos.shape).astype(np.float32)
    quat = np.asarray(b.quat) + dyn * rng.normal(scale=shift, size=b.quat.shape).astype(
        np.float32)
    quat = (quat / np.linalg.norm(quat, axis=0, keepdims=True)).astype(np.float32)
    moved = b.replace(pos=jnp.asarray(pos), quat=jnp.asarray(quat))
    cache = _ref_reuse(jw.bp, moved, jw.exclusions, degree=cap.max_degree,
                       margin=params.bp_margin)
    want = not np.array_equal(np.asarray(cache.anchor), np.asarray(jw.bp.anchor))
    tw = world_from_arrays(jax.device_get(dataclasses.asdict(jw)), "cpu")
    tb = tw.bodies.replace(pos=torch.from_numpy(pos), quat=torch.from_numpy(quat))
    got = tbp.refresh_needed(tw.bp, tb, params.bp_margin)
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == bool(want)
    assert bool(got) == (shift >= 0.03)
    assert tbp.refresh_needed.launches == 0


class _NoKernels(types.ModuleType):
    """Stands in for avbd3d_tpu_torch.kernels: any use fails."""

    def __getattr__(self, name):
        raise AssertionError(f"kernels.{name} used on CPU tensors")


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers run their plain versions: the refresh's
    results equal them, the kernels module is never touched, no count
    moves; a grid step (its predicate and a refresh) neither."""
    trap = _NoKernels("avbd3d_tpu_torch.kernels")
    monkeypatch.setitem(sys.modules, "avbd3d_tpu_torch.kernels", trap)
    monkeypatch.setattr(avbd3d_tpu_torch, "kernels", trap)
    solver_cuda.reset_launch_counts()
    arrays, degree, margin = random_bodies(**CASES["exclusions"])
    args = to_torch(arrays)
    got = tbp.candidate_lists(*args, degree, margin)
    want = tbp.candidate_lists_plain(*args, degree, margin)
    assert all(torch.equal(x, y) for x, y in zip(got, want))

    jw, params, cap = pile_world(7, 4, 2, 4, 8)
    tw = world_from_arrays(jax.device_get(dataclasses.asdict(jw)), "cpu")
    b = tw.bodies
    fresh = tbp.build_bp_cache(b, tw.exclusions, cap.max_degree, params.bp_margin)
    plain = tbp.cache_from_lists(b, tbp.candidate_lists_plain(
        b.pos, b.quat, tuple(b.size[k] * 0.5 for k in range(3)), b.radius, b.dynamic,
        tw.exclusions, cap.max_degree, params.bp_margin))
    for f in ("nb", "key", "thr", "cand", "slack", "dropped"):
        assert torch.equal(getattr(fresh, f), getattr(plain, f)), f
    rng = np.random.default_rng(9)
    moved = b.replace(pos=b.pos + b.inv_mass[None].sign() * torch.from_numpy(
        rng.normal(scale=0.1, size=b.pos.shape).astype(np.float32)))
    assert bool(tbp.refresh_needed(tw.bp, moved, params.bp_margin))
    assert torch.equal(tbp.refresh_needed(tw.bp, moved, params.bp_margin),
                       tbp.refresh_needed_plain(tw.bp, moved, params.bp_margin))
    grid_cap = Capacity(**dataclasses.asdict(cap)).replace(backend="grid")
    out = solver.step(tw.replace(bodies=moved), SolverParams(**dataclasses.asdict(params)),
                      grid_cap)
    assert solver.step.last_path == "grid" and solver.step.last_gates["refreshed"]
    assert torch.isfinite(out.bodies.pos).all()
    assert (tbp.candidate_lists.launches, tbp.refresh_needed.launches) == (0, 0)


@pytest.fixture
def no_build(monkeypatch):
    """kernels._lib fails the test if a launcher reaches the build."""
    def refuse():
        raise AssertionError("the launcher built the kernels before checking its operands")

    monkeypatch.setattr(kernels, "_lib", refuse)


def test_launchers_reject_bad_operands_before_building(no_build):
    """Each launcher checks dtype, shape and the device of its operands
    before it builds or launches anything."""
    sc_arrays, degree, margin = random_bodies(**CASES["n1024"])
    pos, quat, half, radius, dynamic, excl = to_torch(sc_arrays)
    ext, dyn = torch.stack(half), dynamic.to(torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        kernels.launch_bp_tables(pos.double(), quat, ext, 1.0, radius, dyn)
    with pytest.raises(ValueError, match="shape"):
        kernels.launch_bp_tables(pos[:2], quat, ext, 1.0, radius, dyn)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.launch_bp_tables(pos, quat, ext, 1.0, radius, dyn)
    table, max_wh = torch.zeros((1024, 8)), torch.zeros(())
    with pytest.raises(ValueError, match="shape"):
        kernels.launch_bp_lists(table[:, :7], table, max_wh, excl, degree, margin)
    with pytest.raises(TypeError, match="dtype"):
        kernels.launch_bp_lists(table, table, max_wh, excl.float(), degree, margin)
    with pytest.raises(ValueError, match="candidate width"):
        kernels.launch_bp_lists(table, table, max_wh, excl, kernels.BP_MAX_DEGREE + 1, margin)
    with pytest.raises(ValueError, match="multiples of 128"):
        kernels.launch_bp_lists(table[:1000], table, max_wh, excl, degree, margin)
    with pytest.raises(ValueError, match="rows a block"):
        kernels.launch_bp_lists(table, table, max_wh, excl, degree, margin, rows_per_block=64)
    # The kernel's shared memory does not grow with N: 60K columns pass the
    # checks (and meet the device check, these being CPU tensors).
    with pytest.raises(ValueError, match="CUDA tensors"):
        big = torch.zeros((60 * 1024, 8))
        kernels.launch_bp_lists(table, big, max_wh, excl, degree, margin)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.launch_bp_lists(table, table, max_wh, excl, degree, margin)
    jw, params, _cap = pile_world(8, 3, 1, 3, 1)
    tw = world_from_arrays(jax.device_get(dataclasses.asdict(jw)), "cpu")
    bp = tw.bp
    with pytest.raises(ValueError, match="shape"):
        kernels.launch_refresh_needed(tw.bodies, bp.anchor[:2], bp.anchor_quat, bp.slack, 0.1)
    with pytest.raises(TypeError, match="dtype"):
        kernels.launch_refresh_needed(tw.bodies, bp.anchor, bp.anchor_quat, bp.slack.double(),
                                      0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.launch_refresh_needed(tw.bodies, bp.anchor, bp.anchor_quat, bp.slack, 0.1)

