"""The port's row-form solvers (``maths.solve3``, ``solve33_matrix``,
``solve66``) against numpy and against the JAX reference's functions.

The numpy cases are tests/test_maths.py's, with its tolerances (float32
LDL against a float64 solve).  Against the reference the same seeded
inputs go through both; the two libraries round the same float32
operations, held to 1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import torch

from avbd3d_tpu import maths as jmaths

from avbd3d_tpu_torch import maths


def _spd3(seed, n=128):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, 3, 3)).astype(np.float32)
    a = (np.einsum("nij,nkj->nik", m, m) + 0.1 * np.eye(3)).astype(np.float32)
    return a, rng.normal(size=(n, 3)).astype(np.float32)


def _spd6(seed, n=64):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, 6, 6)).astype(np.float32)
    a = (np.einsum("nij,nkj->nik", m, m) + 50.0 * np.eye(6)).astype(np.float32)
    return a, rng.normal(size=(n, 6)).astype(np.float32)


def _blocks(a, b, lib):
    return tuple(lib(x) for x in (a[:, :3, :3], a[:, :3, 3:], a[:, 3:, :3], a[:, 3:, 3:],
                                  b[:, :3], b[:, 3:]))


def test_solve3_matches_numpy():
    a, b = _spd3(3)
    x = maths.solve3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    expected = np.linalg.solve(a.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x, expected, rtol=2e-3, atol=2e-4)


def test_solve3_degenerate_returns_zero():
    x = maths.solve3(torch.zeros((4, 3, 3)), torch.ones((4, 3))).numpy()
    np.testing.assert_array_equal(x, np.zeros((4, 3)))


def test_solve66_matches_numpy():
    a, b = _spd6(4)
    x_l, x_a = maths.solve66(*_blocks(a, b, torch.from_numpy))
    x = np.concatenate([x_l.numpy(), x_a.numpy()], axis=-1)
    expected = np.linalg.solve(a.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x, expected, rtol=5e-3, atol=5e-4)


def test_solve3_and_solve33_match_reference():
    a, b = _spd3(5)
    x = maths.solve3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, np.asarray(jmaths.solve3(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    rhs = np.random.default_rng(6).normal(size=a.shape).astype(np.float32)
    y = maths.solve33_matrix(torch.from_numpy(a), torch.from_numpy(rhs)).numpy()
    np.testing.assert_allclose(
        y, np.asarray(jmaths.solve33_matrix(jnp.asarray(a), jnp.asarray(rhs))),
        rtol=1e-5, atol=1e-6)


def test_solve3_degenerate_rows_match_reference():
    """Rows whose pivots fall below FLT_EPSILON return zero in both, the
    others their solution: a batch mixing singular and regular systems."""
    a, b = _spd3(7, n=8)
    a[::2] = 0.0
    a[1, 1, 1] = a[1, 0, 1] * a[1, 1, 0] / a[1, 0, 0]     # second pivot exactly 0
    x = maths.solve3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jmaths.solve3(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(x[::2], 0.0)
    np.testing.assert_allclose(x, want, rtol=1e-5, atol=1e-6)


def test_solve66_matches_reference():
    a, b = _spd6(8)
    tl, ta = maths.solve66(*_blocks(a, b, torch.from_numpy))
    jl, ja = jmaths.solve66(*_blocks(a, b, jnp.asarray))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)


def test_solve66_agrees_with_the_component_form():
    """The row form and the fused step's component form (``solve66_cm``)
    solve the same system."""
    a, b = _spd6(9)
    tl, ta = maths.solve66(*_blocks(a, b, torch.from_numpy))
    t = torch.from_numpy(a)
    sym = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    a_ll = tuple(t[:, i, j] for i, j in sym)
    a_la = tuple(t[:, i, 3 + j] for i in range(3) for j in range(3))
    a_aa = tuple(t[:, 3 + i, 3 + j] for i, j in sym)
    rhs = torch.from_numpy(b)
    cl, ca = maths.solve66_cm(a_ll, a_la, a_aa, tuple(rhs[:, :3].unbind(-1)),
                              tuple(rhs[:, 3:].unbind(-1)))
    np.testing.assert_allclose(torch.stack(cl, -1).numpy(), tl.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch.stack(ca, -1).numpy(), ta.numpy(), rtol=1e-4, atol=1e-5)
