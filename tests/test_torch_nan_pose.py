"""K1's plain version at a NaN pose against the JAX reference, on the CPU.

A touching 4 x 2 x 4 pile (N = 128, D = 16, DC = 8, so the precull runs),
its candidate lists built before one dynamic body's ``pos.y`` (or ``pos.x``)
is set to NaN, goes through the reference's kernel bodies' math twins
(``collide_and_init_math``, then ``solve_loop_math``, as
tests/test_torch_parity_step.py runs them) and through the port's
``collide_half`` and ``solve_half`` (the halves of ``step_kernel_plain``).
The kernels (K1, K3 and K5, which share the precull) are held to these
plain versions on the card by tests/test_torch_port.py and chip_smoke.py's
phase 21.

Tolerances: the integer outputs (slots, feature ids, counts, kept and
dropped) identical; the NaN masks of every float output equal; the collide's
finite floats within 1e-5 (one pass of the same float32 operations in two
libraries); the solve's poses within max(1e-4 m, 4x the reference's own
change when its finite poses move one float32 ulp), its count lanes
identical.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_parity_grid import jtree, nudged_pos, pile, tparams_of

from avbd3d_tpu import solver_tpu as jsolver_tpu
from avbd3d_tpu_torch import solver_cuda
from avbd3d_tpu_torch.convert import world_from_arrays

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pile128():
    jw, params, _cap = pile(4, 2, 4, 128, max_degree=16, cache_degree=8, seed=3)
    return jw, params


def nan_worlds(jw, comp: int):
    """The reference's world and the port's with the 8th dynamic body's
    ``pos[comp]`` NaN; the candidate lists are the fresh ones of the finite
    pile.  Returns (reference world, port world, the body)."""
    pos = np.array(jw.bodies.pos, dtype=np.float32)
    dyn = np.flatnonzero(np.asarray(jw.bodies.inv_mass).reshape(-1) > 0)
    i = int(dyn[7])
    pos.reshape(3, -1)[comp, i] = np.nan
    jw = jw.replace(bodies=jw.bodies.replace(pos=jax.numpy.asarray(pos)))
    return jw, world_from_arrays(jtree(jw), "cpu"), i


def operands(w):
    return w.contacts, w.bp.nb, w.bp.key, w.bp.thr, w.bodies


def assert_same_nan(x, y, what):
    np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=f"{what}: NaN masks")


@pytest.mark.parametrize("comp", [1, 0], ids=["pos.y", "pos.x"])
def test_collide_half_matches_reference_at_nan_pose(pile128, comp):
    """The precull drops every slot whose separation is NaN, as the
    reference's jnp.maximum does: the NaN body and its neighbours keep the
    reference's slots, feature ids and counts."""
    jw0, params = pile128
    jw, tw, i = nan_worlds(jw0, comp)
    nb = np.asarray(jw.bp.nb).reshape(np.asarray(jw.bp.nb).shape[0], -1)
    assert (nb[:, i] >= 0).sum() > 2 and ((nb == i).sum(axis=0) > 0).sum() > 2, \
        "the NaN body and its neighbours list each other"
    tp = tparams_of(params)
    jc, jkept, jdrop = jsolver_tpu.collide_and_init_math(*operands(jw), params)
    tc, tkept, tdrop = solver_cuda.collide_half(*operands(tw), tp)
    assert int(tkept) == int(jkept) and int(tdrop) == int(jdrop)
    ja = jax.device_get(dataclasses.asdict(jc))
    for name in solver_cuda.CACHE_FIELDS:
        x, y = getattr(tc, name).numpy(), np.asarray(ja[name])
        if y.dtype.kind in "ib":
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert_same_nan(x, y, name)
            ok = ~np.isnan(y)
            np.testing.assert_allclose(x[ok], y[ok], rtol=1e-5, atol=1e-5, err_msg=name)
    other = np.asarray(ja["other"]).reshape(ja["other"].shape[0], -1)
    assert not (other[:, i] >= 0).any(), "the NaN body keeps no slot"
    assert not (other == i).any(), "no slot keeps the NaN body"
    assert int(np.asarray(ja["count"]).sum()) > 100


@pytest.mark.parametrize("comp", [1, 0], ids=["pos.y", "pos.x"])
def test_solve_half_matches_reference_at_nan_pose(pile128, comp):
    """The solve from the same cache: the poses' NaN masks equal, the finite
    poses within the reference's own one-ulp sensitivity, the count lanes of
    the diagnostics (contacts, manifolds, dynamic bodies) identical."""
    jw0, params = pile128
    jw, tw, _i = nan_worlds(jw0, comp)
    tp = tparams_of(params)
    jc = jsolver_tpu.collide_and_init_math(*operands(jw), params)[0]
    ja = jax.device_get(dataclasses.asdict(jc))
    contacts = world_from_arrays({**jtree(jw), "contacts": ja}, "cpu").contacts
    jb, _jlam, _jpen, _jstick, jdiag = jsolver_tpu.solve_loop_math(jc, jw.bodies, params)[:5]
    tout = solver_cuda.solve_half(tp, contacts, tw.bodies, params.iterations,
                                  params.lhs_rebuild_every)
    up = jw.bodies.replace(pos=nudged_pos(jw.bodies.pos, jw.bodies.inv_mass))
    jb2 = jsolver_tpu.solve_loop_math(jc, up, params)[0]
    tol = max(1e-4, 4.0 * float(np.nanmax(np.abs(np.asarray(jb2.pos) - np.asarray(jb.pos)))))
    for k, (x, y) in enumerate(((tout[0], jb.pos), (tout[1], jb.quat), (tout[2], jb.linvel))):
        x, y = x.numpy(), np.asarray(y)
        assert_same_nan(x, y, f"body output {k}")
        ok = ~np.isnan(y)
        np.testing.assert_allclose(x[ok], y[ok], atol=tol * (150 if k == 2 else 1), rtol=0,
                                   err_msg=f"body output {k}")
    np.testing.assert_array_equal(tout[9][0, 5:9].numpy(), np.asarray(jdiag)[0, 5:9])
    assert torch.isnan(tout[0]).any(), "the NaN body's pose stays NaN in the solve"
