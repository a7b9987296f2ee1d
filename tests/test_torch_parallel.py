"""The port's batched worlds (parallel/batched.py) against single worlds.

The two cases of tests/test_parallel.py (identical worlds equal one world;
worlds with a per-world kick equal their own single runs), a batch whose
worlds take different gates in one step (one refreshes its candidate
lists, one goes ballistic, one runs the calm sweep plan, one the boosted
plan), and the split of a batch over a device list.  Every world of a batch
is held to its own ``step(world_i, params, cap.replace(backend="xla"))``:
integers identical, the control lanes (taken for the whole batch after
the vmapped step, K2's world axis) identical, and poses within the
reference test's bounds (rtol 1e-5, atol 1e-6; the port's vmapped step in
fact gives the same bits).
"""

import numpy as np
import pytest
import torch

from avbd3d_tpu_torch import load_scene, solver
from avbd3d_tpu_torch.parallel import (batched_step, make_mesh, replicate_world, shard_batch,
                                       world_at)
from avbd3d_tpu_torch.parallel.batched import with_tensors, world_tensors

torch.set_num_threads(1)


def stack(worlds):
    return with_tensors(worlds[0], {k: torch.stack([world_tensors(w)[k] for w in worlds])
                                    for k in world_tensors(worlds[0])})


def assert_world_equal(batched, single):
    for group in ("contacts", "bp"):
        for name in ("other", "count", "feature") if group == "contacts" else ("nb", "key", "thr"):
            assert torch.equal(getattr(getattr(batched, group), name),
                               getattr(getattr(single, group), name)), (group, name)
    d = batched.diagnostics.vec.numpy()
    np.testing.assert_array_equal(d[5:16], single.diagnostics.vec.numpy()[5:16])
    for name in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(getattr(batched.bodies, name).numpy(),
                                   getattr(single.bodies, name).numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def singles_run(worlds, params, cap, n_steps):
    out = []
    for w in worlds:
        for _ in range(n_steps):
            w = solver.step(w, params, cap.replace(backend="xla"))
        out.append(w)
    return out


def test_batched_worlds_match_single_world():
    sc = load_scene("TwoBlockDrop", "cpu")
    worlds = replicate_world(sc.world, 4)
    reads = batched_step.host_reads
    for _ in range(3):
        worlds = batched_step(worlds, sc.params, sc.cap)
    assert batched_step.host_reads == reads + 3
    assert worlds.step_index == 3
    pos = worlds.bodies.pos.numpy()
    assert pos.shape[0] == 4
    np.testing.assert_array_equal(pos[0], pos[-1])
    (single,) = singles_run([sc.world], sc.params, sc.cap, 3)
    assert_world_equal(world_at(worlds, 0), single)


def kicked(world, batch):
    worlds = replicate_world(world, batch)
    kick = torch.arange(batch, dtype=torch.float32) * 0.01
    dyn = (world.bodies.inv_mass > 0).to(torch.float32)
    vel = worlds.bodies.linvel.clone()
    vel[:, 0] += kick[:, None, None] * dyn[None]
    return worlds.replace(bodies=worlds.bodies.replace(linvel=vel))


def test_distinct_worlds_match_their_own_single_runs():
    sc = load_scene("TwoBlockDrop", "cpu")
    worlds = kicked(sc.world, 4)
    starts = [world_at(worlds, i) for i in range(4)]
    for _ in range(3):
        worlds = batched_step(worlds, sc.params, sc.cap)
    pos = worlds.bodies.pos.numpy()
    assert not np.allclose(pos[0], pos[-1]), "the kick was lost"
    for i, single in enumerate(singles_run(starts, sc.params, sc.cap, 3)):
        assert_world_equal(world_at(worlds, i), single)


@pytest.fixture(scope="module")
def mixed():
    """TwoBlockDrop states whose next steps take different gates: step 0
    (a refresh), 6 (ballistic, falling), 30 (boosted sweeps) and 33 (calm),
    all on the portable path."""
    sc = load_scene("TwoBlockDrop", "cpu")
    cap = sc.cap.replace(backend="xla")
    states, w = [], sc.world
    for i in range(34):
        if i in (0, 6, 30, 33):
            states.append(w)
        w = solver.step(w, sc.params, cap)
    return sc, states


def test_batch_with_different_gates_matches_single_runs(mixed):
    sc, states = mixed
    cap = sc.cap.replace(backend="xla")
    worlds = stack(states)
    singles = list(states)
    seen = []
    for _ in range(3):
        worlds = batched_step(worlds, sc.params, sc.cap)
        gates = []
        for i, w in enumerate(singles):
            singles[i] = solver.step(w, sc.params, cap)
            gates.append(dict(solver.step.last_gates))
        for i, single in enumerate(singles):
            assert_world_equal(world_at(worlds, i), single)
        seen.append(gates)
    first = seen[0]
    assert [g["refreshed"] for g in first] == [True, False, False, False], first
    assert [g["ballistic"] for g in first] == [False, True, False, False], first
    assert first[2]["calm"] is False and first[3]["calm"] is True, first


def test_batch_split_over_a_device_list():
    """``shard_batch`` splits a batch into per-device chunks that
    ``batched_step`` steps as the whole batch is stepped."""
    sc = load_scene("TwoBlockDrop", "cpu")
    devices = make_mesh(device_type="cpu")
    assert devices == [torch.device("cpu")]
    worlds = kicked(sc.world, 5)
    chunks = shard_batch(worlds, devices * 2)
    assert [c.bodies.pos.shape[0] for c in chunks] == [3, 2]
    for _ in range(2):
        worlds = batched_step(worlds, sc.params, sc.cap)
        chunks = batched_step(chunks, sc.params, sc.cap)
    joined = torch.cat([c.bodies.pos for c in chunks])
    assert torch.equal(joined, worlds.bodies.pos)


def test_batched_control_lanes_match_each_world():
    """K2's plain version on a batch (every operand with a leading world
    axis, as ``attach_control`` passes it after the vmapped step) gives
    each world its own lanes, bit for bit."""
    from avbd3d_tpu_torch import solver_cuda
    from avbd3d_tpu_torch.ops.broadphase import build_bp_cache

    sc = load_scene("Pyramid", "cpu")
    w = sc.world
    w = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                    sc.params.bp_margin))
    worlds = kicked(w, 3)
    lanes = solver_cuda.control_lanes(worlds.bp.nb, worlds.bodies, worlds.bp.anchor,
                                      worlds.bp.anchor_quat, sc.params)
    assert lanes.shape == (3, 5)
    for i in range(3):
        wi = world_at(worlds, i)
        one = solver_cuda.control_lanes(wi.bp.nb, wi.bodies, wi.bp.anchor, wi.bp.anchor_quat,
                                        sc.params)
        assert torch.equal(lanes[i], one), i
    assert not torch.equal(lanes[0], lanes[2])
