"""ONE world body-sharded over torch.distributed ranks (parallel/sharded.py)
against the single-process portable path, on the CPU (gloo).

The bounds are tests/test_sharded_world.py's, as ``utils/sharded_check.py``
runs them, on two scenes: that test's 40-cube pile on a slab (its real
bodies all on rank 0), and stacks whose real bodies fill every rank, each
contact between two ranks; ``ballistic=False``, ``backend="xla"``; contact
and manifold counts
identical after every step, max_penetration within 1e-4, the real bodies'
poses within 5e-4 (all-reduces re-associate float sums, so bits are not
expected); the sharded candidate selection identical to the unsharded one
(keys are unique); one host read a step on every rank.  The ranks are
spawned processes that meet at a ``tcp://localhost`` address.
"""

import pytest
import torch

from avbd3d_tpu_torch.parallel import shard_world, world_specs
from avbd3d_tpu_torch.utils import sharded_check


def assert_held(out):
    failed = [name for name, ok in out["held"].items() if not ok]
    assert not failed, (failed, out)


@pytest.mark.parametrize("scene", ["pile", "stacks"])
def test_sharded_world_matches_single_process(scene):
    assert_held(sharded_check.check(2, "cpu", min_bodies=256, blocks=8, block_steps=1,
                                    scene=scene))


@pytest.mark.slow
@pytest.mark.parametrize("scene", ["pile", "stacks"])
def test_sharded_world_matches_single_process_4_ranks(scene):
    assert_held(sharded_check.check(4, "cpu", min_bodies=1024, blocks=40, block_steps=1,
                                    scene=scene))


def test_shard_world_splits_group_leaves_and_rejects_a_bad_split():
    world, _params, _cap, _n = sharded_check.pile_scene(384, "cpu")      # G = 3
    specs = world_specs(world)
    assert specs["bodies.pos"] and specs["contacts.lam"] and specs["bp.thr"]
    assert not specs["bp.cand"] and not specs["diagnostics.vec"]
    assert not specs["joints.body_a"]
    part = shard_world(world, 2, 3)
    assert part.bodies.g == 1 and part.contacts.lam.shape[-2] == 1
    assert torch.equal(part.bodies.pos, world.bodies.pos[:, 2:3])
    with pytest.raises(ValueError, match="not divisible"):
        shard_world(world, 0, 2)
