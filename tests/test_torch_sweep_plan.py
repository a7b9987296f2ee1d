"""The sweep plan of the port's K1 / K4 / K6 kernels and the order of their
fold over cache slots, on the CPU.

``solver_cuda.sweep_plan`` decides by shape how the tiled sweep kernels
(csrc/step_kernel.cu) run: the body tile, threads and shared memory of a
thread block, and whether a logical block's sweeps are one cluster-resident
launch or one launch per half-sweep.  The kernels take its numbers as they
are, so the limits of the card are held here.  The second half pins why the
kernels fold a body's per-slot partial sums left to right from slot 0: that
order reproduces ``ops.replicated.body_forces`` / ``body_matrix`` bit for
bit, and a tree-shaped fold does not.
"""

import pytest
import torch

from avbd3d_tpu_torch import cm, kernels, load_scene, run_steps, solver_cuda
from avbd3d_tpu_torch.ops import replicated as rep
from avbd3d_tpu_torch.solver_cuda import SweepPlan, step_kernel_count, sweep_plan
from avbd3d_tpu_torch.solver_grid import pick_gb

# (label, n, dc, blk, dj, ds) -> (route, tile, threads, cluster): the shapes
# the repository runs and the route PERF.md names for each.
SHAPES = {
    "Stress1000": ((1024, 12, None, 0, 0), ("launches", 32, 384, 0)),
    "512 bodies": ((512, 12, None, 0, 0), ("cluster", 32, 384, 16)),
    "Stress2048": ((2048, 12, None, 0, 0), ("launches", 32, 384, 0)),
    "Stress4096 blk 1024": ((5120, 16, 1024, 0, 0), ("cluster", 64, 1024, 16)),
    "grid tier blk 2048": ((6144, 16, 2048, 0, 0), ("launches", 32, 512, 0)),
    "RodJointed": ((128, 16, None, 2, 0), ("launches", 32, 512, 0)),
    "SoftGrid": ((128, 16, None, 4, 0), ("launches", 32, 512, 0)),
    "spring world": ((128, 16, None, 0, 1), ("launches", 32, 512, 0)),
    "20 sheets": ((2048, 32, None, 4, 0), ("launches", 32, 1024, 0)),
    "Ground": ((128, 16, None, 0, 0), ("cluster", 32, 512, 4)),
    "Stack": ((128, 16, None, 0, 0), ("cluster", 32, 512, 4)),
    "7^3 pile": ((384, 12, None, 0, 0), ("cluster", 32, 384, 12)),
    "wide cache": ((256, 48, None, 0, 0), ("cluster", 32, 768, 8)),
}


@pytest.mark.parametrize("label", sorted(SHAPES))
def test_sweep_plan_limits_and_route(label):
    (n, dc, blk, dj, ds), (route, tile, threads, cluster) = SHAPES[label]
    plan = sweep_plan(n, dc, blk, dj, ds)
    blk = n if blk is None else blk
    # The card's limits.
    assert plan.threads <= solver_cuda.MAX_THREADS and plan.threads % 32 == 0
    assert plan.smem_bytes <= solver_cuda.MAX_SMEM_BYTES
    assert 0 <= plan.cluster <= solver_cuda.MAX_CLUSTER
    # A block's threads are tile x lanes, its lanes cover the DC slots, and
    # its shared memory holds every partial and the folded force / torque.
    assert plan.threads % plan.tile == 0
    lanes = plan.threads // plan.tile
    assert lanes * plan.slots_per_thread >= dc > lanes * (plan.slots_per_thread - 1)
    assert plan.smem_bytes == 4 * (solver_cuda.N_PARTIALS * dc + 6) * plan.tile
    # Tiles cover the world in whole groups, clusters cover a logical block.
    assert n % 128 == 0 and 128 % plan.tile == 0 and n % plan.tile == 0
    if plan.cluster:
        assert plan.tile * plan.cluster == blk and dj == 0 and ds == 0
    assert (plan.route, plan.tile, plan.threads, plan.cluster) == (route, tile, threads, cluster)


@pytest.mark.parametrize("scene", ["Ground", "Stack", "Stress1000", "RodJointed", "SoftGrid"])
def test_sweep_plan_of_loaded_scenes(scene):
    """The plan as ``step_kernel`` derives it from a loaded world."""
    w = load_scene(scene, device="cpu").world
    plan = sweep_plan(w.bodies.n, w.contacts.other.shape[0], None, w.joints.dj, w.springs.ds)
    # Clusters for contact-only worlds whose 32-body tiles fit one cluster.
    rows = w.joints.dj > 0 or w.springs.ds > 0
    assert plan.route == ("launches" if rows or w.bodies.n > 512 else "cluster")
    assert plan == sweep_plan(*SHAPES[scene][0])


def test_sweep_plan_grid_blocks():
    """K6's logical blocks: ``pick_gb`` gives 8 or 16 groups of 128 bodies."""
    for g, route in ((40, "cluster"), (48, "launches"), (24, "cluster")):
        blk = pick_gb(g) * 128
        plan = sweep_plan(g * 128, 16, blk)
        assert plan.route == route
        if route == "cluster":
            assert plan.tile * plan.cluster == blk == 1024


@pytest.mark.parametrize("args, match", [
    ((1000, 12), "multiple of 128"),
    ((1024, 0), "DC >= 1"),
    ((5120, 16, 2048), "does not divide"),
    ((1024, 12, 96), "does not divide"),
    ((2048, 64), "shared memory"),
])
def test_sweep_plan_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        sweep_plan(*args)


@pytest.mark.parametrize("label, kw, want", [
    # filter, collide, predict, one resident launch, final body, final reduce
    ("Stack", dict(n_main=10, iters_end=10), 6),
    ("512 bodies, 5 sweeps", dict(n_main=5, iters_end=5), 6),
    ("512 bodies", dict(n_main=130, iters_end=130), 8),
    # the same with k_geom and two launches per sweep
    ("Stress1000", dict(n_main=20, iters_end=20), 46),
    ("Stress2048", dict(n_main=20, iters_end=21), 48),
    # decay + 6 + (contact terms, sub-passes, dual) per sweep + joint dual + tracker
    ("RodJointed", dict(n_main=20, iters_end=20, dj=2, n_colors=2), 108),
    ("SoftGrid", dict(n_main=20, iters_end=20, dj=4, n_colors=1), 88),
    ("spring world", dict(n_main=10, iters_end=10, ds=1, n_colors=3), 37),
])
def test_step_kernel_count(label, kw, want):
    plan = sweep_plan(*SHAPES[label.split(",")[0]][0])
    assert step_kernel_count(plan, **kw) == want


def test_plan_argument_order():
    """The 5 ints the entry points take, in ``struct SweepPlan`` order."""
    arg = kernels._plan_arg(SweepPlan(64, 768, 1, 93696, 16))
    assert list(arg) == [64, 768, 1, 93696, 16]


def test_ptxas_usage_parses_template_kernels():
    log = """== step_kernel.cu
ptxas info    : Compiling entry function '_Z8k_sweepsILi768EEv4Dims5Cache6Bodies4Work7KParamsi8IterPlani5Carry' for 'sm_90a'
ptxas info    : Function properties for _Z8k_sweepsILi768EEv4Dims5Cache6Bodies4Work7KParamsi8IterPlani5Carry
    24 bytes stack frame, 20 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 85 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z6k_once4DimsPKiPKfPh' for 'sm_90a'
ptxas info    : Function properties for _Z6k_once4DimsPKiPKfPh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 14 registers
"""
    assert kernels.ptxas_usage(log) == {
        "k_sweeps<768>": {"registers": 85, "spill_bytes": 48},
        "k_once": {"registers": 14, "spill_bytes": 0},
    }


# ---------------------------------------------------------------------------
# The fold over slots
# ---------------------------------------------------------------------------

def slot_partials(world, params, monkeypatch):
    """Per-slot partial sums of ``body_forces`` (6) and ``body_matrix`` (24)
    at the state ``world`` (what a (slot, body) thread of the kernels leaves
    in shared memory), and the plain functions' totals."""
    b, cache = world.bodies, world.contacts
    pos = tuple(b.pos[k] for k in range(3))
    quat = tuple(b.quat[k] for k in range(4))
    body = {"pos": pos, "quat": quat, "inv_mass": b.inv_mass, "friction": b.friction}
    consts = rep.pair_constants(cache.other, body)
    static = rep.geometry_static(cache, consts)
    geom = rep.geometry_pose(cache, static, {"pos": pos, "quat": quat}, consts, None)
    rows = rep.eval_rows(geom, cache, consts, cache.lam, cache.penalty, cache.stick,
                         torch.tensor(params.alpha), params)
    f = rep.primal_force(rows, cache.penalty)
    iiw = solver_cuda._world_inertia_comps(quat, tuple(b.inv_inertia[k] for k in range(3)))
    partials, dsum = [], cm.dsum
    monkeypatch.setattr(cm, "dsum", lambda x: (partials.append(x), dsum(x))[1])
    forces = rep.body_forces(geom, f)
    mat = rep.body_matrix(geom, f, cache.penalty, iiw)
    monkeypatch.setattr(cm, "dsum", dsum)
    totals = (torch.stack(forces["F"] + forces["T"]),
              torch.stack(mat["m_ll"] + mat["m_la"] + mat["m_aa"] + mat["gyro"]))
    assert [tuple(x.shape[:2]) for x in partials] == [(cache.other.shape[0], 6),
                                                      (cache.other.shape[0], 24)]
    return partials, totals


def fold_left(x):
    """The kernels' fold: slot 0's value, then + slot 1, + slot 2, ..."""
    acc = x[0]
    for t in range(1, x.shape[0]):
        acc = acc + x[t]
    return acc


def fold_tree(x):
    """The usual shared-memory reduction: halve the slot axis by adding its
    upper half onto its lower half."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:2 * h]
    return x[0]


@pytest.fixture(scope="module")
def settled():
    out = {}
    for name in ("TwoBlockDrop", "Stack", "Pyramid"):
        sc = load_scene(name, device="cpu")
        out[name] = (run_steps(sc.world, sc.params, sc.cap, 40), sc.params)
    return out


@pytest.mark.parametrize("scene", ["TwoBlockDrop", "Stack", "Pyramid"])
def test_ordered_fold_reproduces_plain_sums(settled, scene, monkeypatch):
    world, params = settled[scene]
    partials, totals = slot_partials(world, params, monkeypatch)
    assert int((world.contacts.count > 0).sum()) > 0
    for part, total in zip(partials, totals):
        assert torch.equal(fold_left(part), total)


def test_tree_fold_changes_the_bits(settled, monkeypatch):
    """With up to two occupied slots per body (TwoBlockDrop, Stack) any
    order gives the same sum; the pyramid's boxes touch up to four
    neighbours, and there the tree rounds differently."""
    differs = {}
    for scene, (world, params) in settled.items():
        partials, totals = slot_partials(world, params, monkeypatch)
        differs[scene] = sum(int((fold_tree(part) != total).sum())
                             for part, total in zip(partials, totals))
        for part, total in zip(partials, totals):
            # A rounding difference only: a few ulps of the largest term.
            assert float((fold_tree(part) - total).abs().max()) <= 1e-5 * float(part.abs().max())
    assert differs["Pyramid"] > 0
    assert int((settled["Pyramid"][0].contacts.count > 0).sum(0).max()) >= 3
