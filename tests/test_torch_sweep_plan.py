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

from avbd3d_tpu_torch import SceneBuilder, cm, kernels, load_scene, run_steps, solver_cuda
from avbd3d_tpu_torch.config import SolverParams
from avbd3d_tpu_torch.convert import world_from_arrays
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
    "RodJointed": ((128, 16, None, 2, 0), ("cluster", 32, 512, 4)),
    "SoftGrid": ((128, 16, None, 4, 0), ("cluster", 32, 512, 4)),
    "spring world": ((128, 16, None, 0, 1), ("cluster", 32, 512, 4)),
    "20 sheets": ((2048, 32, None, 4, 0), ("grid", 16, 512, 0)),
    "jointed 2048, DC 16": ((2048, 16, None, 2, 0), ("grid", 32, 512, 0)),
    "jointed 512, DC 32": ((512, 32, None, 4, 0), ("grid", 16, 512, 0)),
    "narrow-cache rod": ((128, 1, None, 2, 0), ("cluster", 32, 32, 4)),
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
    # its shared memory holds every partial (or, where they are more, a
    # sub-pass's joint and spring terms) and the folded force / torque.
    assert plan.threads % plan.tile == 0
    lanes = plan.threads // plan.tile
    assert lanes * plan.slots_per_thread >= dc > lanes * (plan.slots_per_thread - 1)
    per_body = max(solver_cuda.N_PARTIALS * dc, solver_cuda.ROW_TERMS * (dj + ds))
    assert plan.smem_bytes == 4 * (per_body + 6) * plan.tile
    # Tiles cover the world in whole groups, clusters cover a logical block.
    assert n % 128 == 0 and 128 % plan.tile == 0 and n % plan.tile == 0
    rows = dj > 0 or ds > 0
    if plan.cluster:
        assert plan.tile * plan.cluster == blk
    # Worlds with rows: resident sweeps with 128 registers a thread (at most
    # 512 threads a block), one cluster or a grid barrier over blocks that
    # are all resident (one per SM at most); the grid barrier for them only.
    assert plan.grid in (0, 1) and not (plan.grid and plan.cluster)
    if rows:
        assert plan.route in ("cluster", "grid") and plan.threads <= 512
        assert n // plan.tile <= solver_cuda.H100_SMS
    else:
        assert plan.grid == 0
    assert (plan.route, plan.tile, plan.threads, plan.cluster) == (route, tile, threads, cluster)


@pytest.mark.parametrize("scene", ["Ground", "Stack", "Stress1000", "RodJointed", "SoftGrid"])
def test_sweep_plan_of_loaded_scenes(scene):
    """The plan as ``step_kernel`` derives it from a loaded world."""
    w = load_scene(scene, device="cpu").world
    plan = sweep_plan(w.bodies.n, w.contacts.other.shape[0], None, w.joints.dj, w.springs.ds)
    # One cluster for a world whose 32-body tiles fit one (with or without
    # rows); above that, launches per half-sweep for contact-only worlds and
    # the cooperative route for worlds with joint or spring rows.
    rows = w.joints.dj > 0 or w.springs.ds > 0
    assert plan.route == ("cluster" if w.bodies.n <= 512 else "grid" if rows else "launches")
    assert plan == sweep_plan(*SHAPES[scene][0])


def narrow_cache_rod(device):
    """A rod of four segments hard-welded below a static top segment, and a
    cube resting on a slab, with a contact cache of width 1 (D = 8, DC = 1,
    two joint slots a body, two colours); chip_smoke.py builds the same
    world."""
    sb = SceneBuilder()
    sb.add_body((40, 1, 40), 0.0, 0.5, (0, -0.5, 0))
    sb.add_body((1, 1, 1), 1.0, 0.5, (3.0, 0.55, 0.0))
    prev = None
    for i in range(5):
        cur = sb.add_body((0.25, 1, 0.25), 0.0 if i == 0 else 1.0, 0.5, (0, 6.0 - i, 0))
        if prev is not None:
            sb.add_joint(prev, cur, (0, -0.5, 0), (0, 0.5, 0))
        prev = cur
    arrays, p, cap, _ = sb.build(SolverParams(iterations=20), max_degree=8, cache_degree=1)
    return world_from_arrays(arrays, device), p, cap


def test_sweep_plan_of_narrow_cache_jointed_world():
    """A welded rod with a contact cache of width 1: its two joint slots'
    row terms (2 x 27 a body) outnumber the contact partials (30), and they
    size the block's shared memory instead of refusing the world."""
    w, _p, cap = narrow_cache_rod("cpu")
    dc, dj = w.contacts.other.shape[0], w.joints.dj
    assert (dc, dj, w.springs.ds, cap.joint_colors) == (1, 2, 0, 2)
    assert solver_cuda.ROW_TERMS * dj > solver_cuda.N_PARTIALS * dc
    plan = sweep_plan(w.bodies.n, dc, None, dj, w.springs.ds)
    assert plan == sweep_plan(*SHAPES["narrow-cache rod"][0])
    assert plan.smem_bytes == 4 * (solver_cuda.ROW_TERMS * dj + 6) * plan.tile


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
    ((4352, 16, None, 2, 0), "cannot all be resident"),
    ((2304, 32, None, 4, 0), "cannot all be resident"),
    ((128, 16, None, 80, 0), "joint and spring slots"),
])
def test_sweep_plan_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        sweep_plan(*args)


@pytest.mark.parametrize("label, kw, want", [
    # filter, collide, predict, one resident launch, final body, final reduce
    ("Stack", dict(iters_end=10), 6),
    ("512 bodies, 5 sweeps", dict(iters_end=5), 6),
    ("512 bodies", dict(iters_end=130), 8),
    # the same with k_geom and two launches per sweep
    ("Stress1000", dict(iters_end=20), 46),
    ("Stress2048", dict(iters_end=21), 48),
    # filter, collide, predict, one resident launch (the rows' decay, the
    # geometry and every sweep with its colour sub-passes), final body,
    # final reduce, and the joint tracker where there are joints: 7 against
    # the 108 / 88 / 37 of one launch per sub-pass
    ("RodJointed", dict(iters_end=20, dj=2), 7),
    ("SoftGrid", dict(iters_end=20, dj=4), 7),
    ("20 sheets", dict(iters_end=20, dj=4), 7),
    ("RodJointed, 130 sweeps", dict(iters_end=130, dj=2), 9),
    ("narrow-cache rod", dict(iters_end=20, dj=2), 7),
    ("spring world", dict(iters_end=10, ds=1), 6),
])
def test_step_kernel_count(label, kw, want):
    plan = sweep_plan(*SHAPES[label.split(",")[0]][0])
    assert step_kernel_count(plan, **kw) == want


def test_plan_argument_order():
    """The 6 ints the entry points take, in ``struct SweepPlan`` order."""
    arg = kernels._plan_arg(SweepPlan(64, 768, 1, 93696, 16))
    assert list(arg) == [64, 768, 1, 93696, 16, 0]
    arg = kernels._plan_arg(sweep_plan(2048, 32, None, 4))
    assert list(arg) == [16, 512, 1, 61824, 0, 1]


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
ptxas info    : Compiling entry function '_Z14k_joint_sweepsILi1024ELb0EEv4Dims5Cache6Bodies4Work9JointRows7KParamsi8IterPlaniPfS7_' for 'sm_90a'
ptxas info    : Function properties for _Z14k_joint_sweepsILi1024ELb0EEv4Dims5Cache6Bodies4Work9JointRows7KParamsi8IterPlaniPfS7_
    96 bytes stack frame, 100 bytes spill stores, 120 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 96 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z9k_collideILi4EEv4Dims5CacheS0_6Bodies4Work7KParams' for 'sm_90a'
ptxas info    : Function properties for _Z9k_collideILi4EEv4Dims5CacheS0_6Bodies4Work7KParams
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers
"""
    assert kernels.ptxas_usage(log) == {
        "k_sweeps<768>": {"registers": 85, "spill_bytes": 48},
        "k_once": {"registers": 14, "spill_bytes": 0},
        "k_joint_sweeps<1024, false>": {"registers": 64, "spill_bytes": 220},
        "k_collide<4>": {"registers": 96, "spill_bytes": 0},
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


# ---------------------------------------------------------------------------
# The filter kernel's ordered compaction (k_filter_cull, one warp per body)
# ---------------------------------------------------------------------------

def popc(x):
    """__popc of each 32-bit word held in an int64 tensor."""
    return sum((x >> k) & 1 for k in range(32))


def serial_compaction(keep, dc):
    """The serial filter's counter: a kept slot d goes to nbc[run] while
    run < dc, then run += 1; the rest of nbc is -1.  ``keep`` (D, N) bool.
    Returns (nbc (DC, N) int64 holding the kept slot's d, kept count per
    body, dropped count per body)."""
    d, n = keep.shape
    nbc = torch.full((dc, n), -1, dtype=torch.int64)
    run = [0] * n
    for i in range(n):
        for s in range(d):
            if keep[s, i]:
                if run[i] < dc:
                    nbc[run[i], i] = s
                run[i] += 1
    run = torch.tensor(run)
    return nbc, run, torch.clamp(run - dc, min=0)


def warp_compaction(keep, dc):
    """The kernel's warp form: lane l of chunk c holds slot 32 c + l; the
    chunk's ballot is a 32-bit mask, a kept lane lands at the running count
    plus __popc(ballot & lanemask_lt), and the running count grows by
    __popc(ballot).  The dropped count is one per warp."""
    d, n = keep.shape
    nbc = torch.full((dc, n), -1, dtype=torch.int64)
    lanes = torch.arange(32, dtype=torch.int64)
    below = (torch.ones(32, dtype=torch.int64) << lanes) - 1          # lanemask_lt
    run = torch.zeros(n, dtype=torch.int64)
    for d0 in range(0, d, 32):
        slot = d0 + lanes                                              # (32,)
        k = torch.zeros((32, n), dtype=torch.bool)
        live = slot < d
        k[live] = keep[slot[live]]
        ballot = (k.to(torch.int64) << lanes[:, None]).sum(0)         # (N,)
        at = run[None, :] + popc(ballot[None, :] & below[:, None])    # (32, N)
        write = k & (at < dc)
        cols = torch.arange(n).expand(32, n)
        nbc[at[write], cols[write]] = slot[:, None].expand(32, n)[write]
        run = run + popc(ballot)
    return nbc, run, torch.clamp(run - dc, min=0)


@pytest.mark.parametrize("d, dc, p_keep", [(24, 12, 0.3), (28, 16, 0.5), (32, 32, 0.6),
                                           (32, 12, 0.9), (40, 16, 0.4), (70, 24, 0.35),
                                           (64, 8, 0.7)])
def test_warp_compaction_is_the_serial_order(d, dc, p_keep):
    """Random keep masks, chunked for D > 32: the ballot and prefix popcount
    put every kept slot where the serial counter puts it, and the kept and
    dropped counts are the serial ones, including bodies whose kept slots
    overflow the cache."""
    g = torch.Generator().manual_seed(d * 1000 + dc)
    keep = torch.rand((d, 256), generator=g) < p_keep
    keep[:, :4] = True                                  # overflowing bodies
    keep[:, 4:8] = False                                # empty bodies
    want = serial_compaction(keep, dc)
    got = warp_compaction(keep, dc)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert int(want[2].max()) > 0 or d <= dc
