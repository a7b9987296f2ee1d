"""The reductions of K7 (csrc/bp_probe.cu) and K2 (csrc/control_lanes.cu),
modelled in torch on the CPU, and the kernels' cached parameter block.

Both kernels take a warp per body and a lane per candidate slot: lane l
holds slots l, l + 32, ... (lanes stride when D > 32), folds them in that
order, and the warp combines its lanes with a shuffle tree (min, max, sum),
``__popc(__ballot_sync(...))`` (the count) and ``__any_sync`` (near).  A
block folds its 8 bodies in body order into partials; the last block to
finish folds the partials of every block, lane l over blocks l, l + 32, ...
in index order and then the same shuffle tree.  The models below do exactly
that, and must give the serial per-body loop's bits (the form of the
kernels before: one thread walking a body's slots in order) and the plain
versions' (``ops.broadphase.bp_probe`` / ``control_lanes``): min, max, or
and an integer sum do not depend on order.  K2's displacement sums do; the
fold's order is fixed, so a run gives the same bits whatever order the
blocks finish in, and lane 3 (``bp_dev_mm``) stays within 1e-5 relative
(1e-6 absolute) of ``torch.sum``'s.
"""

import numpy as np
import pytest
import torch

from avbd3d_tpu_torch import cm, kernels, load_scene, run_steps
from avbd3d_tpu_torch.config import SolverParams
from avbd3d_tpu_torch.ops import broadphase as tbp
from avbd3d_tpu_torch.ops.broadphase import build_bp_cache

torch.set_num_threads(1)

WARPS = 8          # bodies a block, both kernels
INF = float("inf")


# ---------------------------------------------------------------------------
# What each lane computes for its slot, and each body's own terms: the plain
# versions' expressions in their statement order.
# ---------------------------------------------------------------------------

def slot_terms(nb, s, params):
    """Per slot: K7's best separation and near test, K2's AABB gap and near
    test; per body: K2's gate speed, moved flag, displacement, chord and
    raw deviation.  ``s``: a dict of (C, G, 128) float32 leaves."""
    valid = nb >= 0
    idx = torch.where(valid, nb, 0)
    pos, quat, half = s["pos"], s["quat"], s["half"]
    gather = tbp.gather
    pp = [gather(pos[k], idx) for k in range(3)]
    pq = [gather(quat[k], idx) for k in range(4)]
    ph = [gather(half[k], idx) for k in range(3)]
    delta = [pp[k] - pos[k][None] for k in range(3)]
    own_ax = [[c[None] for c in ax] for ax in cm.q_axes(tuple(quat))]
    own_half = [h[None] for h in half]
    par_ax = [list(ax) for ax in cm.q_axes(tuple(pq))]

    def proj(axes, hh, n_vec):
        t = [hh[k] * torch.abs(axes[k][0] * n_vec[0] + axes[k][1] * n_vec[1]
                               + axes[k][2] * n_vec[2]) for k in range(3)]
        return t[0] + t[1] + t[2]

    best = torch.full(nb.shape, -1.0e9, dtype=torch.float32)
    for n_vec in own_ax + par_ax:
        sep = (torch.abs(delta[0] * n_vec[0] + delta[1] * n_vec[1] + delta[2] * n_vec[2])
               - proj(own_ax, own_half, n_vec) - proj(par_ax, ph, n_vec))
        best = torch.maximum(best, sep)
    g_len = float(sum(x * x for x in params.gravity) ** 0.5)
    lv, av = s["linvel"], s["angvel"]
    speed_sq = lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2]
    wspin = torch.sqrt(av[0] * av[0] + av[1] * av[1] + av[2] * av[2]) \
        * torch.clamp(s["radius"], min=0.0)
    travel = (torch.sqrt(speed_sq) + wspin) * params.dt
    pair = travel[None] + gather(travel, idx)
    probe_near = valid & (best - (pair + 4.0 * params.dt * params.dt * g_len)
                          <= params.collision_margin)

    wh = tbp.world_halves(tuple(quat), tuple(half))
    pwh = [gather(wh[k], idx) for k in range(3)]
    gap = torch.maximum(torch.maximum(
        torch.abs(pp[0] - pos[0][None]) - (wh[0][None] + pwh[0]),
        torch.abs(pp[1] - pos[1][None]) - (wh[1][None] + pwh[1])),
        torch.abs(pp[2] - pos[2][None]) - (wh[2][None] + pwh[2]))
    lanes_near = valid & (gap - (pair + 4.0 * params.dt**2 * g_len) <= params.collision_margin)

    dyn = s["inv_mass"] > 0.0
    alive = dyn & (pos[1] >= params.fall_freeze_y) if params.fall_freeze_y > -1.0e8 else dyn
    disp = [pos[k] - s["anchor"][k] for k in range(3)]
    disp2 = disp[0] * disp[0] + disp[1] * disp[1] + disp[2] * disp[2]
    moved = dyn | (disp2 > 0.0)
    chord = tbp._rot_chord(tuple(quat), tuple(s["anchor_quat"]), s["radius"])
    per_slot = {"valid": valid, "best": best, "probe_near": probe_near, "gap": gap,
                "lanes_near": lanes_near}
    per_body = {"v2": torch.where(alive, speed_sq, 0.0), "moved": moved,
                "mf": moved.to(torch.float32), "chord": chord,
                "dev_raw": torch.where(moved, torch.sqrt(disp2) + chord, 0.0)}
    return {**{k: v.reshape(v.shape[0], -1) for k, v in per_slot.items()},       # (D, N)
            **{k: v.reshape(-1) for k, v in per_body.items()},                   # (N,)
            "disp": [d.reshape(-1) for d in disp]}


# ---------------------------------------------------------------------------
# The serial per-body loop (one thread walking its body's slots in order)
# ---------------------------------------------------------------------------

def serial(terms):
    """min_sep, n_slots, near (K7) and K2's lanes 0, 1, 2, 4 by a loop over
    bodies and, within a body, its slots in order."""
    valid = terms["valid"].tolist()
    best, gap = terms["best"].tolist(), terms["gap"].tolist()
    pn, ln = terms["probe_near"].tolist(), terms["lanes_near"].tolist()
    v2, dev_raw = terms["v2"].tolist(), terms["dev_raw"].tolist()
    d, n = terms["valid"].shape
    min_sep, n_slots, near = 1.0e9, 0, []
    min_gap, gate, near_speed, raw = 1.0e9, 0.0, 0.0, 0.0
    for i in range(n):
        pnear = lnear = False
        for s in range(d):
            if not valid[s][i]:
                continue
            min_sep = min(min_sep, best[s][i])
            n_slots += 1
            pnear = pnear or pn[s][i]
            min_gap = min(min_gap, gap[s][i])
            lnear = lnear or ln[s][i]
        near.append(pnear)
        gate = max(gate, v2[i])
        near_speed = max(near_speed, v2[i] if lnear else 0.0)
        raw = max(raw, dev_raw[i])
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return (f32(min_sep), n_slots, torch.tensor(near),
            {0: f32(gate), 1: f32(near_speed), 2: f32(min_gap), 4: f32(raw)})


# ---------------------------------------------------------------------------
# The kernels' form: lanes, warps, blocks, the last block's fold
# ---------------------------------------------------------------------------

LANE = torch.arange(32)


def shuffle_tree(v, op):
    """``v = op(v, __shfl_xor_sync(v, off))`` for off 16, 8, 4, 2, 1 over
    dim 0 (32 lanes); every lane ends with the same value, lane 0's is
    taken."""
    for off in (16, 8, 4, 2, 1):
        v = op(v, v[LANE ^ off])
    return v[0]


def lane_fold(rows, op, identity):
    """Lane l folds rows l, l + 32, ... of ``rows`` (R, ...) in index order
    from ``identity``, then the shuffle tree: one value per trailing index."""
    r = rows.shape[0]
    v = torch.full((32,) + rows.shape[1:], identity, dtype=rows.dtype)
    for c in range(0, r, 32):
        chunk = torch.full((32,) + rows.shape[1:], identity, dtype=rows.dtype)
        chunk[:min(32, r - c)] = rows[c:c + 32]
        live = (c + LANE < r).reshape((32,) + (1,) * (rows.dim() - 1))
        v = torch.where(live, op(v, chunk), v)
    return shuffle_tree(v, op)


def popc(x):
    return sum((x >> k) & 1 for k in range(32))


def warp_slots(terms, key, near_key):
    """A warp per body: lane l takes slots l, l + 32, ...; lane-local fminf
    over its valid slots, then the shuffle tree; the count as
    __popc(__ballot_sync(valid)) per chunk of 32 slots; near as
    __any_sync.  Returns (min (N,), count (N,), near (N,))."""
    valid, vals, nears = terms["valid"], terms[key], terms[near_key]
    d, n = valid.shape
    mn = torch.full((32, n), 1.0e9)
    cnt = torch.zeros(n, dtype=torch.int64)
    near = torch.zeros((32, n), dtype=torch.bool)
    for d0 in range(0, d, 32):
        slot = d0 + LANE
        live = slot < d
        ok = torch.zeros((32, n), dtype=torch.bool)
        ok[live] = valid[slot[live]]
        val = torch.full((32, n), INF)
        val[live] = vals[slot[live]]
        mn = torch.where(ok, torch.minimum(mn, val), mn)
        ballot = (ok.to(torch.int64) << LANE[:, None]).sum(0)
        cnt += popc(ballot)
        nn = torch.zeros((32, n), dtype=torch.bool)
        nn[live] = nears[slot[live]]
        near |= ok & nn
    return shuffle_tree(mn, torch.minimum), cnt, near.any(0)


def block_partials(per_body, op):
    """Each block folds its WARPS bodies in body order: (B,)."""
    b = per_body.reshape(-1, WARPS)
    v = b[:, 0]
    for w in range(1, WARPS):
        v = op(v, b[:, w])
    return v


def add(a, b):
    return a + b


def k7_model(terms):
    mn, cnt, near = warp_slots(terms, "best", "probe_near")
    part_min = block_partials(mn, torch.minimum)
    part_cnt = block_partials(cnt, add)
    return (lane_fold(part_min, torch.minimum, 1.0e9), int(lane_fold(part_cnt, add, 0)), near)


def k2_model(terms, order=None):
    """K2's two passes.  ``order``: the order in which blocks finish; each
    writes its partials at its own index, and the last folds them by index,
    so the result does not depend on it.  Returns (5,) float32."""
    gap, _cnt, near = warp_slots(terms, "gap", "lanes_near")
    v2 = terms["v2"]
    per_body = [gap, v2, torch.where(near, v2, 0.0), terms["dev_raw"], terms["mf"],
                terms["disp"][0] * terms["mf"], terms["disp"][1] * terms["mf"],
                terms["disp"][2] * terms["mf"]]
    ops = [torch.minimum] + [torch.maximum] * 3 + [add] * 4
    parts = [block_partials(x, op) for x, op in zip(per_body, ops)]
    n_blocks = parts[0].shape[0]
    stored = torch.zeros((8, n_blocks))
    for blk in (order if order is not None else range(n_blocks)):
        for k in range(8):
            stored[k, blk] = parts[k][blk]
    fold = [lane_fold(stored[k], op, 1.0e9 if k == 0 else 0.0) for k, op in enumerate(ops)]
    nmc = torch.maximum(fold[4], torch.tensor(1.0))
    t = [fold[5] / nmc, fold[6] / nmc, fold[7] / nmc]
    e = [terms["disp"][k] - t[k] for k in range(3)]
    dev = torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]) + terms["chord"]
    dev_mm = lane_fold(torch.where(terms["moved"], dev, 0.0), torch.maximum, 0.0)
    return torch.stack([fold[1], fold[2], fold[0], dev_mm, fold[3]])


# ---------------------------------------------------------------------------
# Worlds
# ---------------------------------------------------------------------------

def random_world(d, seed, g=2):
    """Seeded random boxes in a 7 m cube (many within reach of each other)
    and a cache of width ``d`` with empty slots: bodies 0-3 with every slot
    empty, bodies 4-7 with every slot full, about 35% empty elsewhere; a few
    static bodies, a few never moved from their anchors, two below the
    fall-freeze plane."""
    rng = np.random.default_rng(seed)
    n = g * 128
    pos = rng.uniform(-3.5, 3.5, (3, n)).astype(np.float32)
    pos[1, :2] = -150.0
    quat = rng.normal(size=(4, n)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    size = rng.uniform(0.5, 1.5, (3, n)).astype(np.float32)
    radius = (0.5 * np.linalg.norm(size, axis=0)).astype(np.float32)
    inv_mass = np.where(rng.random(n) < 0.9, 1.0, 0.0).astype(np.float32)
    anchor = (pos + rng.normal(scale=0.05, size=(3, n))).astype(np.float32)
    anchor_quat = quat + rng.normal(scale=0.02, size=(4, n)).astype(np.float32)
    still = rng.random(n) < 0.1
    anchor[:, still] = pos[:, still]
    anchor_quat[:, still] = quat[:, still]
    nb = rng.integers(0, n, (d, n)).astype(np.int32)
    nb[rng.random((d, n)) < 0.35] = -1
    nb[:, :4] = -1
    nb[:, 4:8] = rng.integers(0, n, (d, 4))
    s = {"pos": pos, "quat": quat, "half": size * np.float32(0.5), "radius": radius,
         "linvel": rng.normal(scale=3.0, size=(3, n)).astype(np.float32),
         "angvel": rng.normal(scale=2.0, size=(3, n)).astype(np.float32),
         "inv_mass": inv_mass, "anchor": anchor, "anchor_quat": anchor_quat}
    s = {k: torch.from_numpy(np.ascontiguousarray(v)).reshape(v.shape[:-1] + (g, 128))
         for k, v in s.items()}
    return torch.from_numpy(nb).reshape(d, g, 128), s


def world_leaves(world):
    b, bp = world.bodies, world.bp
    half = torch.stack([b.size[k] * 0.5 for k in range(3)])
    return bp.nb, {"pos": b.pos, "quat": b.quat, "half": half, "radius": b.radius,
                   "linvel": b.linvel, "angvel": b.angvel, "inv_mass": b.inv_mass,
                   "anchor": bp.anchor, "anchor_quat": bp.anchor_quat}


def plain(nb, s, params):
    """The plain versions on the same leaves."""
    g_len = float(sum(x * x for x in params.gravity) ** 0.5)
    comp = lambda k: tuple(s[k][c] for c in range(s[k].shape[0]))  # noqa: E731
    probe = tbp.bp_probe(nb, comp("pos"), comp("quat"), comp("half"), s["radius"],
                         comp("linvel"), comp("angvel"), params.dt, params.collision_margin,
                         g_len)
    lanes = tbp.control_lanes(nb, comp("pos"), comp("quat"), comp("half"), s["radius"],
                              comp("linvel"), comp("angvel"), s["inv_mass"] > 0.0,
                              s["anchor"], s["anchor_quat"], params)
    return probe, lanes


def same_bits(a, b):
    return torch.equal(torch.as_tensor(a, dtype=torch.float32).view(torch.int32),
                       torch.as_tensor(b, dtype=torch.float32).view(torch.int32))


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 24, 28, 32, 33, 70])
def test_lane_per_slot_reduction_is_the_serial_loop(d):
    """K7's min_sep, n_slots and near and K2's lanes 0, 1, 2, 4 through the
    warp / block / last-block model equal the serial loop's and the plain
    versions' bit for bit, lanes striding over the slots for D > 32."""
    params = SolverParams()
    nb, s = random_world(d, seed=d)
    terms = slot_terms(nb, s, params)
    want_sep, want_cnt, want_near, want_lanes = serial(terms)
    got_sep, got_cnt, got_near = k7_model(terms)
    got_lanes = k2_model(terms)
    (p_sep, p_cnt, p_near), p_lanes = plain(nb, s, params)
    assert same_bits(got_sep, want_sep) and same_bits(p_sep, want_sep)
    assert got_cnt == want_cnt == int(p_cnt) == int((nb >= 0).sum())
    assert torch.equal(got_near, want_near) and torch.equal(p_near.reshape(-1), want_near)
    for lane, want in want_lanes.items():
        assert same_bits(got_lanes[lane], want), lane
        assert same_bits(p_lanes[lane], want), lane
    torch.testing.assert_close(got_lanes[3], p_lanes[3], rtol=1e-5, atol=1e-6)
    # The data reach both sides of every test.
    assert not bool(want_near[:4].any()) and float(want_sep) < 0.0
    if d >= 24:
        assert 0 < int(want_near.sum()) < want_near.numel() - 4
        assert 0.0 < float(want_lanes[1]) <= float(want_lanes[0])


@pytest.fixture(scope="module")
def stress1000():
    """Stress1000's initial state (fresh lists, anchored at the current
    poses) and its state after 10 rain-in steps (bodies moved since the
    anchors of the last refresh)."""
    sc = load_scene("Stress1000", device="cpu")
    w = sc.world
    init = w.replace(bp=build_bp_cache(w.bodies, w.exclusions, sc.cap.max_degree,
                                       sc.params.bp_margin))
    return sc.params, {"initial": init, "step 10": run_steps(w, sc.params, sc.cap, 10)}


@pytest.mark.parametrize("state", ["initial", "step 10"])
def test_control_lanes_fold_is_fixed_order(stress1000, state):
    """K2's fold over blocks on Stress1000: the same bits whatever order the
    blocks finish in (each writes its partials at its own index, the last
    folds them by index), lanes 0, 1, 2, 4 equal to the plain version's
    bits, lane 3 within 1e-5 relative (1e-6 absolute) of its torch.sum."""
    params, worlds = stress1000
    nb, s = world_leaves(worlds[state])
    terms = slot_terms(nb, s, params)
    first = k2_model(terms)
    n_blocks = nb.shape[1] * 128 // WARPS
    rng = np.random.default_rng(7)
    for _ in range(3):
        assert same_bits(k2_model(terms, order=rng.permutation(n_blocks).tolist()), first)
    _probe, want = plain(nb, s, params)
    for lane in (0, 1, 2, 4):
        assert same_bits(first[lane], want[lane]), lane
    torch.testing.assert_close(first[3], want[3], rtol=1e-5, atol=1e-6)
    if state == "step 10":
        assert float(want[3]) > 0.0 and float(terms["mf"].sum()) == 1000.0


def test_arrival_order_sums_would_not_be_fixed(stress1000):
    """Why the fold is by block index: the displacement sums folded in the
    order blocks finish (what float atomics would do) change their bits
    with that order on Stress1000 after 10 steps."""
    params, worlds = stress1000
    nb, s = world_leaves(worlds["step 10"])
    terms = slot_terms(nb, s, params)
    part = block_partials(terms["disp"][1] * terms["mf"], add)
    rng = np.random.default_rng(3)
    sums = set()
    for _ in range(8):
        acc = torch.zeros(())
        for blk in rng.permutation(part.shape[0]).tolist():
            acc = acc + part[blk]
        sums.add(int(acc.view(torch.int32)))
    assert len(sums) > 1


def test_fparams_cache(monkeypatch):
    """``kernels._fparams`` holds param_block's floats (as float32), one
    block per SolverParams (the same object for equal params, a new one for
    new params), and K7's block differs from the control lanes' only in its
    own reach constant."""
    p = load_scene("Stress1000", device="cpu").params
    block = kernels._fparams(p)
    assert list(block) == [float(np.float32(v)) for v in kernels.param_block(p)]
    assert kernels._fparams(p) is block and kernels._fparams(p.replace()) is block
    other = kernels._fparams(p.replace(dt=1.0 / 120.0))
    assert other is not block and other[0] == np.float32(1.0 / 120.0)
    probe = kernels._fparams(p, probe=True)
    rc = kernels._PARAM_NAMES.index("reach_const")
    assert probe is not block and kernels._fparams(p, probe=True) is probe
    assert [v for k, v in enumerate(probe) if k != rc] == [v for k, v in enumerate(block)
                                                          if k != rc]
    assert probe[rc] == np.float32(4.0 * p.dt * p.dt * 10.0)
    assert block[rc] == np.float32(4.0 * p.dt**2 * 10.0)
    # The two blocks are built from different constants: with the probe's
    # made distinct, each block keeps its own.
    monkeypatch.setattr(kernels, "probe_reach_const", lambda params: 123.0)
    q = p.replace(dt=1.0 / 77.0)
    assert kernels._fparams(q, probe=True)[rc] == 123.0
    assert kernels._fparams(q)[rc] == np.float32(4.0 * q.dt**2 * 10.0)
