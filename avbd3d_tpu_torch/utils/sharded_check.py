"""ONE world body-sharded over n ranks against the same world on one device.

    python -m avbd3d_tpu_torch.utils.sharded_check [--ranks 4] [--device cuda|cpu]
        [--scene pile|stacks|all] [--min-bodies 1024] [--blocks 40] [--block-steps 1]

Two scenes, each ``ballistic=False``, ``backend="xla"``:

- ``pile``: tests/test_sharded_world.py's 40-cube pile on a slab, padded to
  ``--min-bodies``.  Its 41 real bodies are rows 0-40, all on rank 0.
- ``stacks``: every row a real body, so that every rank holds real bodies
  and every contact crosses ranks: the slab (row 0), then one cube a row,
  rank r's cubes forming layer r of stacks, each on a cube of layer r - 1
  whose row is not its own less one rank's rows (1.6 m apart across, so no
  candidate pair lies within one layer).  Partner reads across ranks, the row offsets and the global keys
  of every rank meet real bodies in contact.

The command spawns ``--ranks`` processes that meet at a ``tcp://localhost``
address (gloo on the CPU; NCCL on CUDA, rank r on card r), steps each
rank's shard with ``parallel.sharded_run`` for ``--blocks`` x
``--block-steps`` steps, and compares with the whole world stepped on one
device (card 0, or the CPU), held to the reference test's bounds: contact
and manifold counts identical after every block (by default every step:
the layers land and bounce, so contacts come and go), some block with
contacts, max_penetration within 1e-4, the real bodies' poses within
5e-4; and the candidate lists of the initial state (a 0.5 m margin, so
every cube has some) identical.  For ``stacks`` also: real bodies on every
rank, and contacts between bodies of different ranks at the end.  Both
sides take the control lanes from K2's plain version (K2 folds over one
device's bodies).  Prints one JSON line, by scene; exits 1 when a check
fails.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import tempfile
import time

import numpy as np
import torch

BP_FIELDS = ("nb", "key", "thr", "cand", "slack", "dropped")
LIST_MARGIN = 0.5


def _build(sb, min_bodies: int, device):
    from ..config import SolverParams
    from ..convert import world_from_arrays

    arrays, params, cap, n_real = sb.build(SolverParams(ballistic=False), max_degree=8,
                                           min_bodies=min_bodies)
    return world_from_arrays(arrays, device), params, cap.replace(backend="xla"), n_real


def pile_scene(min_bodies: int, device, n_ranks: int = 1):
    """(world, params, cap, real bodies) of the 40-cube pile on ``device``."""
    from ..models.scenes import SceneBuilder

    sb = SceneBuilder()
    sb.add_body((40, 1, 40), 0.0, 0.5, (0, -0.5, 0))
    rng = np.random.default_rng(5)
    for i in range(40):
        x, z = divmod(i, 8)
        sb.add_body((1, 1, 1), 1.0, 0.5,
                    (1.1 * x - 2.0 + 0.02 * float(rng.standard_normal()), 0.55 + 1.1 * (i % 3),
                     1.1 * z - 4.0 + 0.02 * float(rng.standard_normal())))
    return _build(sb, min_bodies, device)


def stacks_scene(min_bodies: int, device, n_ranks: int):
    """(world, params, cap, real bodies) of ``n_ranks``-high stacks: the
    slab, then a cube in every other row (no padding); row i is in layer
    ``i // rows`` (``rows`` = the rows of one rank) at place ``(i + 37 *
    layer) % rows`` of the layer's grid, so that the rows of two stacked
    cubes differ by other than ``rows`` and a rank's row offset shows."""
    from ..models.scenes import SceneBuilder

    n = -(-min_bodies // 128) * 128
    if (n // 128) % n_ranks:
        raise ValueError(f"G = {n // 128} does not split over {n_ranks} ranks")
    rows = n // n_ranks
    side = int(np.ceil(np.sqrt(rows)))
    rng = np.random.default_rng(7)
    sb = SceneBuilder()
    sb.add_body((40, 1, 40), 0.0, 0.5, (0, -0.5, 0))
    for i in range(1, n):
        layer, col = divmod(i, rows)
        x, z = divmod((col + 37 * layer) % rows, side)
        sb.add_body((1, 1, 1), 1.0, 0.5,
                    (1.6 * (x - side / 2) + 0.02 * float(rng.standard_normal()),
                     0.52 + 1.01 * layer,
                     1.6 * (z - side / 2) + 0.02 * float(rng.standard_normal())))
    return _build(sb, min_bodies, device)


SCENES = {"pile": pile_scene, "stacks": stacks_scene}


def _device(kind: str, rank: int):
    return torch.device("cpu") if kind == "cpu" else torch.device("cuda", rank)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _plain_lanes():
    """Route K2 to its plain version (what a sharded world computes)."""
    from .. import solver_cuda

    kernel = solver_cuda.control_lanes
    solver_cuda.control_lanes = solver_cuda.control_lanes_plain
    return kernel


def _rank_main(rank, n_ranks, port, kind, scene, min_bodies, blocks, block_steps, out):
    from .. import solver
    from ..ops.broadphase import build_bp_cache
    from ..parallel import make_world_mesh, shard_world, sharded_run

    torch.set_num_threads(1)
    comm = make_world_mesh(rank, n_ranks, f"tcp://localhost:{port}", device=kind)
    world, params, cap, _ = SCENES[scene](min_bodies, _device(kind, rank), n_ranks)
    w = shard_world(world, rank, n_ranks)
    bp = build_bp_cache(w.bodies, w.exclusions, cap.max_degree, LIST_MARGIN, comm)
    diags = []
    t0 = time.perf_counter()
    for _ in range(blocks):
        w = sharded_run(w, params, cap, comm, n_steps=block_steps)
        diags.append(w.diagnostics.vec.clone())
    seconds = time.perf_counter() - t0
    torch.save({"diag": torch.stack(diags).cpu(), "pos": w.bodies.pos.cpu(),
                "quat": w.bodies.quat.cpu(), "reads": solver.step.host_reads,
                "seconds": seconds, "bp": {k: getattr(bp, k).cpu() for k in BP_FIELDS}},
               f"{out}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


def run_sharded(n_ranks: int, kind: str, scene: str, min_bodies: int, blocks: int,
                block_steps: int, out: str) -> dict:
    """Every rank's results joined: the diagnostics after each block (held
    equal on every rank), poses, host reads, seconds and the initial
    candidate lists along the group axis."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(n_ranks, _free_port(), kind, scene, min_bodies, blocks,
                               block_steps, out), nprocs=n_ranks)
    parts = [torch.load(f"{out}/rank{r}.pt") for r in range(n_ranks)]
    return {
        "diag_agree": all(torch.equal(p["diag"], parts[0]["diag"]) for p in parts),
        "diag": parts[0]["diag"],
        "pos": torch.cat([p["pos"] for p in parts], dim=1),
        "quat": torch.cat([p["quat"] for p in parts], dim=1),
        "reads": [p["reads"] for p in parts],
        "seconds": max(p["seconds"] for p in parts),
        "bp": {k: torch.cat([p["bp"][k] for p in parts], dim=-2) if k in ("nb", "key", "thr")
               else parts[0]["bp"][k] for k in BP_FIELDS},
    }


def check(n_ranks: int, kind: str = "cpu", min_bodies: int = 256, blocks: int = 8,
          block_steps: int = 1, scene: str = "pile") -> dict:
    """Run both sides on ``scene`` and return the comparison (every entry
    of ``held`` must be True)."""
    from .. import solver, solver_cuda
    from ..ops.broadphase import build_bp_cache

    world, params, cap, n_real = SCENES[scene](min_bodies, _device(kind, 0), n_ranks)
    if world.bodies.g % n_ranks:
        raise ValueError(f"G = {world.bodies.g} does not split over {n_ranks} ranks")
    with tempfile.TemporaryDirectory() as out:
        sh = run_sharded(n_ranks, kind, scene, min_bodies, blocks, block_steps, out)
    full = build_bp_cache(world.bodies, world.exclusions, cap.max_degree, LIST_MARGIN)
    kernel = _plain_lanes()
    try:
        w, counts, pen_err = world, [], 0.0
        t0 = time.perf_counter()
        for k in range(blocks):
            for _ in range(block_steps):
                w = solver.step(w, params, cap)
            d1, d2 = w.diagnostics.vec.cpu(), sh["diag"][k]
            counts.append((int(d1[5]), int(d1[6]), int(d2[5]), int(d2[6])))
            pen_err = max(pen_err, abs(float(d2[0]) - float(d1[0])))
        seconds = time.perf_counter() - t0
    finally:
        solver_cuda.control_lanes = kernel
    pos_err = float((sh["pos"].reshape(3, -1)[:, :n_real]
                     - w.bodies.pos.cpu().reshape(3, -1)[:, :n_real]).abs().max())
    quat_err = float((sh["quat"].reshape(4, -1)[:, :n_real]
                      - w.bodies.quat.cpu().reshape(4, -1)[:, :n_real]).abs().max())
    # Which ranks hold real bodies, and contacts between bodies of two ranks
    # (rank of a row: row // rows a rank) in the single device's last state.
    rows = w.bodies.n // n_ranks
    own = torch.arange(w.bodies.n).reshape(w.bodies.g, 128)
    other, count = w.contacts.other.cpu(), w.contacts.count.cpu()
    touching = (other >= 0) & (count > 0)
    cross = int((touching & (other // rows != own[None] // rows)).sum())
    ranks_real = sorted({r // rows for r in range(n_real)})
    lists = all(torch.equal(sh["bp"][k], getattr(full, k).cpu()) for k in BP_FIELDS)
    held = {
        "ranks agree on the diagnostics": sh["diag_agree"],
        "one host read a step on every rank": all(r == blocks * block_steps
                                                  for r in sh["reads"]),
        "candidate lists identical": lists and int(full.cand) > 100,
        "contact and manifold counts identical": all(a == c and b == e
                                                     for a, b, c, e in counts),
        "contacts made": max(c[1] for c in counts) > 10,
        "sanitized 0": float(sh["diag"][:, 8].max()) == 0.0,
        "max_penetration within 1e-4": pen_err <= 1e-4,
        "poses within 5e-4": max(pos_err, quat_err) <= 5e-4,
    }
    if scene == "stacks":
        held["real bodies on every rank"] = ranks_real == list(range(n_ranks))
        held["contacts between ranks"] = cross > 0
    return {"scene": scene, "ranks": n_ranks, "device": kind, "n": world.bodies.n,
            "real_bodies": n_real, "ranks_with_real_bodies": ranks_real,
            "cross_rank_contact_slots": cross, "steps": blocks * block_steps,
            "held": held, "counts": counts, "max_penetration_err": pen_err,
            "pos_err": pos_err, "quat_err": quat_err, "sharded_seconds": sh["seconds"],
            "single_seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scene", default="all", choices=("pile", "stacks", "all"))
    ap.add_argument("--min-bodies", type=int, default=1024)
    ap.add_argument("--blocks", type=int, default=40)
    ap.add_argument("--block-steps", type=int, default=1)
    args = ap.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"sharded_check: {args.ranks} ranks need {args.ranks} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    scenes = list(SCENES) if args.scene == "all" else [args.scene]
    out = {sc: check(args.ranks, args.device, args.min_bodies, args.blocks, args.block_steps,
                     sc) for sc in scenes}
    print(json.dumps(out))
    return 0 if all(all(o["held"].values()) for o in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
