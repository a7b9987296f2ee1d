"""Cells of BENCHMARK.json run in turns on two source trees, on one card.

    python tools/ab_cells.py --parent DIR [--cell NAME ...] [--pairs N]
        [--sides parent,change] [--out DIR]

Each cell's command (BENCHMARK.json's ``command``, run as it is written;
a name that is no cell there but a regime of the bench runs as ``python -m
avbd3d_tpu_torch.bench --regime NAME --seed 0``) runs ``--pairs`` times in
each tree: pair i runs the parent first when i is
even and the change first when it is odd, each run a process of its own
from the root of its tree (``--parent``, e.g. an archive of the parent
commit unpacked into a git-ignored directory; the change is the tree this
file lies in).  ``--sides parent`` runs the parent alone (a new cell's
spread before its bound is set).  Every run's output is kept under
``--out``; one JSON line a run is printed as it ends (the cell, the side,
steps_per_sec, correct, the refresh share, the traced window's device us,
idle share and launches a step) and a summary last: for each cell and side
the runs, their median and quartiles, the card's name and power limit, and
for each cell the pairs the change won.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def quartiles(xs):
    if len(xs) < 2:
        return [xs[0], xs[0]] if xs else [None, None]
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return [q[0], q[2]]


def run(cell: dict, side: str, root: str, out_dir: str, k: int) -> dict:
    stem = os.path.join(out_dir, f"{cell['name']}.{side}.{k}")
    t0 = time.perf_counter()
    with open(stem + ".out", "w") as fo, open(stem + ".err", "w") as fe:
        proc = subprocess.run(shlex.split(cell["command"]), cwd=root, stdout=fo, stderr=fe,
                              timeout=cell["timeout_s"])
    with open(stem + ".out") as f:
        lines = f.read().strip().splitlines()
    last = json.loads(lines[-1]) if lines else {}
    lay = (last.get("layers") or {}).get(cell["name"], {})
    rec = {"cell": cell["name"], "side": side, "k": k, "rc": proc.returncode,
           "seconds": round(time.perf_counter() - t0, 1),
           "steps_per_sec": last.get("steps_per_sec"), "correct": last.get("correct"),
           "failed_steps": last.get("failed_steps"),
           "refresh_share": lay.get("refresh_share"),
           "device_us_per_step": lay.get("device_us_per_step"),
           "idle_share": lay.get("idle_share"), "launches_per_step": lay.get("launches_per_step")}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--cell", action="append")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--sides", default="parent,change")
    parser.add_argument("--out", default=os.path.join(HERE, "chiprun_out", "ab"))
    args = parser.parse_args(argv)
    with open(os.path.join(HERE, "BENCHMARK.json")) as f:
        cells = {c["name"]: c for c in json.load(f)["workloads"]}
    names = args.cell or list(cells)
    for name in names:
        cells.setdefault(name, {"name": name, "timeout_s": 600, "command": (
            f"python -m avbd3d_tpu_torch.bench --regime {name} --seed 0")})
    roots = {"parent": os.path.abspath(args.parent), "change": HERE}
    sides = args.sides.split(",")
    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    records = []
    for name in names:
        for k in range(args.pairs):
            order = sides if k % 2 == 0 else sides[::-1]
            for side in order:
                records.append(run(cells[name], side, roots[side], args.out, k))
    summary = {"card": card, "cells": {}}
    for name in names:
        by_side = {s: [r for r in records if r["cell"] == name and r["side"] == s] for s in sides}
        entry = {}
        for s, rs in by_side.items():
            xs = [r["steps_per_sec"] for r in rs if r["steps_per_sec"] is not None]
            entry[s] = {"runs": xs, "median": statistics.median(xs) if xs else None,
                        "quartiles": quartiles(xs), "all_correct": all(r["correct"] for r in rs)}
        if set(sides) == {"parent", "change"}:
            pairs = list(zip(by_side["parent"], by_side["change"]))
            entry["change_wins"] = sum((c["steps_per_sec"] or 0) > (p["steps_per_sec"] or 0)
                                       for p, c in pairs)
            entry["pairs"] = len(pairs)
        summary["cells"][name] = entry
    print(json.dumps(summary))
    return 0 if all(r["rc"] == 0 for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
