"""The host's step split by span over many bench runs, and its fastest run
against its slowest.

    python tools/host_split.py DIR [DIR ...]

Reads the last line of every ``*.out`` file under the directories (the
bench's JSON lines, as ``tools/ab_cells.py --out DIR`` keeps them) and, for
each regime found in their ``layers``, prints a table and then one JSON
line: the runs and their card, the whole-window steps/s, each span of
``host_span_us_per_step`` (``avbd3d_tpu_torch.bench.host_split``) with
``host_cpu_us_per_step`` and ``host_wait_us_per_step`` as median, least
and most, the device allocations and frees a step and the allocator's
retries, the idle share no host op or span names with spans and without;
the agreement of the spans with the other clocks (``step_other`` over
``step``; ``step`` less ``read`` against ``host_cpu_us_per_step``, which
also holds the bench's own loop; ``host_wait_us_per_step`` less ``read``,
the closing syncs and what ``read`` holds beside its wait); and the
fastest run against the slowest, span by span, with the spans ordered by
how much of the difference in ``step`` each carries.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys


def last_line(path: str):
    with open(path) as f:
        lines = f.read().strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def stats(xs: list) -> dict:
    xs = [x for x in xs if isinstance(x, (int, float))]
    if not xs:
        return "not measured"
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def runs_by_regime(dirs: list) -> dict:
    """{regime: [run]}: each run one bench line's regime, its steps/s, its
    layers and the file it came from."""
    out = {}
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "**", "*.out"), recursive=True)):
            line = last_line(path)
            if not line or "layers" not in line:
                continue
            for name, lay in line["layers"].items():
                if not isinstance(lay.get("host_span_us_per_step"), dict):
                    continue
                reg = line["extra"]["regimes"][name]
                out.setdefault(name, []).append({
                    "file": os.path.relpath(path), "card": line["extra"]["device"],
                    "correct": line["correct"], "steps_per_sec": reg["steps_per_sec"],
                    "layers": lay})
    return out


def summary(runs: list) -> dict:
    lay = [r["layers"] for r in runs]
    keys = list(dict.fromkeys(k for x in lay for k in x["host_span_us_per_step"]))
    us = {k: stats([x["host_span_us_per_step"].get(k) for x in lay]) for k in keys}
    for k in ("host_cpu_us_per_step", "host_wait_us_per_step"):
        us[k] = stats([x[k] for x in lay])

    def span(x, k):
        return x["host_span_us_per_step"].get(k, 0.0)

    agree = {
        "step_other_over_step": stats([span(x, "step_other") / span(x, "step") for x in lay]),
        "step_less_read_over_host_cpu": stats(
            [(span(x, "step") - span(x, "read")) / x["host_cpu_us_per_step"] for x in lay]),
        "host_cpu_less_step_less_read_us": stats(
            [x["host_cpu_us_per_step"] - span(x, "step") + span(x, "read") for x in lay]),
        "wait_less_read_us": stats([x["host_wait_us_per_step"] - span(x, "read") for x in lay]),
    }
    between = [x.get("idle_between_ops_share") for x in lay]
    between = [b for b in between if isinstance(b, dict)]
    fast = max(runs, key=lambda r: r["steps_per_sec"])
    slow = min(runs, key=lambda r: r["steps_per_sec"])
    fl, sl = fast["layers"], slow["layers"]
    diff = {k: span(sl, k) - span(fl, k) for k in keys}
    for k in ("host_cpu_us_per_step", "host_wait_us_per_step"):
        diff[k] = sl[k] - fl[k]
    fast_leaves, slow_leaves = leaves(fl), leaves(sl)
    leaf_diff = {k: slow_leaves[k] - fast_leaves.get(k, 0.0) for k in slow_leaves}
    step_diff = span(sl, "step") - span(fl, "step")
    order = sorted(leaf_diff, key=lambda k: -abs(leaf_diff[k]))
    return {
        "runs": len(runs), "cards": sorted({r["card"] for r in runs}),
        "all_correct": all(r["correct"] for r in runs),
        "steps_per_sec": stats([r["steps_per_sec"] for r in runs]),
        "us_per_step": us,
        "calls_per_step": lay[0]["host_span_calls_per_step"],
        "device_allocs_per_step": stats([x["device_allocs_per_step"] for x in lay]),
        "device_frees_per_step": stats([x["device_frees_per_step"] for x in lay]),
        "alloc_retries": stats([x["alloc_retries"] for x in lay]),
        "idle_between_ops_share": {k: stats([b[k] for b in between])
                                   for k in ("spans", "host_ops_alone")} if between
        else "not measured",
        "agreement": agree,
        "fast_against_slow": {
            "fast": {"file": fast["file"], "steps_per_sec": fast["steps_per_sec"],
                     "device_allocs_per_step": fl["device_allocs_per_step"]},
            "slow": {"file": slow["file"], "steps_per_sec": slow["steps_per_sec"],
                     "device_allocs_per_step": sl["device_allocs_per_step"]},
            "step_us_slow_less_fast": step_diff,
            "by_span_us_slow_less_fast": diff,
            "by_leaf_us_slow_less_fast": {k: leaf_diff[k] for k in order},
            "share_of_step_difference": {k: leaf_diff[k] / step_diff for k in order}
            if step_diff else None},
    }


# The kernel ids whose launch functions run inside ``gates`` and ``refresh``
# (bench.OUTSIDE_PATH); every other id's run inside ``path``.
IN_GATES, IN_REFRESH = ("SG", "G"), ("R",)


def leaves(lay: dict) -> dict:
    """A run's step as spans that do not overlap and add up to ``step``:
    ``gates`` and ``refresh`` less their launch functions (``gates_own``,
    ``refresh_own``), ``read``, ``decide``, ``world``, ``step_other`` and
    every ``<id>.prep`` / ``<id>.call``."""
    us = lay["host_span_us_per_step"]
    wrappers = {k: v for k, v in us.items() if k.endswith((".prep", ".call"))}

    def inside(ids):
        return sum(v for k, v in wrappers.items() if k.split(".")[0] in ids)

    return {"gates_own": us["gates"] - inside(IN_GATES), "read": us["read"],
            "refresh_own": us["refresh"] - inside(IN_REFRESH), "decide": us["decide"],
            "world": us["world"], "step_other": us["step_other"], **wrappers}


def table(name: str, s: dict) -> str:
    rows = [f"{name}: {s['runs']} runs on {s['cards']}, steps/s {s['steps_per_sec']}"]
    fs = s["fast_against_slow"]["by_span_us_slow_less_fast"]
    for k, v in s["us_per_step"].items():
        if isinstance(v, dict):
            rows.append(f"  {k:24s} {v['median']:10.2f} [{v['min']:9.2f}, {v['max']:9.2f}]"
                        f"  slow-fast {fs.get(k, float('nan')):9.2f}")
    share = s["fast_against_slow"]["share_of_step_difference"] or {}
    rows.append("  slow-fast by leaf, share of step's: " + ", ".join(
        f"{k} {v:.2f}" for k, v in list(share.items())[:6]))
    return "\n".join(rows)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="+")
    args = parser.parse_args(argv)
    found = runs_by_regime(args.dirs)
    if not found:
        print("host_split: no bench line with host spans found", file=sys.stderr)
        return 1
    out = {name: summary(runs) for name, runs in found.items()}
    for name, s in out.items():
        print(table(name, s))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
