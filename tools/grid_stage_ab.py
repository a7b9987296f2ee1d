"""The grid step's stage kernels in one tree: ptxas usage and times, on the card.

    python tools/grid_stage_ab.py [--root DIR] [--steps N]

Builds the tree's kernels, prints the registers and spill bytes that ptxas
gave every stage kernel (``k_grid_*``, and ``k_step_gates`` /
``k_ballistic_step`` where the tree has them), steps Stress4096 ``N`` steps
(default 2800, the state ``chip_smoke.py`` phase 20 times at) and times each
grid stage kernel at the next step as phase 20 does
(``chip_smoke.one_kernel_times``: CUDA-event ms a call over 100 calls back
to back, and the kernel's own us a call in a trace).  The last line is one
JSON object.  ``--root``: the tree whose package and ``chip_smoke.py`` are
imported (default: the tree this file lies in), e.g. an unpacked older
commit; run two trees in turns in one call (parent, change, change, parent)
to compare them on one card.
"""

import argparse
import json
import os
import sys

STAGES = (("grid_gates", "gates"), ("grid_predict", "predict"), ("grid_finalize", "finalize"))


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--steps", type=int, default=2800)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs
    from avbd3d_tpu_torch import kernels, load_scene, solver, solver_grid

    if not torch.cuda.is_available():
        print("grid_stage_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = cs.card_line()
    lib = kernels.build()
    usage = {k: v for k, v in kernels.ptxas_usage(lib.log).items()
             if k.startswith(("k_grid_", "k_step_gates", "k_ballistic_step"))}
    for name, u in sorted(usage.items()):
        print(f"ptxas {name}: {u['registers']} registers, {u['spill_bytes']} spill bytes")
    sc = load_scene("Stress4096", device="cuda")
    w = solver.run_steps(sc.world, sc.params, sc.cap, args.steps)
    a = cs.stage_args(w, sc.params, sc.cap)
    times = {}
    for name, key in STAGES:
        kern, plain = getattr(solver_grid, name), getattr(solver_grid, name + "_plain")
        times[name] = cs.one_kernel_times(
            card, f"{name} (Stress4096 step {args.steps})", cs.STAGE_KERNELS[name],
            lambda kern=kern, key=key: kern(*a[key]), lambda plain=plain, key=key: plain(*a[key]))
    print(json.dumps({"tree": root, "card": card, "steps": args.steps, "ptxas": usage,
                      "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
