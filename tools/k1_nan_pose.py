"""K1 against its plain version at a NaN pose, on the card, in one tree.

    python tools/k1_nan_pose.py [--root DIR]

Steps Stress1000 700 steps, sets one dynamic body's ``pos.y`` and then its
``pos.x`` to NaN, and runs the step kernel (K1) and ``step_kernel_plain``
on the same card tensors (operands from ``chip_smoke.k1_inputs``); prints,
for each cache leaf that differs, the count of differing entries and the
first bodies among them, each body output's largest difference and NaN
count, and both diagnostics rows.  ``--root``: the tree whose package and
``chip_smoke.py`` are imported (default: the tree this file lies in), e.g.
an archive of an earlier commit, to tell whether a difference is older
than a change (ROADMAP.md Queue 3).
"""

import argparse
import os
import sys


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    import chip_smoke as cs
    from avbd3d_tpu_torch import kernels, load_scene, solver, solver_cuda

    if not torch.cuda.is_available():
        print("k1_nan_pose: CUDA is not available", file=sys.stderr)
        return 2
    kernels.build()
    print(f"{cs.card_line()}; tree {os.path.abspath(args.root)}")
    sc = load_scene("Stress1000", device="cuda")
    w = solver.run_steps(sc.world, sc.params, sc.cap, 700)
    b = w.bodies
    i = int(torch.nonzero((b.inv_mass > 0).reshape(-1)).flatten()[7])
    for label, comp in (("pos.y", 1), ("pos.x", 0)):
        pos = b.pos.clone()
        pos.view(3, -1)[comp, i] = float("nan")
        a = cs.k1_inputs(w.replace(bodies=b.replace(pos=pos)), sc)
        cp, bp_, dp, _ = solver_cuda.step_kernel_plain(*a)
        ck, bk, dk, _ = solver_cuda.step_kernel(*a)
        torch.cuda.synchronize()
        print(f"NaN {label} at body {i}:")
        for f in solver_cuda.CACHE_FIELDS:
            x, y = getattr(cp, f), getattr(ck, f)
            same = x == y
            if x.dtype.is_floating_point:
                same |= torch.isnan(x) & torch.isnan(y)
            n = int((~same).sum())
            if n:
                flat = (~same).reshape(-1, b.n)
                bodies = sorted({int(k) for k in torch.nonzero(flat)[:200, 1]})[:12]
                print(f"  cache.{f}: {n} entries differ, bodies {bodies}")
        for k, (x, y) in enumerate(zip(bp_, bk)):
            print(f"  body output {k}: largest difference {cs.float_diff(x, y):.3e}, NaN "
                  f"plain {int(torch.isnan(x).sum())} kernel {int(torch.isnan(y).sum())}")
        print(f"  diag row 0 plain  {dp[0, :16].tolist()}\n  diag row 0 kernel {dk[0, :16].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
