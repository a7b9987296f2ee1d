"""Where a stage kernel's time goes: globaltimer stamps a block, on the card.

    python tools/stage_stamps.py [--root DIR] [--steps N] [--reps R]

Copies the tree's ``csrc/`` into its ``_build/stamps_csrc/``, writes stamps
into the copy of ``k_grid_predict`` and ``k_ballistic_step`` (a thread of
each block reads ``%globaltimer`` into a device array where a phase of the
block ends), builds that copy as a library of its own (``kernels.build``
with the define ``AVBD_STAMPED``; the main build is untouched) and launches
each kernel through it ``R`` times, the stamps cleared before each launch:
``k_grid_predict`` at Stress4096 step ``N`` (default 2800, as
``chip_smoke.py`` phase 20 times it), ``k_ballistic_step`` at Stress1000 and
Stress2048 step 1 (as phase 21 and ``tools/grid_stage_ab.py`` time it).  It
prints, as medians over the launches of times from the launch's first
block start, in us, when the last block started and when the latest block
passed each stamp (``LAYOUTS`` names them: for the kernels' earlier layout,
a thread a body and a thread a latch or slot with a ticket fold, the latch
copy, the body chain, the slot loop and the last block's tail; for the
layout of latch or slot warps beside a linear and an angular body warp with
``atomic_fold``, the end of each kind of warp's loop, the block barrier
and the ticket of the fold and the last block's tail), beside each
kernel's own time in a trace through the stamped build and the main build
(the stamps' cost).  A tree whose code fits neither layout is refused with
the missing lines named.  The last line is one JSON object.
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import sys

STAMP_BLOCKS = 4096
STAMPS = 8  # stamps a block

HEADER = """
// globaltimer stamps (tools/stage_stamps.py): STAMPS a block.
static __device__ unsigned long long g_stamps[%d * %d];
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_AT(cond, k)                                                   \\
  do {                                                                      \\
    if ((cond) && blockIdx.x < %d) g_stamps[blockIdx.x * %d + (k)] = stamp_now(); \\
  } while (0)
#define STAMP(k) STAMP_AT(threadIdx.x == 0, k)
""" % (STAMP_BLOCKS, STAMPS, STAMP_BLOCKS, STAMPS)

READER = """
extern "C" int avbd_stamps_%s(void* dst, int clear) {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_stamps);
  if (e == cudaSuccess && dst != nullptr)
    e = cudaMemcpy(dst, p, sizeof(g_stamps), cudaMemcpyDeviceToHost);
  if (e == cudaSuccess && clear) e = cudaMemset(p, 0, sizeof(g_stamps));
  return (int)e;
}
"""

COMMON = ("avbd_common.cuh", [("#define FULL_MASK 0xffffffffu\n", HEADER)])
READERS = [("grid_stages.cu", [('}  // extern "C"\n', READER % "grid")]),
           ("fused_stages.cu", [('}  // extern "C"\n', READER % "fused")])]

# The stamps by layout: (file, [(anchor, text inserted after it)]), and
# what each stamp of a block marks.  "ticket": a thread a body and a thread
# a latch or slot, a last block walking the partials (the kernels before
# their redesign): 0 the block's start, 1 the end of the latch copy (PR) or
# of the body threads' chain (BS) over the block, 2 the end of the body
# chain (PR) or of the slot loop (BS), 3 the last block's tail.  "atomic":
# latch or slot warps beside a linear and an angular body warp, the lanes
# by atomic_fold or atomic_count: 0 the block's start, 1 the end of warp
# 0's latch or slot loop, 2 / 3 the end of the linear / angular warp's
# loop, 5 warp 0 past the fold's block barrier, 6 its ticket back, 4 the
# last block's total in hand.
LAYOUTS = {
    "ticket": {
        "patches": [COMMON] + [
            ("grid_stages.cu", [
                ("k_grid_predict(PredictArgs a, KParams p) {\n  __shared__ int sh[STAGE_WARPS];\n"
                 "  __shared__ bool sh_last;\n", "  STAMP(0);\n"),
                ("  if (t < a.planes * a.n) a.stickf[t] = a.stick[t] ? F(1.0) : F(0.0);\n",
                 "  __syncthreads();\n  STAMP(1);\n"),
                ("  if (lane == 0) sh[warp] = san;\n  __syncthreads();\n", "  STAMP(2);\n"),
                ("      *a.san_out = s;\n", "      STAMP(3);\n")]),
            ("fused_stages.cu", [
                ("  __shared__ bool sh_last;\n  const int n = a.n;\n", "  STAMP(0);\n"),
                ("    st3(a.prev_av_out, i, n, dyn ? r.av : ld3(a.prev_av, i, n));\n  }\n",
                 "  __syncthreads();\n  STAMP(1);\n"),
                ("      fv[4] = max_nan(fv[4], ok ? fabsf(a.lam[3 * s * plane + t]) : F(0.0));\n"
                 "    }\n  }\n", "  __syncthreads();\n  STAMP(2);\n"),
                ("    float* dg = a.diag;\n", "    STAMP(3);\n")])] + READERS,
        "names": {"k_grid_predict": {1: "latch copy end", 2: "body chain end", 3: "tail end"},
                  "k_ballistic_step": {1: "body chain end", 2: "slot loop end",
                                       3: "tail end"}},
    },
    "atomic": {
        "patches": [(COMMON[0], COMMON[1] + [
            ("  if (lane < NQ) shk[lane][warp] = mine;\n  __syncthreads();\n"
             "  if (warp != 0) return false;\n", "  STAMP(5);\n"),
            ("    last = atomic_add_acq_rel(fold + NQ, 1u) == gridDim.x - 1 ? 1u : 0u;\n  }\n",
             "  STAMP(6);\n"),
            ("  if (threadIdx.x != 0) return false;\n  unsigned int b = 0;\n", "  STAMP(5);\n"),
            ("  const unsigned long long old = "
             "atomicAdd(word, ((unsigned long long)b << 32) | 1ull);\n",
             "  STAMP(6);\n")])] + [
            ("grid_stages.cu", [
                ("k_grid_predict(PredictArgs a, KParams p) {\n"
                 "  __shared__ unsigned int shc[PRED_WARPS];\n", "  STAMP(0);\n"),
                ("      a.stickf[t] = a.stick[t] ? F(1.0) : F(0.0);\n", "    STAMP(1);\n"),
                ("  int total;\n",
                 "  STAMP_AT(threadIdx.x == 32 * PRED_LATCH_WARPS, 2);\n"
                 "  STAMP_AT(threadIdx.x == 32 * PRED_LATCH_WARPS + 32, 3);\n"),
                ("  if (!atomic_count(san, shc, a.fold, &total)) return;\n", "  STAMP(4);\n")]),
            ("fused_stages.cu", [
                ("k_ballistic_step(BallisticArgs a, KParams p) {\n"
                 "  __shared__ unsigned int shk[BAL_F + BAL_I][BAL_WARPS];\n", "  STAMP(0);\n"),
                ("        fv[4] = max_nan(fv[4], ok ? fabsf(a.lam[3 * s * plane + t]) : F(0.0));\n"
                 "      }\n    }\n", "    STAMP(1);\n"),
                ("  unsigned int q[BAL_F + BAL_I];\n",
                 "  STAMP_AT(threadIdx.x == 32 * BAL_SLOT_WARPS, 2);\n"
                 "  STAMP_AT(threadIdx.x == 32 * BAL_SLOT_WARPS + 32, 3);\n"),
                ("  if (!atomic_fold<BAL_F>(q, shk, a.fold, &w)) return;\n",
                 "  STAMP(4);\n")])] + READERS,
        "names": {k: {1: "latch copy end" if k == "k_grid_predict" else "slot loop end",
                      2: "linear warps end", 3: "angular warps end",
                      5: "block barriers passed", 6: "tickets back", 4: "tail end"}
                  for k in ("k_grid_predict", "k_ballistic_step")},
    },
}


def patched_csrc(kernels) -> tuple:
    """A copy of the tree's csrc/ with the stamps of the layout whose lines
    it holds written in, and that layout's name; SystemExit naming a line
    missing from each layout."""
    dst = os.path.join(kernels._BUILD, "stamps_csrc")
    missing = {}
    for layout, spec in LAYOUTS.items():
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(kernels._CSRC, dst)
        for name, patches in spec["patches"]:
            path = os.path.join(dst, name)
            with open(path) as f:
                src = f.read()
            for anchor, text in patches:
                if src.count(anchor) != 1:
                    missing[layout] = f"{name}: {anchor!r}"
                    break
                src = src.replace(anchor, anchor + text)
            if layout in missing:
                break
            with open(path, "w") as f:
                f.write(src)
        if layout not in missing:
            return dst, layout
    raise SystemExit(f"stage_stamps: the tree's code fits no layout: {missing}")


def stamped(lib, which: str, call, blocks: int, reps: int):
    """``call`` (one launch) ``reps`` times through ``lib``, the stamps
    cleared before each: a list of (blocks, STAMPS) stamp rows in ns, 0
    where a block wrote none."""
    import numpy as np
    import torch

    from avbd3d_tpu_torch import kernels

    read = getattr(lib.cdll, f"avbd_stamps_{which}")
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    buf = np.zeros(STAMP_BLOCKS * STAMPS, dtype=np.uint64)
    out = []
    with kernels.using(lib):
        for r in range(reps + 3):
            torch.cuda.synchronize()
            if read(None, 1) != 0:
                raise SystemExit("stage_stamps: clearing the stamps failed")
            call()
            torch.cuda.synchronize()
            if read(buf.ctypes.data, 0) != 0:
                raise SystemExit("stage_stamps: reading the stamps failed")
            if r >= 3:
                out.append(buf.reshape(-1, STAMPS)[:blocks].astype(np.int64).copy())
    return out


def phases(rows, names: dict) -> dict:
    """Medians over the launches, in us from each launch's first block
    start: the last block start, and for each stamp k of ``names`` the
    latest block's stamp k (blocks that wrote none left out)."""
    got = {"last block start": []}
    for name in names.values():
        got[name] = []
    for s in rows:
        s = s[s[:, 0] > 0]  # the launch's blocks
        t0 = s[:, 0].min()
        got["last block start"].append(s[:, 0].max() - t0)
        for k, name in names.items():
            col = s[:, k][s[:, k] > 0]
            got[name].append((col.max() - t0) if len(col) else -1)
    return {k: statistics.median(v) / 1e3 for k, v in got.items()}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--steps", type=int, default=2800)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs
    from avbd3d_tpu_torch import kernels, load_scene, solver

    if not torch.cuda.is_available():
        print("stage_stamps: CUDA is not available", file=sys.stderr)
        return 2
    card = cs.card_line()
    main_lib = kernels.build()
    kernels._CSRC, layout = patched_csrc(kernels)
    lib = kernels.build(defines=("AVBD_STAMPED=1",))
    names = LAYOUTS[layout]["names"]
    out = {}
    sc = load_scene("Stress4096", device="cuda")
    w = solver.run_steps(sc.world, sc.params, sc.cap, args.steps)
    a = cs.stage_args(w, sc.params, sc.cap)
    b, stick, _p = a["predict"]
    planes = stick.shape[0] * stick.shape[1]
    cases = [("k_grid_predict", f"Stress4096 step {args.steps}", "grid",
              lambda: kernels.launch_grid_predict(*a["predict"]))]
    for name in ("Stress1000", "Stress2048"):
        s = load_scene(name, device="cuda")
        rain = solver.run_steps(s.world, s.params, s.cap, 1)
        wp, _vec = solver.step_gates_plain(rain, s.params)
        dc = wp.contacts.other.shape[0]
        cases.append(("k_ballistic_step", f"{name} step 1", "fused",
                      lambda wp=wp, p=s.params: kernels.launch_ballistic_step(
                          wp.bodies, wp.contacts, p)))
    for kernel, where, which, call in cases:
        ph = phases(stamped(lib, which, call, STAMP_BLOCKS, args.reps), names[kernel])
        with kernels.using(lib):
            t_st = cs.one_kernel_times(card, f"{kernel} stamped ({where})", kernel, call,
                                       lambda: None)
        with kernels.using(main_lib):
            t_main = cs.one_kernel_times(card, f"{kernel} ({where})", kernel, call, lambda: None)
        ph["stamped us"], ph["main build us"] = t_st["device_us"], t_main["device_us"]
        print(f"[{card}] {kernel} ({where}), medians of {args.reps} launches, us from the first "
              "block start: " + ", ".join(f"{k} {v:.3f}" for k, v in ph.items()))
        out[f"{kernel} {where}"] = ph
    print(json.dumps({"tree": root, "card": card, "layout": layout, "stamps": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
