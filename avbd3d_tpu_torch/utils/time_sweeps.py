"""Times of the sweep, collide, control-lanes and probe kernels (K1-K7) of
one source tree, on the card.

    python avbd3d_tpu_torch/utils/time_sweeps.py [--root DIR] [--routes]

Run by path, not with ``-m``: the package and ``chip_smoke.py`` (for its
operand helpers) are imported from ``--root`` (default: the tree this file
lies in), so one call can time two trees in turns, e.g. an archive of an
earlier commit unpacked beside the working tree.  CUDA-event means over 20
launches, the card's name and power limit beside them, one JSON line last:

  k1_settled_ms   K1, Stress1000 after 700 steps, 20 sweeps
  k1_2048_ms      K1, Stress2048 after 600 steps
  k1_sheets_ms    K1's joint branch, 20 SoftGrid sheets after 300 steps
  k4_ms           K4 at the settled Stress1000 state, iterations 20 / 5 / 1
  k6_ms           K6, one launch of 4 iterations, Stress4096 after 1000 steps
  traced          per call, as CUDA-event time (``ms``) and as the kernels'
                  own time in a trace of 20 calls (``device_us``, and
                  ``kernels`` / ``launches``: us and launches per call by
                  kernel name) for K1's joint
                  branch at RodJointed (step 30), SoftGrid (step 5) and the
                  20 sheets (step 300), K5 at settled Stress4096, and K3 and
                  K1 contact-only at settled Stress1000; over 100 calls, K2
                  at Stress1000's initial (rain-in) and settled states and
                  Stress2048's initial state, and K7 at settled Stress1000
                  and settled Stress4096; a refresh of the lists
                  (``build_bp_cache``) and the grid step's refresh predicate
                  (``refresh_needed``) at settled Stress1000, Stress2048
                  (step 600) and Stress4096, each also with every kernel of
                  the trace, the torch operations' too (``all_us``,
                  ``all_launches``): the torch version in a tree before the
                  refresh kernels
  k2_lanes_differ K2 against its plain version at those three states: the
                  lanes whose bits differ (lane 3, the deviation from the
                  mean displacement, sums over the world in another order)

``--routes`` (a tree whose launch functions take a sweep plan, and whose K1
takes the cache's bool latches) also times K1 at Stress1000 and at Stack
(N = 128) and K6 at Stress4096 with the plan
forced to each route at tiles of 32 and 64 bodies (K1 also as the summed
device time of its kernels in a trace of the same calls), beside the route
``sweep_plan`` chooses; K1's joint branch at the 20 sheets (step 300),
RodJointed (step 30) and SoftGrid (step 5) on each barrier (one cluster,
or a cooperative launch with a grid barrier) and tile (32 or 16 bodies)
that fits, twice in turns; and the settled steps/s of Stress1000 (150 steps) and Stress4096
(50 steps) with every step on each route, six times in turns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    parser.add_argument("--routes", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    import chip_smoke as cs
    from avbd3d_tpu_torch import kernels, load_scene, solver, solver_cuda, solver_grid
    from torch.autograd import DeviceType

    from avbd3d_tpu_torch.ops.broadphase import build_bp_cache, refresh_needed
    from avbd3d_tpu_torch.utils import profile_phases

    if not torch.cuda.is_available():
        print("time_sweeps: CUDA is not available", file=sys.stderr)
        return 2
    kernels.build()
    out = {"root": os.path.abspath(args.root), "card": cs.card_line(), "traced": {}}

    def traced(label, call, reps=20):
        """``call`` timed with CUDA events, then traced: the kernels' own
        time per call, in sum and by name."""
        ms = cs.event_ms(call, reps)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        by_name, counts, all_us, all_launches = {}, {}, 0.0, 0.0
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA and profile_phases.device_time_us(e) > 0.0
                    and not e.key.startswith(("Memcpy", "Memset"))):
                all_us += profile_phases.device_time_us(e) / reps
                all_launches += e.count / reps
            if cs.own_kernel(e.key):
                # "void k_x<512, true>(...)" for a template
                name = e.key.split("(")[0].removeprefix("void ")
                by_name[name] = by_name.get(name, 0.0) + profile_phases.device_time_us(e) / reps
                counts[name] = counts.get(name, 0) + e.count / reps
        out["traced"][label] = {"ms": ms, "device_us": sum(by_name.values()),
                                "kernels": by_name, "launches": counts, "all_us": all_us,
                                "all_launches": all_launches}

    def with_cache(world, scene):
        """``world`` with fresh candidate lists (an initial state's)."""
        return world.replace(bp=build_bp_cache(world.bodies, world.exclusions,
                                               scene.cap.max_degree, scene.params.bp_margin))

    def lanes(label, world, params):
        """K2 at ``world``: timed and traced over 100 calls, and the lanes
        whose bits differ from the plain version's."""
        b, bp = world.bodies, world.bp
        args = (bp.nb, b, bp.anchor, bp.anchor_quat, params)
        traced(f"K2, {label}", lambda: solver_cuda.control_lanes(*args), 100)
        got, want = solver_cuda.control_lanes(*args), solver_cuda.control_lanes_plain(*args)
        differ = (got.view(torch.int32) != want.view(torch.int32)).nonzero().flatten()
        out.setdefault("k2_lanes_differ", {})[label] = differ.tolist()

    def refresh(label, world, scene):
        """A refresh of ``world``'s lists and the grid step's predicate on
        its cached lists, each timed and traced over 20 calls."""
        b, pr, ex = world.bodies, scene.params, world.exclusions
        traced(f"refresh lists, {label}",
               lambda: build_bp_cache(b, ex, scene.cap.max_degree, pr.bp_margin))
        traced(f"refresh predicate, {label}", lambda: refresh_needed(world.bp, b, pr.bp_margin))

    def probe(label, world, params):
        traced(f"K7, {label}", lambda: solver_cuda.bp_probe(world.bp.nb, world.bodies, params),
               100)

    sc = load_scene("Stress1000", device="cuda")
    p = sc.params
    lanes("Stress1000 initial", with_cache(sc.world, sc), p)
    w = solver.run_steps(sc.world, p, sc.cap, 700)
    lanes("Stress1000 settled", w, p)
    probe("Stress1000 settled", w, p)
    refresh("Stress1000 settled", w, sc)
    a1 = cs.k1_inputs(w, sc)
    out["k1_settled_ms"] = cs.event_ms(lambda: solver_cuda.step_kernel(*a1), 20)
    traced("K1 contact-only, settled Stress1000", lambda: solver_cuda.step_kernel(*a1))
    a3c = (w.contacts, w.bp.nb, w.bp.key, w.bp.thr, w.bodies, p)
    traced("K3, settled Stress1000", lambda: solver_cuda.collide_and_init(*a3c))
    contacts = solver_cuda.collide_and_init(w.contacts, w.bp.nb, w.bp.key, w.bp.thr, w.bodies, p)[0]
    out["k4_ms"] = {}
    for its in (20, 5, 1):
        pi = p.replace(iterations=its)
        out["k4_ms"][str(its)] = cs.event_ms(
            lambda: solver_cuda.solve_loop(contacts, w.bodies, pi), 20)

    s2 = load_scene("Stress2048", device="cuda")
    lanes("Stress2048 initial", with_cache(s2.world, s2), s2.params)
    w2 = solver.run_steps(s2.world, s2.params, s2.cap, 600)
    refresh("Stress2048 step 600", w2, s2)
    a2 = cs.k1_inputs(w2, s2)
    out["k1_2048_ms"] = cs.event_ms(lambda: solver_cuda.step_kernel(*a2), 20)

    ws, ps, caps, _ = cs.sheets_world()
    ws = solver.run_steps(ws, ps, caps, 300)
    a3 = cs.k1_inputs(ws, types.SimpleNamespace(params=ps, cap=caps))
    out["k1_sheets_ms"] = cs.event_ms(lambda: solver_cuda.step_kernel(*a3), 20)
    traced("K1 joint branch, 20 sheets", lambda: solver_cuda.step_kernel(*a3))
    for name, steps in (("RodJointed", 30), ("SoftGrid", 5)):
        sj = load_scene(name, device="cuda")
        aj = cs.k1_inputs(solver.run_steps(sj.world, sj.params, sj.cap, steps), sj)
        traced(f"K1 joint branch, {name}", lambda: solver_cuda.step_kernel(*aj))

    s4 = load_scene("Stress4096", device="cuda")
    w4 = solver.run_steps(s4.world, s4.params, s4.cap, 1000)
    probe("Stress4096 settled", w4, s4.params)
    refresh("Stress4096 settled", w4, s4)
    wi = cs.grid_inputs(w4, s4)
    a5 = cs.k5_args(wi, s4)
    traced("K5, settled Stress4096", lambda: solver_grid.collide_grid(*a5))
    a6 = cs.k6_args(wi, s4, solver_grid.collide_grid(*a5)[0])
    out["k6_ms"] = cs.event_ms(lambda: solver_grid.iterblock_grid(*a6), 20)

    if args.routes:
        import time

        def forced(tile, dc, blk=0):
            """The plan of ``tile`` bodies a block, one launch per half-sweep
            (``blk`` 0) or clusters covering logical blocks of ``blk``."""
            threads, spt, smem = solver_cuda._tile_shape(tile, dc)
            return solver_cuda.SweepPlan(tile, threads, spt, smem, blk // tile)

        def k1_routes(a, blk):
            old, nb, key, thr, b, anchor, anchor_q, pk, n_main, k, cand = a[:11]
            cache_args = solver_cuda.cache_leaves(old)
            dc = old.other.shape[0]
            res = {"chosen": repr(solver_cuda.sweep_plan(b.n, dc))}
            plans = [forced(32, dc), forced(64, dc)]
            plans += [forced(t, dc, blk) for t in (32, 64) if blk // t <= solver_cuda.MAX_CLUSTER]
            for plan in plans:
                def call():
                    return kernels.launch_step(cache_args, nb, key, thr, b, anchor, anchor_q, pk,
                                               n_main, k, cand, plan=plan)
                name = f"{plan.route}_tile{plan.tile}"
                res[name] = cs.event_ms(call, 20)
                # The same calls traced: the kernels' own time on the card,
                # which the host's pace between launches does not enter.
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        call()
                    torch.cuda.synchronize()
                res[name + "_device_us"] = sum(
                    profile_phases.device_time_us(e) for e in prof.key_averages()
                    if cs.own_kernel(e.key)) / 20
            return res

        def joint_routes(a):
            """K1's joint branch with its resident launch on each barrier and
            tile that fits: one cluster, or a cooperative launch of 32- or
            16-body tiles; CUDA-event ms and the kernels' own us per call."""
            old, nb, key, thr, b, anchor, anchor_q, pk, n_main, k, cand, j, sp, ncol = a
            cache_args = solver_cuda.cache_leaves(old)
            dc = old.other.shape[0]
            dj, ds = (j.dj if j is not None else 0), (sp.ds if sp is not None else 0)
            res = {"chosen": repr(solver_cuda.sweep_plan(b.n, dc, None, dj, ds))}
            plans = []
            for tile in (32, 16):
                threads, spt, smem = solver_cuda._tile_shape(tile, dc, dj + ds)
                if b.n // tile <= solver_cuda.MAX_CLUSTER:
                    plans.append(solver_cuda.SweepPlan(tile, threads, spt, smem, b.n // tile))
                if b.n // tile <= solver_cuda.H100_SMS:
                    plans.append(solver_cuda.SweepPlan(tile, threads, spt, smem, 0, 1))
            for rep in range(2):
                for plan in plans:
                    def call():
                        return kernels.launch_step(cache_args, nb, key, thr, b, anchor, anchor_q, pk,
                                                   n_main, k, cand, j, sp, ncol, plan=plan)
                    name = f"{plan.route}_tile{plan.tile}_threads{plan.threads}"
                    res.setdefault(name, []).append(cs.event_ms(call, 20))
                    with torch.profiler.profile(
                            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                        for _ in range(20):
                            call()
                        torch.cuda.synchronize()
                    res.setdefault(name + "_device_us", []).append(sum(
                        profile_phases.device_time_us(e) for e in prof.key_averages()
                        if cs.own_kernel(e.key)) / 20)
            return res

        routes = {"k1_settled": k1_routes(a1, 1024)}
        routes["k1_joint_sheets"] = joint_routes(a3)
        for name, steps in (("RodJointed", 30), ("SoftGrid", 5)):
            sj = load_scene(name, device="cuda")
            routes[f"k1_joint_{name}"] = joint_routes(
                cs.k1_inputs(solver.run_steps(sj.world, sj.params, sj.cap, steps), sj))
        s5 = load_scene("Stack", device="cuda")
        w5 = solver.run_steps(s5.world, s5.params, s5.cap, 100)
        routes["k1_stack"] = k1_routes(cs.k1_inputs(w5, s5), 128)

        pg, gb, spec, c6, b6, pos, quat, lam, pen, stickf, ip, iq = a6
        dc6 = c6.other.shape[0]
        routes["k6"] = {"chosen": repr(solver_cuda.sweep_plan(b6.n, dc6, gb * 128))}
        for plan in (forced(32, dc6), forced(64, dc6), forced(64, dc6, gb * 128)):
            routes["k6"][f"{plan.route}_tile{plan.tile}"] = cs.event_ms(
                lambda: kernels.launch_iterblock_grid(c6, b6, pos, quat, lam, pen, stickf, ip, iq,
                                                      pg, gb * 128, spec, plan=plan), 20)

        # End to end: every step of a settled block on one route.
        chooser = solver_cuda.sweep_plan

        def steps_per_s(world, scene, n_steps, plan):
            solver_cuda.sweep_plan = (lambda *a, **k: plan) if plan else chooser
            try:
                solver.run_steps(world, scene.params, scene.cap, 5)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solver.run_steps(world, scene.params, scene.cap, n_steps)
                torch.cuda.synchronize()
                return n_steps / (time.perf_counter() - t0)
            finally:
                solver_cuda.sweep_plan = chooser

        e2e = {"Stress1000": {}, "Stress4096": {}}
        for rep in range(6):
            order = (("launches_tile32", 32, 0), ("cluster_tile64", 64, 1024))
            for name, tile, blk in order if rep % 2 == 0 else order[::-1]:
                e2e["Stress1000"].setdefault(name, []).append(
                    steps_per_s(w, sc, 150, forced(tile, 12, blk)))
                e2e["Stress4096"].setdefault(name, []).append(
                    steps_per_s(w4, s4, 50, forced(tile, 16, blk)))
        routes["steps_per_s"] = e2e
        out["routes"] = routes
    torch.cuda.synchronize()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
