"""Contact-cache width compaction (``Capacity.cache_degree``) in the port.

The port of the reference's tests/test_cache_compaction.py.  K1's filter
kernel culls the D candidate slots to the cache's DC by the 6-face-axis test
and packs the kept ones in candidate order (csrc/step_kernel.cu
``k_filter_cull``, one warp per body: a kept slot lands at the count of
kept slots before it).  Because the cull keeps candidate order and removes
only slots whose face-axis separation proves the SAT must fail, and padded
slots add exact zeros to every masked sum, a culled run that does not
overflow equals the full-width run bit for bit; and a cache too narrow for
a body's manifolds counts what it drops.  Here on the CPU with the plain
versions; ``tests/test_torch_port.py`` runs the same two checks through the
kernels on the card.
"""

import numpy as np
import torch

from avbd3d_tpu_torch import SceneBuilder, solver
from avbd3d_tpu_torch.config import SolverParams
from avbd3d_tpu_torch.convert import world_from_arrays

torch.set_num_threads(1)


def pile(cache_degree, device):
    """The reference test's 30-cube pile in three layers on a slab, D = 16."""
    sb = SceneBuilder()
    sb.add_body((40, 1, 40), 0.0, 0.5, (0, -0.5, 0))
    rng = np.random.default_rng(3)
    for i in range(30):
        x, z = divmod(i, 6)
        sb.add_body((1, 1, 1), 1.0, 0.5,
                    (1.05 * x - 2.0 + 0.02 * float(rng.standard_normal()),
                     0.55 + 1.05 * (i % 3),
                     1.05 * z - 3.0 + 0.02 * float(rng.standard_normal())))
    arrays, p, cap, _ = sb.build(SolverParams(), max_degree=16, cache_degree=cache_degree)
    return world_from_arrays(arrays, device), p, cap


def check_culled_equals_full_width(device):
    """50 steps at the full width (cache_degree 0: DC = D = 16, no cull) and
    at DC = 12: no degree overflow, equal counts, poses bit for bit."""
    w0, p, c0 = pile(0, device)
    w1, _, c1 = pile(12, device)
    assert (w0.contacts.other.shape[0], w1.contacts.other.shape[0]) == (16, 12)
    for _ in range(50):
        w0 = solver.step(w0, p, c0)
        w1 = solver.step(w1, p, c1)
    d0, d1 = w0.diagnostics.as_dict(), w1.diagnostics.as_dict()
    assert d1["degree_overflow"] == 0.0
    assert d0["active_contacts"] == d1["active_contacts"] > 0
    assert d0["active_manifolds"] == d1["active_manifolds"]
    assert torch.equal(w0.bodies.pos, w1.bodies.pos)
    assert torch.equal(w0.bodies.quat, w1.bodies.quat)


def check_overflow_counted(device):
    """A cache of width 1 under a 3-high stack: the middle cube carries two
    manifolds, so one is dropped and counted in ``degree_overflow``; the
    run stays finite and sanitizes nothing."""
    sb = SceneBuilder()
    sb.add_body((40, 1, 40), 0.0, 0.5, (0, -0.5, 0))
    for k in range(3):
        sb.add_body((1, 1, 1), 1.0, 0.5, (0.0, 0.55 + 1.02 * k, 0.0))
    arrays, p, c, _ = sb.build(SolverParams(), max_degree=8, cache_degree=1)
    w = world_from_arrays(arrays, device)
    worst = 0.0
    for _ in range(40):
        w = solver.step(w, p, c)
        worst = max(worst, w.diagnostics.as_dict()["degree_overflow"])
    assert worst > 0
    assert w.diagnostics.as_dict()["sanitized"] == 0.0
    assert bool(torch.isfinite(w.bodies.pos).all())


def test_compacted_cache_matches_full_width_bit_exact():
    check_culled_equals_full_width("cpu")


def test_compaction_overflow_is_counted_not_silent():
    check_overflow_counted("cpu")
