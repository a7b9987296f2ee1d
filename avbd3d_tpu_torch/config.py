"""Solver configuration: the same two frozen dataclasses as the JAX package.

Every field and default matches ``avbd3d_tpu.config`` (the reference); the
long rationale for each knob lives there.  In this port the dataclasses are
plain host values: a change of any field changes which kernel arguments a
step passes, never what is compiled.
"""

from __future__ import annotations

import dataclasses

FLT_MAX = 3.4028235e38


@dataclasses.dataclass(frozen=True)
class SolverParams:
    # runtime params (solver.cpp:240-253)
    dt: float = 1.0 / 60.0
    gravity: tuple = (0.0, -10.0, 0.0)
    iterations: int = 10
    alpha: float = 0.95
    beta: float = 1.0e5
    gamma: float = 0.99
    post_stabilize: bool = False

    # compile-time constants (solver.h:25-36)
    penalty_min: float = 2.0e4
    penalty_max: float = 1.0e9
    collision_margin: float = 0.02
    stick_thresh: float = 0.02
    penetration_slop: float = 0.005

    # manifold tuning constants (manifold.cpp:17-23, solver.cpp:29)
    normal_contact_margin: float = 0.01
    stick_anchor_max_drift: float = 0.015
    stick_normal_min_dot: float = 0.995
    warmstart_max_drift: float = 0.08
    warmstart_normal_min_dot: float = 0.9
    normal_force_cap: float = 5000.0
    manifold_penalty_cap: float = 2.0e6

    # dual-ramp blending (solver.cpp:94-125)
    angular_beta_scale: float = 0.01

    # integration damping / clamps (solver.cpp:85-92, 433-454)
    linear_damping: float = 0.995
    angular_damping: float = 0.97
    max_angular_speed: float = 80.0

    # rebuild-specific knobs (see avbd3d_tpu/config.py for each rationale)
    relaxation: float = 0.85
    joint_penalty_cap: float = 1.0e9
    lhs_rebuild_every: int = 4
    lhs_stale_speed_max: float = 1.0
    lhs_fresh_rebuild_every: int = 1
    bp_margin: float = 0.04
    fall_freeze_y: float = -100.0
    ballistic: bool = True
    joint_dual_rate: float = 0.0
    joint_ema_rate: float = 0.05
    impact_iterations: int = 20
    impact_speed_min: float = 0.5

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Capacity:
    """Static-shape capacity plan for one scene (see the reference)."""

    max_degree: int = 16       # broadphase candidate slots per body (D)
    cache_degree: int = 0      # contact-cache width (DC); 0 = max_degree
    joint_degree: int = 0
    spring_degree: int = 0
    joint_colors: int = 1
    bp_window: int = 0
    backend: str = "auto"
    grid_residency: int = 4

    def replace(self, **kw) -> "Capacity":
        return dataclasses.replace(self, **kw)


def default_params() -> SolverParams:
    """defaultParams() of the reference (solver.cpp:240-253)."""
    return SolverParams()
