"""Structure-of-arrays world state as frozen dataclasses of tensors.

Same containers, fields and layouts as ``avbd3d_tpu.state`` (the
reference): body leaves are component-major ``(C, G, 128)`` (body n at
group n // 128, lane n % 128), the contact cache is replicated and
body-major ``(..., D, G, 128)`` in the canonical pair frame (A = lower body
index), everything float32 / int32.  Only the contact ``stick`` latch is
bool, as in the reference.  Joints and springs exist here only as the empty
``dj = ds = 0`` containers of contact-only scenes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def _n3(leaf):
    """(C, G, 128) -> (N, C) row view."""
    return leaf.reshape(leaf.shape[0], -1).T


@dataclasses.dataclass(frozen=True)
class Bodies:
    pos: Any            # (3, G, 128)
    quat: Any           # (4, G, 128) (x, y, z, w)
    linvel: Any         # (3, G, 128)
    angvel: Any         # (3, G, 128)
    prev_linvel: Any    # (3, G, 128)
    prev_angvel: Any    # (3, G, 128)
    size: Any           # (3, G, 128) box extents
    mass: Any           # (G, 128)
    inv_mass: Any       # (G, 128)  0 => static body
    inertia: Any        # (3, G, 128)
    inv_inertia: Any    # (3, G, 128)
    friction: Any       # (G, 128)
    radius: Any         # (G, 128) bounding-sphere radius (padding: -1e9)

    @property
    def n(self) -> int:
        return self.mass.shape[0] * 128

    @property
    def g(self) -> int:
        return self.mass.shape[0]

    @property
    def dynamic(self):
        return self.inv_mass > 0.0

    @property
    def pos_n3(self):
        return _n3(self.pos)

    @property
    def quat_n4(self):
        return _n3(self.quat)

    @property
    def linvel_n3(self):
        return _n3(self.linvel)

    @property
    def angvel_n3(self):
        return _n3(self.angvel)

    def replace(self, **kw) -> "Bodies":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Contacts:
    """Replicated body-major contact cache (see the reference's docstring):
    slot (d, g, lane) is that body's view of its manifold with body
    ``other[d, g, lane]`` (-1 empty), stored in the canonical pair frame so
    both replicas compute bit-identical updates."""

    other: Any          # (D, G, 128) int32 partner or -1
    count: Any          # (D, G, 128) int32 contacts in the manifold (0..4)
    feature: Any        # (4, D, G, 128) int32 feature ids
    r_a: Any            # (4, 3, D, G, 128) local anchor on canonical body A
    r_b: Any            # (4, 3, D, G, 128) local anchor on canonical body B
    normal: Any         # (3, D, G, 128) world normal, B -> A
    stick: Any          # (4, D, G, 128) bool static-friction latch
    c0_n: Any           # (4, D, G, 128)
    c0_t1: Any          # (4, D, G, 128)
    c0_t2: Any          # (4, D, G, 128)
    lam: Any            # (12, D, G, 128) duals (3 rows per contact)
    penalty: Any        # (12, D, G, 128)

    def replace(self, **kw) -> "Contacts":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Joints:
    """Weld joints.  The port carries only the empty container (dj = 0):
    the fields mirror the reference so a world converts leaf for leaf."""

    body_a: Any
    body_b: Any
    r_a: Any
    r_b: Any
    rest_rel_quat: Any
    stiffness_lin: Any
    stiffness_ang: Any
    motor: Any
    active: Any
    other: Any
    world: Any
    side: Any
    anchor_a: Any
    anchor_b: Any
    rest: Any
    stiff_lin: Any
    stiff_ang: Any
    rmotor: Any
    lam: Any
    penalty: Any
    color: Any

    @property
    def dj(self) -> int:
        return self.other.shape[0]


@dataclasses.dataclass(frozen=True)
class Springs:
    """Distance springs; only the empty container (ds = 0) in the port."""

    body_a: Any
    body_b: Any
    r_a: Any
    r_b: Any
    rest: Any
    stiffness: Any
    active: Any
    other: Any
    world: Any
    side: Any
    anchor_a: Any
    anchor_b: Any
    rrest: Any
    rstiff: Any
    penalty: Any

    @property
    def ds(self) -> int:
        return self.other.shape[0]


def empty_joints(n_bodies: int, device) -> Joints:
    g = n_bodies // 128
    f32, i32 = torch.float32, torch.int32
    z = dict(dtype=f32, device=device)
    quat_id = torch.zeros((0, 4), **z)
    rest = torch.zeros((4, 0, g, 128), **z)
    rest[3] = 1.0
    return Joints(
        body_a=torch.full((0,), -1, dtype=i32, device=device),
        body_b=torch.zeros((0,), dtype=i32, device=device),
        r_a=torch.zeros((0, 3), **z),
        r_b=torch.zeros((0, 3), **z),
        rest_rel_quat=quat_id,
        stiffness_lin=torch.full((0,), float("inf"), **z),
        stiffness_ang=torch.full((0,), float("inf"), **z),
        motor=torch.zeros((0, 6), **z),
        active=torch.zeros((0,), dtype=torch.bool, device=device),
        other=torch.full((0, g, 128), -1, dtype=i32, device=device),
        world=torch.zeros((0, g, 128), dtype=i32, device=device),
        side=torch.ones((0, g, 128), dtype=i32, device=device),
        anchor_a=torch.zeros((3, 0, g, 128), **z),
        anchor_b=torch.zeros((3, 0, g, 128), **z),
        rest=rest,
        stiff_lin=torch.full((0, g, 128), float("inf"), **z),
        stiff_ang=torch.full((0, g, 128), float("inf"), **z),
        rmotor=torch.zeros((6, 0, g, 128), **z),
        lam=torch.zeros((6, 0, g, 128), **z),
        penalty=torch.full((6, 0, g, 128), 2.0e4, **z),
        color=torch.zeros((g, 128), dtype=i32, device=device),
    )


def empty_springs(n_bodies: int, device) -> Springs:
    g = n_bodies // 128
    f32, i32 = torch.float32, torch.int32
    z = dict(dtype=f32, device=device)
    return Springs(
        body_a=torch.full((0,), -1, dtype=i32, device=device),
        body_b=torch.zeros((0,), dtype=i32, device=device),
        r_a=torch.zeros((0, 3), **z),
        r_b=torch.zeros((0, 3), **z),
        rest=torch.zeros((0,), **z),
        stiffness=torch.zeros((0,), **z),
        active=torch.zeros((0,), dtype=torch.bool, device=device),
        other=torch.full((0, g, 128), -1, dtype=i32, device=device),
        world=torch.zeros((0, g, 128), dtype=i32, device=device),
        side=torch.ones((0, g, 128), dtype=i32, device=device),
        anchor_a=torch.zeros((3, 0, g, 128), **z),
        anchor_b=torch.zeros((3, 0, g, 128), **z),
        rrest=torch.zeros((0, g, 128), **z),
        rstiff=torch.zeros((0, g, 128), **z),
        penalty=torch.full((0, g, 128), 2.0e4, **z),
    )


@dataclasses.dataclass(frozen=True)
class Diagnostics:
    """Per-step stats as ONE 16-lane f32 vector (lane layout of the
    reference, state.py:331-361):

      0 max_penetration  1 max_constraint_violation  2 max_linear_speed
      3 max_angular_speed  4 max_normal_impulse  5 active_contacts
      6 active_manifolds  7 dynamic_bodies  8 sanitized  9 pair_overflow
      10 degree_overflow  11 gate_speed_sq  12 near_speed_sq
      13 min_cand_gap  14 bp_dev_mm  15 bp_dev_raw

    Lanes 11-15 are the step-control block, computed on END-of-step state
    so the next step's gates are scalar logic on one host read."""

    vec: Any   # (16,) f32

    NAMES = (
        "max_penetration", "max_constraint_violation", "max_linear_speed",
        "max_angular_speed", "max_normal_impulse", "active_contacts",
        "active_manifolds", "dynamic_bodies", "sanitized", "pair_overflow",
        "degree_overflow", "gate_speed_sq", "near_speed_sq", "min_cand_gap",
        "bp_dev_mm", "bp_dev_raw",
    )

    def as_dict(self) -> dict:
        """Host copy of every lane by name (one device-to-host copy)."""
        v = self.vec.detach().cpu().numpy()
        return {k: float(v[i]) for i, k in enumerate(self.NAMES)}

    def replace(self, **kw) -> "Diagnostics":
        return dataclasses.replace(self, **kw)


# Control block for a world with no step history: speed gates pessimistic,
# ballistic off (min gap 0), broadphase refresh forced (dev 1e9).
CONTROL_RESET = (1.0e9, 1.0e9, 0.0, 1.0e9, 1.0e9)


def make_diagnostics(device, max_penetration=0.0, max_constraint_violation=0.0,
                     max_linear_speed=0.0, max_angular_speed=0.0,
                     max_normal_impulse=0.0, active_contacts=0,
                     active_manifolds=0, dynamic_bodies=0, sanitized=0,
                     pair_overflow=0, degree_overflow=0,
                     control=CONTROL_RESET) -> Diagnostics:
    vals = [max_penetration, max_constraint_violation, max_linear_speed,
            max_angular_speed, max_normal_impulse, active_contacts,
            active_manifolds, dynamic_bodies, sanitized, pair_overflow,
            degree_overflow] + list(control)
    vals = [torch.as_tensor(v, device=device).to(torch.float32).reshape(())
            for v in vals]
    return Diagnostics(vec=torch.stack(vals))


@dataclasses.dataclass(frozen=True)
class World:
    """The whole simulation state, advanced by ``solver.step``."""

    bodies: Bodies
    contacts: Contacts
    joints: Joints
    springs: Springs
    exclusions: Any          # (E, G, 128) int32 suppressed partners (-1 empty)
    bp: Any                  # ops.broadphase.BroadphaseCache
    step_index: int
    diagnostics: Diagnostics

    def replace(self, **kw) -> "World":
        return dataclasses.replace(self, **kw)
