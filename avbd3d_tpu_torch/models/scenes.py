"""Scene library (reference ``source/scenes.h``), built with numpy only.

Port of the contact-only scenes of ``avbd3d_tpu/models/scenes.py`` (the
reference): same body order, padding, mass properties and per-scene
``SolverParams`` / ``Capacity``.  ``SceneBuilder.build`` returns the world
as a tree of numpy arrays (the reference wraps the same arrays in
``jnp.asarray``); ``load_scene(name, device)`` copies it onto a device
through ``convert.world_from_arrays``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..config import Capacity, SolverParams
from ..state import CONTROL_RESET, World


@dataclasses.dataclass
class Scene:
    name: str
    world: World
    params: SolverParams
    cap: Capacity
    n_real: int                  # real (non-padding) bodies


class SceneBuilder:
    """Imperative construction mirroring ``new Rigid`` of the reference.
    Contact-only: joints, springs and ignore-collision markers are later
    slices of the port."""

    def __init__(self):
        self.size, self.density, self.friction = [], [], []
        self.pos, self.quat, self.linvel, self.angvel = [], [], [], []

    def add_body(self, size, density, friction, pos, quat=(0, 0, 0, 1),
                 linvel=(0, 0, 0), angvel=(0, 0, 0)) -> int:
        """Mirrors Rigid::Rigid (rigid.cpp:12-41); returns the body index."""
        self.size.append(size)
        self.density.append(density)
        self.friction.append(friction)
        self.pos.append(pos)
        self.quat.append(quat)
        self.linvel.append(linvel)
        self.angvel.append(angvel)
        return len(self.size) - 1

    def build(self, params: SolverParams, max_degree=None, min_bodies: int = 0,
              cache_degree: int = 0):
        """Returns (arrays, params, cap, n_real); ``arrays`` is the world as
        nested dicts of numpy arrays, field for field the reference World."""
        n_real = len(self.size)
        n = max(128, min_bodies, -(-max(n_real, 1) // 128) * 128)
        if n > 2048:
            n = -(-n // 1024) * 1024
        pad = n - n_real

        size = np.asarray(self.size + [[0.0] * 3] * pad, np.float32).reshape(n, 3)
        density = np.asarray(self.density + [0.0] * pad, np.float32)
        friction = np.asarray(self.friction + [0.0] * pad, np.float32)
        pos = np.asarray(self.pos + [[0.0, -1e6, 0.0]] * pad, np.float32).reshape(n, 3)
        quat = np.asarray(self.quat + [[0, 0, 0, 1]] * pad, np.float32).reshape(n, 4)
        linvel = np.asarray(self.linvel + [[0.0] * 3] * pad, np.float32).reshape(n, 3)
        angvel = np.asarray(self.angvel + [[0.0] * 3] * pad, np.float32).reshape(n, 3)

        # Mass properties (rigid.cpp:23-40).
        volume = size[:, 0] * size[:, 1] * size[:, 2]
        mass = volume * density
        inv_mass = np.where(mass > 0.0, 1.0 / np.maximum(mass, 1e-30), 0.0)
        sx2, sy2, sz2 = size[:, 0] ** 2, size[:, 1] ** 2, size[:, 2] ** 2
        inertia = (mass[:, None] / 12.0) * np.stack(
            [sy2 + sz2, sx2 + sz2, sx2 + sy2], axis=-1)
        inv_inertia = np.where(inertia > 0.0, 1.0 / np.maximum(inertia, 1e-30), 0.0)
        inertia = np.where(mass[:, None] > 0.0, inertia, 0.0)
        radius = np.linalg.norm(size, axis=-1) * 0.5
        # Padding bodies can never pass the candidate mask.
        radius[n_real:] = -1e9

        g = n // 128

        def cg(a):
            return np.ascontiguousarray(a.T).reshape(a.shape[1], g, 128)

        def gg(a):
            return np.ascontiguousarray(a.reshape(g, 128))

        if max_degree is None:
            max_degree = 32 if n_real > 256 else 16
        dc = cache_degree or max_degree
        cap = Capacity(max_degree=max_degree, cache_degree=cache_degree)

        f32, i32 = np.float32, np.int32
        arrays = {
            "bodies": {
                "pos": cg(pos), "quat": cg(quat),
                "linvel": cg(linvel), "angvel": cg(angvel),
                "prev_linvel": cg(linvel), "prev_angvel": cg(angvel),
                "size": cg(size), "mass": gg(mass),
                "inv_mass": gg(inv_mass.astype(f32)),
                "inertia": cg(inertia.astype(f32)),
                "inv_inertia": cg(inv_inertia.astype(f32)),
                "friction": gg(friction), "radius": gg(radius),
            },
            "contacts": {
                "other": np.full((dc, g, 128), -1, i32),
                "count": np.zeros((dc, g, 128), i32),
                "feature": np.full((4, dc, g, 128), -1, i32),
                "r_a": np.zeros((4, 3, dc, g, 128), f32),
                "r_b": np.zeros((4, 3, dc, g, 128), f32),
                "normal": np.zeros((3, dc, g, 128), f32),
                "stick": np.zeros((4, dc, g, 128), bool),
                "c0_n": np.zeros((4, dc, g, 128), f32),
                "c0_t1": np.zeros((4, dc, g, 128), f32),
                "c0_t2": np.zeros((4, dc, g, 128), f32),
                "lam": np.zeros((12, dc, g, 128), f32),
                "penalty": np.zeros((12, dc, g, 128), f32),
            },
            "joints": None,
            "springs": None,
            "exclusions": np.full((0, g, 128), -1, i32),
            "bp": {
                "anchor": np.full((3, g, 128), 1.0e9, f32),
                "anchor_quat": np.zeros((4, g, 128), f32),
                "nb": np.full((max_degree, g, 128), -1, i32),
                "key": np.zeros((max_degree, g, 128), i32),
                "thr": np.zeros((g, 128), i32),
                "cand": np.int32(0),
                "slack": np.float32(0.0),
                "dropped": np.int32(1),   # blocks the ballistic path
            },
            "step_index": np.int32(0),
            "diagnostics": {
                "vec": np.asarray([0.0] * 11 + list(CONTROL_RESET), f32),
            },
        }
        return arrays, params, cap, n_real


def _axis_angle_np(axis, angle):
    axis = np.asarray(axis, np.float64)
    half = angle * 0.5
    s = math.sin(half)
    return np.asarray([axis[0] * s, axis[1] * s, axis[2] * s, math.cos(half)])


# ---------------------------------------------------------------------------
# Scene definitions (scenes.h:23-132)
# ---------------------------------------------------------------------------

def _ground(sb: SceneBuilder):
    """100 x 1 x 100 static slab at y = -0.5 (scenes.h:27-31)."""
    sb.add_body((100, 1, 100), 0.0, 0.5, (0, -0.5, 0))


def scene_empty():
    return SceneBuilder().build(SolverParams())


def scene_ground():
    sb = SceneBuilder()
    _ground(sb)
    return sb.build(SolverParams())


def scene_stack():
    """10-cube vertical stack (scenes.h:33-40)."""
    sb = SceneBuilder()
    _ground(sb)
    for i in range(10):
        sb.add_body((1, 1, 1), 1.0, 0.5, (0, i * 1.1 + 0.5, 0))
    return sb.build(SolverParams())


def scene_pyramid():
    """10-level 2D pyramid (scenes.h:42-53)."""
    sb = SceneBuilder()
    _ground(sb)
    size = 10
    for y in range(size):
        for x in range(size - y):
            x_pos = (x - (size - y - 1) * 0.5) * 1.1
            y_pos = y * 1.05 + 0.5
            sb.add_body((1, 1, 1), 1.0, 0.5, (x_pos, y_pos, 0))
    return sb.build(SolverParams())


def scene_wall():
    """8 x 8 running-bond brick wall (scenes.h:55-72)."""
    sb = SceneBuilder()
    _ground(sb)
    w, h = 8, 8
    brick = (1.0, 0.5, 0.5)
    spacing_x, spacing_y = 1.03, 0.52
    base_y = brick[1] * 0.5
    for i in range(h):
        for j in range(w):
            x_off = 0.0 if i % 2 == 0 else 0.5 * spacing_x
            x = (j - (w - 1) * 0.5) * spacing_x + x_off
            y = i * spacing_y + base_y
            sb.add_body(brick, 1.0, 0.4, (x, y, -5))
    return sb.build(SolverParams())


def scene_two_block_drop():
    """Tip-land-settle regression scene (scenes.h:74-85)."""
    sb = SceneBuilder()
    _ground(sb)
    sb.add_body((1, 1, 1), 1.0, 0.5, (0, 0.5, 0))
    tilt = _axis_angle_np((0, 0, 1), 0.45)
    sb.add_body((1, 1, 1), 1.0, 0.5, (0.18, 2.2, 0), tilt, (0, 0, 0), (0, 0, 1))
    return sb.build(SolverParams())


def _hash01(x: int) -> float:
    """Exact uint32 xorshift-multiply hash of scenes.h:108-115."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return (x & 0x00FFFFFF) / 16777215.0


def _scene_stress_n(nx, ny, nz, max_degree=24, cache_degree=12, order="yzx"):
    """Hash-jittered falling cube grid (scenes.h:87-132) of nx*ny*nz cubes
    with the Stress1000 tuning; Stress1000 is the 10x10x10 case.

    ``order``: body index order.  "yzx" is the reference loop nest (y
    outer); "xzy" numbers the cubes x-major, so the grid tier's body blocks
    are x-slabs of the spawn grid and most contact pairs stay inside one
    block.  The jitter depends on the grid cell only."""
    sb = SceneBuilder()
    _ground(sb)
    spacing_xz, spacing_y = 1.15, 2.0
    start_y, jitter_xz, jitter_y = 20.0, 0.04, 0.25
    cells = [(x, y, z) for y in range(ny) for z in range(nz) for x in range(nx)]
    if order == "xzy":
        cells.sort(key=lambda c: (c[0], c[2], c[1]))
    for x, y, z in cells:
        seed = (x + nx * (z + nz * y) + 1) & 0xFFFFFFFF
        jx = (_hash01((seed * 9781) & 0xFFFFFFFF) * 2.0 - 1.0) * jitter_xz
        jz = (_hash01((seed * 6271) & 0xFFFFFFFF) * 2.0 - 1.0) * jitter_xz
        jy = _hash01((seed * 3343) & 0xFFFFFFFF) * jitter_y
        px = (x - (nx - 1) * 0.5) * spacing_xz + jx
        py = start_y + y * spacing_y + jy
        pz = (z - (nz - 1) * 0.5) * spacing_xz + jz
        sb.add_body((1, 1, 1), 1.0, 0.5, (px, py, pz))
    # The documented stress tuning (see avbd3d_tpu scene_stress1000): 20
    # sweeps, the landing cascade on the same 4-iteration AL blocks as the
    # calm regime, D=24 candidate slots, cache width 12.
    params = SolverParams(iterations=20, beta=30000.0, gamma=0.995,
                          lhs_fresh_rebuild_every=4)
    return sb.build(params, max_degree=max_degree, cache_degree=cache_degree)


def scene_stress1000():
    """10x10x10 = 1000 falling cubes (scenes.h:87-132), padded to 1024."""
    return _scene_stress_n(10, 10, 10)


def scene_stress2048():
    """13x12x13 = 2028 cubes, padded to N = 2048: the largest scene of the
    fused step path."""
    return _scene_stress_n(13, 12, 13)


def scene_stress4096():
    """16x16x16 = 4096 cubes, padded to N = 5120 (G = 40): the grid tier
    (solver_grid).  The reference's validated plan (its scenes.py:558-579):
    D = 28 candidate slots and DC = 16 cache slots (the broadphase degree
    peaks at 24 and the near degree at 12 over a 1000-step fall and
    settle), and x-major body order so the grid tier's cross-block pose lag
    touches only slab-boundary contacts."""
    return _scene_stress_n(16, 16, 16, max_degree=28, cache_degree=16, order="xzy")


SCENES = {
    "Empty": scene_empty,
    "Ground": scene_ground,
    "Stack": scene_stack,
    "Pyramid": scene_pyramid,
    "Wall": scene_wall,
    "TwoBlockDrop": scene_two_block_drop,
    "Stress1000": scene_stress1000,
    "Stress2048": scene_stress2048,
    "Stress4096": scene_stress4096,
}

SCENE_NAMES = list(SCENES.keys())


def load_scene(name: str, device) -> Scene:
    """Build scene ``name`` onto ``device`` (a torch device or its name).
    A CUDA device on a host without CUDA raises."""
    from ..convert import world_from_arrays

    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; available: {SCENE_NAMES}")
    arrays, params, cap, n_real = SCENES[name]()
    return Scene(name=name, world=world_from_arrays(arrays, device),
                 params=params, cap=cap, n_real=n_real)
