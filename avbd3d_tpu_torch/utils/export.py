"""Frame export: world state -> Wavefront OBJ (the viewer-of-record).

The port's own copy of ``avbd3d_tpu/utils/export.py``: numpy on the host,
one device-to-host copy per body leaf used.

The reference renders body cubes and contact points with immediate-mode GL
(rigid.cpp:71-127, manifold.cpp:273-307); SURVEY.md lists a host viewer as
optional polish.  This writes oriented body boxes (and optionally contact
points as small markers) to OBJ so any standard viewer/DCC can inspect a
frame; `export_sequence` dumps an animation as numbered files.
"""

from __future__ import annotations

import numpy as np

_CORNERS = np.array(
    [
        [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
    ],
    np.float32,
) * 0.5
_FACES = [
    (1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2),
    (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8),
]


def _rot_from_quat(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def export_obj(path: str, world, n_real: int, overlay: bool = True) -> None:
    """Write all real bodies as oriented boxes to a Wavefront OBJ file.

    With ``overlay`` (default), also emits the reference's debug-draw
    primitives as colored OBJ objects (materials in a sibling .mtl):
    contact midpoints as small markers colored by stick state, red normal
    rays, green joint lines, blue spring lines (manifold.cpp:273-307,
    joint.cpp:141-161, spring.cpp:92-109)."""
    from .overlay import (
        COLOR_JOINT, COLOR_NORMAL, COLOR_SLIDE, COLOR_SPRING, COLOR_STICK,
        contact_overlay, joint_overlay, spring_overlay,
    )

    b = world.bodies
    pos, quat, size = (leaf.detach().cpu().numpy().reshape(leaf.shape[0], -1).T[:n_real]
                       for leaf in (b.pos, b.quat, b.size))

    lines = ["# avbd3d_tpu_torch frame export"]
    if overlay:
        mtl_path = path.rsplit(".", 1)[0] + ".mtl"
        lines.append(f"mtllib {mtl_path.rsplit('/', 1)[-1]}")
    base = 1
    for i in range(n_real):
        r = _rot_from_quat(quat[i])
        verts = (pos[i][None, :] + (_CORNERS * size[i][None, :]) @ r.T)
        lines.append(f"o body_{i + 1}")
        for v in verts:
            lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
        for f in _FACES:
            lines.append("f " + " ".join(str(base + k - 1) for k in f))
        base += 8

    if overlay:
        mids, normals, sticks = contact_overlay(world)

        def marker(center, half, mtl):
            nonlocal base
            lines.append(f"usemtl {mtl}")
            for c in _CORNERS:
                v = center + c * (2 * half)
                lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
            for f in _FACES:
                lines.append("f " + " ".join(str(base + k - 1) for k in f))
            base += 8

        def segment(p0, p1, mtl):
            nonlocal base
            lines.append(f"usemtl {mtl}")
            lines.append(f"v {p0[0]:.6f} {p0[1]:.6f} {p0[2]:.6f}")
            lines.append(f"v {p1[0]:.6f} {p1[1]:.6f} {p1[2]:.6f}")
            lines.append(f"l {base} {base + 1}")
            base += 2

        lines.append("o contacts")
        for k in range(mids.shape[0]):
            marker(mids[k], 0.03, "stick" if sticks[k] else "slide")
            segment(mids[k], mids[k] + normals[k] * 0.5, "normal")
        lines.append("o joints")
        for (pa, pb) in joint_overlay(world):
            segment(pa, pb, "joint")
        lines.append("o springs")
        for (pa, pb) in spring_overlay(world):
            segment(pa, pb, "spring")

        with open(mtl_path, "w") as fh:
            for name, rgb in (
                ("stick", COLOR_STICK), ("slide", COLOR_SLIDE),
                ("normal", COLOR_NORMAL), ("joint", COLOR_JOINT),
                ("spring", COLOR_SPRING),
            ):
                fh.write(f"newmtl {name}\nKd {rgb[0]} {rgb[1]} {rgb[2]}\n")

    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def export_sequence(prefix: str, world, params, cap, n_real: int,
                    n_frames: int, steps_per_frame: int = 1):
    """Step the world and dump one OBJ per frame; returns the final world."""
    from ..solver import run_steps

    for frame in range(n_frames):
        world = run_steps(world, params, cap, steps_per_frame)
        export_obj(f"{prefix}{frame:05d}.obj", world, n_real)
    return world
