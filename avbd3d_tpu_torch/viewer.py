"""Interactive viewer: a dependency-free WebGL page over the live simulation.

Port of ``avbd3d_tpu/viewer.py`` (the reference).  The C++ program's GUI
(main.cpp:57-187) is an SDL2+ImGui window with camera orbit/pan/zoom,
parameter sliders (gravity, dt, iterations, alpha, beta, gamma,
postStabilize), a scene combo, reset, and right-click box spawning.  This
module serves the same surface to a browser: the simulation steps on the
device inside this process (the card unless ``--device cpu``); the page
polls ``/state`` for body poses plus the debug overlay (stick/slide-colored
contact points, red normal rays, green joint lines, blue spring lines) and
posts ``/control`` for parameter edits, scene switches, reset and spawning.

Spawning activates a padding body slot, so no shape changes.  Parameters
are plain host values here: an edit changes the next step's kernel
arguments and nothing is rebuilt.

``solver.step`` keeps its last gates and path as function attributes, which
are process globals: every step of a ``Sim`` runs under ``Sim.lock``.

Usage:  python -m avbd3d_tpu_torch.viewer [--scene Stack] [--port 8700] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .models.scenes import SCENES, load_scene
from .solver import step
from .state import reset_control
from .utils.overlay import contact_overlay, joint_overlay, spring_overlay

_HTML_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "viewer.html")


def _set_slot(leaf, gi: int, li: int, vals):
    """A new leaf equal to ``leaf`` with body slot (gi, li) set: clone, then
    index, so a tensor another world shares is never written."""
    out = leaf.clone()
    out[..., gi, li] = torch.as_tensor(vals, dtype=leaf.dtype, device=leaf.device)
    return out


class Sim:
    """The live simulation behind the viewer (single-threaded via a lock)."""

    def __init__(self, scene_name: str, device="cuda"):
        self.lock = threading.Lock()
        self.running = True
        self.device = device
        self.load(scene_name)

    def load(self, scene_name: str):
        scene = load_scene(scene_name, device=self.device)
        self.scene_name = scene_name
        self.world = scene.world
        self.params = scene.params
        self.cap = scene.cap
        self.n_real = scene.n_real

    def set_params(self, kw: dict):
        fields = {
            "dt": float, "iterations": int, "alpha": float, "beta": float,
            "gamma": float, "post_stabilize": bool,
        }
        clean = {k: f(kw[k]) for k, f in fields.items() if k in kw}
        if "gravity_y" in kw:
            clean["gravity"] = (0.0, float(kw["gravity_y"]), 0.0)
        self.params = self.params.replace(**clean)

    def spawn(self, pos, vel=(0.0, 0.0, 0.0), size=(1.0, 1.0, 1.0),
              density=1.0, friction=0.5):
        """Activate one padding body slot (main.cpp:139-142 semantics);
        False when the world has none left."""
        b = self.world.bodies
        if self.n_real >= b.n:
            return False
        gi, li = divmod(self.n_real, 128)
        sz = np.asarray(size, np.float32)
        mass = density * float(sz.prod())
        inertia = (mass / 12.0) * np.asarray([
            sz[1] ** 2 + sz[2] ** 2,
            sz[0] ** 2 + sz[2] ** 2,
            sz[0] ** 2 + sz[1] ** 2,
        ])
        radius = float(np.linalg.norm(sz)) * 0.5
        new = {"pos": pos, "quat": (0, 0, 0, 1), "linvel": vel, "angvel": (0, 0, 0),
               "prev_linvel": vel, "prev_angvel": (0, 0, 0), "size": sz, "mass": mass,
               "inv_mass": 1.0 / mass, "inertia": inertia, "inv_inertia": 1.0 / inertia,
               "friction": friction, "radius": radius}
        bodies = b.replace(**{k: _set_slot(getattr(b, k), gi, li, v) for k, v in new.items()})
        # The carried control block (diagnostics lanes 11-15) was computed
        # on the pre-spawn state, so reset it: the fused path then refreshes
        # its candidate lists and rebuilds its Hessians on the next step.
        # The grid tier gates its refresh on the anchor deviation instead,
        # so break that bound too: a CONSTANT far anchor gives per-body
        # displacements of -pos, whose spread exceeds margin / 2 in any
        # non-degenerate scene (a uniform anchor shift would be compensated
        # as a common translation), and slack 0 forces the raw bound.
        bp = self.world.bp
        bp = bp.replace(anchor=torch.full_like(bp.anchor, 1.0e9),
                        slack=torch.zeros_like(bp.slack))
        self.world = self.world.replace(
            bodies=bodies, bp=bp, diagnostics=reset_control(self.world.diagnostics))
        self.n_real += 1
        return True

    def state(self, steps: int):
        if self.running and steps > 0:
            for _ in range(steps):
                self.world = step(self.world, self.params, self.cap)
        w = self.world
        n = self.n_real
        b = w.bodies
        rows = torch.cat([b.pos, b.quat, b.size]).reshape(10, -1)[:, :n].T.cpu().numpy()
        mids, normals, sticks = contact_overlay(w)
        d = w.diagnostics.as_dict()
        p = self.params
        return {
            "scene": self.scene_name,
            "scenes": list(SCENES),
            "step": int(w.step_index),
            "running": self.running,
            "params": {
                "dt": p.dt, "gravity_y": p.gravity[1], "iterations": p.iterations,
                "alpha": p.alpha, "beta": p.beta, "gamma": p.gamma,
                "post_stabilize": p.post_stabilize,
            },
            "bodies": {
                "pos": rows[:, 0:3].round(5).tolist(),
                "quat": rows[:, 3:7].round(5).tolist(),
                "size": rows[:, 7:10].round(5).tolist(),
            },
            "contacts": {
                "mid": mids.round(4).tolist(),
                "normal": normals.round(4).tolist(),
                "stick": [bool(x) for x in sticks],
            },
            "joints": joint_overlay(w).round(4).tolist(),
            "springs": spring_overlay(w).round(4).tolist(),
            "diag": {
                "maxPen": d["max_penetration"],
                "maxLin": d["max_linear_speed"],
                "maxAng": d["max_angular_speed"],
                "manifolds": int(d["active_manifolds"]),
                "contacts": int(d["active_contacts"]),
                "overflow": int(d["pair_overflow"]),
                "sanitized": int(d["sanitized"]),
            },
        }


def make_handler(sim: Sim):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, content_type: str, code=200):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(json.dumps(obj).encode(), "application/json", code)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                with open(_HTML_PATH, "rb") as f:
                    self._send(f.read(), "text/html")
            elif self.path.startswith("/state"):
                steps = 1
                if "steps=" in self.path:
                    try:
                        steps = int(self.path.split("steps=")[1].split("&")[0])
                    except ValueError:
                        self._json({"error": "steps must be an integer"}, 400)
                        return
                with sim.lock:
                    self._json(sim.state(steps))
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0"))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._json({"error": "body is not JSON"}, 400)
                return
            cmd = req.get("cmd")
            with sim.lock:
                if cmd == "reset":
                    sim.load(sim.scene_name)
                elif cmd == "scene":
                    if req.get("name") not in SCENES:
                        self._json({"error": "unknown scene"}, 400)
                        return
                    sim.load(req["name"])
                elif cmd == "params":
                    sim.set_params(req.get("params", {}))
                elif cmd == "pause":
                    sim.running = not sim.running
                elif cmd == "spawn":
                    sim.spawn(req.get("pos", (0.0, 10.0, 0.0)),
                              req.get("vel", (0.0, 0.0, 0.0)))
                self._json({"ok": True})

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description="AVBD 3D (PyTorch port) interactive viewer")
    ap.add_argument("--scene", default="Stack")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    sim = Sim(args.scene, device=args.device)
    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(sim))
    print(f"avbd3d_tpu_torch viewer: http://127.0.0.1:{args.port}/  "
          f"(scene {args.scene}, device {args.device})")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
