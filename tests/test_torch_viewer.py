"""Viewer smoke test of the PyTorch port: server + /state + /control round
trips on a ``Sim(..., device="cpu")`` (the cases of tests/test_viewer.py).

Covers the GUI surface of main.cpp:57-187 as served by
avbd3d_tpu_torch.viewer: state polling (bodies + overlay + diagnostics),
parameter edits, pause, reset, and right-click spawn (padding-slot
activation, after which the next step must refresh its candidate lists).
Runs on an ephemeral port with the small TwoBlockDrop scene.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
import torch

from avbd3d_tpu_torch import solver
from avbd3d_tpu_torch.viewer import Sim, make_handler

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server():
    sim = Sim("TwoBlockDrop", device="cpu")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(sim))
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}", sim
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=120) as r:
        return json.loads(r.read())


def _post(url, obj):
    req = urllib.request.Request(
        url + "/control", json.dumps(obj).encode(),
        {"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_index_serves_html(server):
    url, _ = server
    with urllib.request.urlopen(url + "/", timeout=30) as r:
        body = r.read().decode()
    assert "<html" in body.lower() and "webgl" in body.lower()


def test_state_advances_and_is_well_formed(server):
    url, sim = server
    s1 = _get(url, "/state?steps=1")
    s2 = _get(url, "/state?steps=2")
    assert s2["step"] == s1["step"] + 2
    assert s1["scene"] == "TwoBlockDrop"
    assert len(s1["bodies"]["pos"]) == sim.n_real
    assert len(s1["bodies"]["pos"][0]) == 3
    assert len(s1["bodies"]["quat"][0]) == 4
    assert len(s1["bodies"]["size"][0]) == 3
    # Overlay arrays well-formed (may be empty pre-contact).
    assert len(s1["contacts"]["mid"]) == len(s1["contacts"]["normal"])
    assert len(s1["contacts"]["mid"]) == len(s1["contacts"]["stick"])
    assert len(s1["contacts"]["mid"]) == s1["diag"]["contacts"]
    assert set(s1["diag"]) >= {"maxPen", "manifolds", "contacts", "sanitized"}
    assert "Stress1000" in s1["scenes"]


def test_param_edit_applies(server):
    url, sim = server
    _post(url, {"cmd": "params", "params": {"iterations": 7, "gravity_y": -5.0}})
    s = _get(url, "/state?steps=0")
    assert s["params"]["iterations"] == 7
    assert s["params"]["gravity_y"] == -5.0
    assert sim.params.iterations == 7
    _post(url, {"cmd": "params", "params": {"iterations": 10, "gravity_y": -10.0}})


def test_pause_stops_stepping(server):
    url, _ = server
    _post(url, {"cmd": "pause"})
    s1 = _get(url, "/state?steps=3")
    s2 = _get(url, "/state?steps=3")
    assert s2["step"] == s1["step"] and not s1["running"]
    _post(url, {"cmd": "pause"})


def test_spawn_activates_padding_slot(server):
    url, sim = server
    n0 = sim.n_real
    shared = sim.world.bodies.pos                 # a leaf the pre-spawn world holds
    before = shared.clone()
    _post(url, {"cmd": "spawn", "pos": [0.0, 8.0, 0.0], "vel": [0.0, 0.0, 0.0]})
    assert sim.n_real == n0 + 1
    assert torch.equal(shared, before)            # spawn built new leaves
    assert float(sim.world.bodies.inv_mass[0, n0]) == 1.0
    assert float(sim.world.diagnostics.vec[14]) == 1.0e9
    s = _get(url, "/state?steps=1")
    assert solver.step.last_gates["refreshed"] and not solver.step.last_gates["ballistic"]
    s = _get(url, "/state?steps=1")
    assert len(s["bodies"]["pos"]) == n0 + 1
    # The spawned body is falling (gravity acted on it).
    assert s["bodies"]["pos"][n0][1] < 8.0
    assert s["diag"]["sanitized"] == 0


def test_reset_restores_scene(server):
    url, sim = server
    _post(url, {"cmd": "reset"})
    s = _get(url, "/state?steps=0")
    assert s["step"] == 0
    assert len(s["bodies"]["pos"]) == 3  # ground + two blocks


def test_bad_requests_are_refused(server):
    url, sim = server
    for path in ("/nothing", "/state?steps=abc"):
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(url, path)
        assert err.value.code in (400, 404)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, {"cmd": "scene", "name": "NoSuchScene"})
    assert err.value.code == 400 and sim.scene_name == "TwoBlockDrop"
