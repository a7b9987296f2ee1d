"""The PyTorch port's headless CLI against the reference's, on the CPU.

Both ``main`` functions run in this process and their standard output is
compared after the first line (the port's names its device).  Ground (a
static slab: every number is exact) must be byte-identical under every
flag; TwoBlockDrop must have the same lines with the same integers, and
its floats are held per field: poses and penetrations to 1e-3; velocities,
which are pose differences over dt (x 60), to 5e-3; the largest normal
impulse to 2e-3 relative (two float32 solvers through the contact onset at
step 20: the reference here runs its XLA path, the port mirrors the kernel
path, and the reference's own tests hold those two to 2e-3 m).  The native
trace formatter and its Python twin must give identical bytes.
"""

import re

import numpy as np
import pytest
import torch

from avbd3d_tpu import cli as jcli

from avbd3d_tpu_torch import cli as tcli
from avbd3d_tpu_torch.utils import native

torch.set_num_threads(1)

_NUMBER = re.compile(r"-?\d+\.\d+|-?\d+")


def run_both(capsys, args):
    assert jcli.main(list(args)) == 0
    ref = capsys.readouterr().out.splitlines()
    assert tcli.main(list(args) + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    scene_part = ref[0]
    assert got[0].startswith(scene_part) and got[0].endswith("device=cpu")
    return got[1:], ref[1:]


FLAG_CASES = {
    "default": (),
    "quiet": ("--quiet",),
    "print-every-5": ("--print-every", "5"),
    "log-frequency-0": ("--log-frequency", "0"),
    "log-frequency-3": ("--log-frequency", "3"),
    "quiet-print-every-3-log-2": ("--quiet", "--print-every", "3", "--log-frequency", "2"),
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_ground_is_byte_identical(capsys, case):
    steps = 5 if case == "default" else 7
    got, ref = run_both(capsys, ("--nogfx", "--scene", "Ground", "--steps", str(steps))
                        + FLAG_CASES[case])
    assert got == ref
    physics = sum(ln.startswith("[Physics]") for ln in got)
    dumps = sum(ln.startswith("Step ") for ln in got)
    bodies = sum(ln.startswith("  Body ") for ln in got)
    want = {"default": (5, 5, 5), "quiet": (7, 7, 0), "print-every-5": (7, 2, 2),
            "log-frequency-0": (0, 7, 7), "log-frequency-3": (2, 7, 7),
            "quiet-print-every-3-log-2": (3, 3, 0)}[case]
    assert (physics, dumps, bodies) == want


def test_two_block_drop_matches_reference(capsys):
    got, ref = run_both(capsys, ("--nogfx", "--scene", "TwoBlockDrop", "--steps", "20"))
    assert len(got) == len(ref) == 20 * (1 + 1 + 3 + 1)
    assert got[1] == "Step 0:" and got[2].startswith("  Body 3: Pos(")      # newest first
    for a, b in zip(got, ref):
        assert _NUMBER.sub("#", a) == _NUMBER.sub("#", b)
        xs, ys = _NUMBER.findall(a), _NUMBER.findall(b)
        ints = [(x, y) for x, y in zip(xs, ys) if "." not in x]
        floats = [(float(x), float(y)) for x, y in zip(xs, ys) if "." in x]
        assert all(x == y for x, y in ints), (a, b)
        if a.startswith("  Body"):
            tols = [1e-3] * 7 + [5e-3] * 6               # Pos, Rot | LinVel, AngVel
        elif floats:
            tols = [1e-3, 1e-3, 5e-3, 5e-3, None]        # maxPen, maxDrift | maxLin, maxAng
        assert len(floats) == (len(tols) if floats else 0)
        for (x, y), tol in zip(floats, tols):
            assert abs(x - y) <= (2e-3 * abs(y) + 1e-3 if tol is None else tol), (a, b)


def test_bench_mode_prints_rate_and_device(capsys):
    assert tcli.main(["--nogfx", "--scene", "Ground", "--steps", "3", "--bench",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("  Diagnostics: manifolds=0 contacts=0 dynBodies=0")
    assert re.fullmatch(r"3 steps in \d+\.\d+s = \d+\.\d steps/sec \(cpu\)", out[2])


def test_cli_rejects_bad_cadence():
    with pytest.raises(SystemExit):
        tcli.main(["--scene", "Ground", "--steps", "1", "--print-every", "0", "--device", "cpu"])


def dump_arrays(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=20.0, size=(n, 3)).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    linvel = rng.normal(scale=5.0, size=(n, 3)).astype(np.float32)
    angvel = rng.normal(scale=1e-3, size=(n, 3)).astype(np.float32)
    pos[0] = (0.0, -0.0, 12345.678)
    linvel[0] = (0.00005, -0.00005, 0.00015)          # rounding at the 4th decimal
    return pos, quat, linvel, angvel


@pytest.mark.parametrize("n", [1, 3, 1001])
def test_formatters_give_identical_bytes(n):
    arrays = dump_arrays(n, n)
    text = native.format_step_python(7, *arrays, n)
    lines = text.splitlines()
    assert lines[0] == "Step 7:" and len(lines) == n + 1
    assert lines[1].startswith(f"  Body {n}: Pos(") and lines[-1].startswith("  Body 1: Pos(")
    if native.get_tracefmt() is None:
        pytest.skip("no C compiler here: the native formatter cannot be built")
    assert native.format_step_native(7, *arrays, n).encode() == text.encode()
    assert native.format_step(7, *arrays, n) == text


def test_native_formatter_checks_shapes():
    if native.get_tracefmt() is None:
        pytest.skip("no C compiler here: the native formatter cannot be built")
    pos, quat, linvel, angvel = dump_arrays(0, 4)
    with pytest.raises(ValueError, match="body dump"):
        native.format_step_native(0, pos, quat, linvel, angvel, 5)
