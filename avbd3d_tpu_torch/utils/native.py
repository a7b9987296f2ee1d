"""The headless trace formatter: a C library built on demand, and its
Python twin.

Port of ``avbd3d_tpu/utils/native.py`` (the reference).  The per-step body
dump of the headless CLI is host text, not device work; at a thousand bodies
a Python ``%`` loop is the slowest part of a traced step, so the dump is
formatted by ``_native/tracefmt.c``, compiled once with the system ``cc``
into ``_build/`` beside the CUDA library (named by a hash of the source) and
loaded with ``ctypes``.  Where there is no C compiler, ``format_step`` uses
``format_step_python``, which produces the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "_native", "tracefmt.c")
_BUILD = os.path.join(_HERE, "..", "_build")
_LIB = None
_TRIED = False


def _build_lib():
    src = os.path.abspath(_SRC)
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    build = os.path.abspath(_BUILD)
    os.makedirs(build, exist_ok=True)
    lib_path = os.path.join(build, f"tracefmt_{tag}.so")
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", tmp, src], check=True,
                       capture_output=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.avbd_format_step.restype = ctypes.c_long
    lib.avbd_format_step.argtypes = [ctypes.c_long, fp, fp, fp, fp, ctypes.c_long,
                                     ctypes.c_char_p, ctypes.c_long]
    return lib


def get_tracefmt():
    """The native library, or None where it cannot be built (no compiler)."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _build_lib()
        except (OSError, subprocess.CalledProcessError):
            _LIB = None
    return _LIB


def format_step_native(step_idx: int, pos, quat, linvel, angvel, n_real: int):
    """The body dump of one step from (n, 3) / (n, 4) float32 arrays, newest
    body first; None if there is no native library."""
    lib = get_tracefmt()
    if lib is None:
        return None
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in (pos, quat, linvel, angvel)]
    for a, width in zip(arrays, (3, 4, 3, 3)):
        if a.ndim != 2 or a.shape[1] != width or a.shape[0] < n_real:
            raise ValueError(f"body dump: array of shape {a.shape} for {n_real} bodies")
    ptrs = [a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in arrays]
    # A dump line is ~155-170 bytes for typical large-scene values; budget
    # generously and retry with a doubled buffer.
    cap = 256 * (n_real + 1) + 64
    for _ in range(3):
        buf = ctypes.create_string_buffer(cap)
        n = lib.avbd_format_step(step_idx, *ptrs, n_real, buf, cap)
        if n >= 0:
            return buf.raw[:n].decode()
        cap *= 2
    return None


def format_step_python(step_idx: int, pos, quat, linvel, angvel, n_real: int) -> str:
    """The same bytes as ``format_step_native``, formatted in Python."""
    lines = [f"Step {step_idx}:\n"]
    # The C++ reference's body list is LIFO: the newest body prints first.
    for i in range(n_real - 1, -1, -1):
        lines.append(
            "  Body %d: Pos(%.4f, %.4f, %.4f)  Rot(%.4f, %.4f, %.4f, %.4f)  "
            "LinVel(%.4f, %.4f, %.4f)  AngVel(%.4f, %.4f, %.4f)\n"
            % (i + 1, pos[i, 0], pos[i, 1], pos[i, 2],
               quat[i, 0], quat[i, 1], quat[i, 2], quat[i, 3],
               linvel[i, 0], linvel[i, 1], linvel[i, 2],
               angvel[i, 0], angvel[i, 1], angvel[i, 2]))
    return "".join(lines)


def format_step(step_idx: int, pos, quat, linvel, angvel, n_real: int) -> str:
    """The body dump of one step: native where available, else Python."""
    text = format_step_native(step_idx, pos, quat, linvel, angvel, n_real)
    if text is None:
        text = format_step_python(step_idx, pos, quat, linvel, angvel, n_real)
    return text
