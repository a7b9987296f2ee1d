"""Build, bind and launch the CUDA kernels of ``csrc/``.

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``_build/`` beside this file (listed in .gitignore), named by a hash of the
sources and flags, so an edited source is rebuilt.  A failed build raises.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` and no fast math, so every
float operation rounds as the plain PyTorch versions' ops do (the integer
outputs of the step kernel then match them exactly; csrc/avbd_common.cuh).

Kernels allocate nothing: the launch functions here allocate outputs and
scratch with ``torch.empty``, check device, dtype, shape and contiguity of
every operand, launch on the current stream and raise if the C entry point
returns a CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
_SOURCES = ("step_kernel.cu", "control_lanes.cu")
_HEADERS = ("avbd_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# Order of the float parameter block (struct KParams in csrc/avbd_common.cuh).
_PARAM_NAMES = (
    "dt", "inv_dt2", "gdt2_0", "gdt2_1", "gdt2_2", "grav_0", "grav_1", "grav_2",
    "ghat_0", "ghat_1", "ghat_2", "g_len", "has_gravity", "half_dt", "alpha",
    "beta2", "beta_ang", "gamma", "decay", "penalty_min", "penalty_max",
    "manifold_penalty_cap", "collision_margin", "precull_margin",
    "stick_thresh_sq", "penetration_slop", "normal_contact_margin", "ws2", "st2",
    "warmstart_normal_min_dot", "stick_normal_min_dot", "normal_force_cap",
    "linear_damping", "angular_damping", "max_angular_speed", "relaxation",
    "reach_const", "fall_freeze_y", "has_fall_freeze", "post_stabilize",
)


class _Lib:
    """The loaded library plus its build record."""

    def __init__(self, cdll, path, build_seconds, log):
        self.cdll = cdll
        self.path = path
        self.build_seconds = build_seconds
        self.log = log


_LIB = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def build(force: bool = False) -> _Lib:
    """Compile csrc/ (if needed) and load the library; returns it."""
    global _LIB
    if _LIB is not None and not force:
        return _LIB
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    os.makedirs(_BUILD, exist_ok=True)
    path = os.path.join(_BUILD, f"libavbd3d_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if force or not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp] + [os.path.join(_CSRC, s) for s in _SOURCES]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    cdll = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    cdll.avbd_n_params.argtypes = []
    cdll.avbd_n_params.restype = ci
    cdll.avbd_step.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_float),
                               ci, ci, ci, ci, ci, ci, vp]
    cdll.avbd_step.restype = ci
    cdll.avbd_control_lanes.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_float),
                                        ci, ci, vp]
    cdll.avbd_control_lanes.restype = ci
    if cdll.avbd_n_params() != len(_PARAM_NAMES):
        raise RuntimeError(
            f"parameter block mismatch: kernel {cdll.avbd_n_params()} floats, "
            f"binding {len(_PARAM_NAMES)}")
    _LIB = _Lib(cdll, path, time.perf_counter() - t0, log)
    return _LIB


def param_block(params) -> list:
    """The float parameters in KParams order, each computed as the plain
    version computes it (Python double arithmetic, then float32)."""
    dt = params.dt
    grav = params.gravity
    g_len = float(sum(x * x for x in grav) ** 0.5)
    ghat = tuple(x / g_len for x in grav) if g_len > 1e-5 else (0.0, 0.0, 0.0)
    vals = {
        "dt": dt, "inv_dt2": 1.0 / (dt * dt),
        "gdt2_0": grav[0] * dt * dt, "gdt2_1": grav[1] * dt * dt,
        "gdt2_2": grav[2] * dt * dt,
        "grav_0": grav[0], "grav_1": grav[1], "grav_2": grav[2],
        "ghat_0": ghat[0], "ghat_1": ghat[1], "ghat_2": ghat[2],
        "g_len": g_len, "has_gravity": 1.0 if g_len > 1e-5 else 0.0,
        "half_dt": 0.5 * dt, "alpha": params.alpha,
        "beta2": params.beta * 2.0,
        "beta_ang": params.beta * params.angular_beta_scale,
        "gamma": params.gamma, "decay": params.alpha * params.gamma,
        "penalty_min": params.penalty_min, "penalty_max": params.penalty_max,
        "manifold_penalty_cap": params.manifold_penalty_cap,
        "collision_margin": params.collision_margin,
        "precull_margin": params.collision_margin + 1.0e-4,
        "stick_thresh_sq": params.stick_thresh**2,
        "penetration_slop": params.penetration_slop,
        "normal_contact_margin": params.normal_contact_margin,
        "ws2": params.warmstart_max_drift**2,
        "st2": params.stick_anchor_max_drift**2,
        "warmstart_normal_min_dot": params.warmstart_normal_min_dot,
        "stick_normal_min_dot": params.stick_normal_min_dot,
        "normal_force_cap": params.normal_force_cap,
        "linear_damping": params.linear_damping,
        "angular_damping": params.angular_damping,
        "max_angular_speed": params.max_angular_speed,
        "relaxation": params.relaxation,
        "reach_const": 4.0 * params.dt**2 * g_len,
        "fall_freeze_y": params.fall_freeze_y,
        "has_fall_freeze": 1.0 if params.fall_freeze_y > -1.0e8 else 0.0,
        "post_stabilize": 1.0 if params.post_stabilize else 0.0,
    }
    return [vals[k] for k in _PARAM_NAMES]


def _fparams(params):
    vals = param_block(params)
    return (ctypes.c_float * len(vals))(*vals)


def _check(t, name, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t


def _ptrs(tensors):
    arr = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    return arr


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(code, what):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _body_operands(b, n_groups, device, names):
    f32 = torch.float32
    shapes = {"pos": (3,), "quat": (4,), "size": (3,), "radius": (), "linvel": (3,),
              "angvel": (3,), "prev_linvel": (3,), "mass": (), "inv_mass": (),
              "friction": (), "inertia": (3,), "inv_inertia": (3,)}
    return [_check(getattr(b, k), k, shapes[k] + (n_groups, 128), f32, device)
            for k in names]


def launch_step(cache_args, nb, key, thr, b, anchor, anchor_quat, params,
                n_main: int, k_rebuild: int):
    """Run the fused step kernel.  ``cache_args``: the 12 old cache leaves
    (stick as float32).  Returns (12 new cache leaves, 6 body leaves,
    diag (8, 128))."""
    lib = build()
    dev = b.pos.device
    if dev.type != "cuda":
        raise ValueError("launch_step needs CUDA tensors")
    d, g, _ = nb.shape
    dc = cache_args[0].shape[0]
    n = g * 128
    if dc > d:
        raise ValueError(f"cache width {dc} must be <= candidate width {d}")
    f32, i32 = torch.float32, torch.int32
    cache_shapes = [(dc,), (dc,), (4, dc), (4, 3, dc), (4, 3, dc), (3, dc), (4, dc),
                    (4, dc), (4, dc), (4, dc), (12, dc), (12, dc)]
    cache_types = [i32, i32, i32] + [f32] * 9
    old = [_check(t, f"cache[{j}]", s + (g, 128), dt, dev)
           for j, (t, s, dt) in enumerate(zip(cache_args, cache_shapes, cache_types))]
    ins = [_check(nb, "nb", (d, g, 128), i32, dev), _check(key, "key", (d, g, 128), i32, dev),
           _check(thr, "thr", (g, 128), i32, dev)]
    ins += _body_operands(b, g, dev, ("pos", "quat", "size", "radius", "linvel", "angvel",
                                      "prev_linvel", "mass", "inv_mass", "friction",
                                      "inertia", "inv_inertia"))
    ins += [_check(anchor, "anchor", (3, g, 128), f32, dev),
            _check(anchor_quat, "anchor_quat", (4, g, 128), f32, dev)]
    new = [torch.empty(s + (g, 128), dtype=dt, device=dev)
           for s, dt in zip(cache_shapes, cache_types)]
    body_out = [torch.empty((c, g, 128), dtype=f32, device=dev) for c in (3, 4, 3, 3, 3, 3)]
    diag = torch.empty((8, 128), dtype=f32, device=dev)
    scratch = [torch.empty(s, dtype=f32, device=dev)
               for s in ((3, n), (4, n), (36, dc, n), (24, n))]
    scratch += [torch.empty((dc, n), dtype=i32, device=dev),
                torch.empty((3,), dtype=i32, device=dev)]
    tensors = old + ins + new + body_out + [diag] + scratch
    iters_end = n_main + (1 if params.post_stabilize else 0)
    code = lib.cdll.avbd_step(_ptrs(tensors), _fparams(params), n, d, dc, int(n_main),
                              int(iters_end), int(k_rebuild), _stream(dev))
    _raise_on(code, "step kernel launch")
    return new, tuple(body_out), diag


def launch_control(nb, b, anchor, anchor_quat, params):
    """Run the control-lanes kernel; returns the (5,) float32 lanes."""
    lib = build()
    dev = b.pos.device
    if dev.type != "cuda":
        raise ValueError("launch_control needs CUDA tensors")
    d, g, _ = nb.shape
    f32 = torch.float32
    ins = [_check(nb, "nb", (d, g, 128), torch.int32, dev)]
    ins += _body_operands(b, g, dev, ("pos", "quat", "size", "radius", "linvel", "angvel",
                                      "inv_mass"))
    ins += [_check(anchor, "anchor", (3, g, 128), f32, dev),
            _check(anchor_quat, "anchor_quat", (4, g, 128), f32, dev)]
    out = torch.empty((5,), dtype=f32, device=dev)
    code = lib.cdll.avbd_control_lanes(_ptrs(ins + [out]), _fparams(params), g * 128, d,
                                       _stream(dev))
    _raise_on(code, "control-lanes kernel launch")
    return out
