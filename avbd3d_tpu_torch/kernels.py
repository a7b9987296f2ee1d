"""Build, bind and launch the CUDA kernels of ``csrc/``.

The sources are compiled at first use with ``nvcc``, one process per source
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``.  The library lands in ``_build/`` beside
this file (listed in .gitignore), named by a hash of the sources, headers
and flags, so an edited source is rebuilt; the build's nvcc/ptxas log is
kept beside it (``.log``) and read back when the library is found built.
A failed build raises.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` and no fast math, so every
float operation rounds as the plain PyTorch versions' ops do (the integer
outputs of the step kernel then match them exactly; csrc/avbd_common.cuh).

Kernels allocate nothing: the launch functions here allocate outputs and
scratch with ``torch.empty`` (the scratch that K2, K7 and the refresh
kernels hand between their own blocks is held per stream: ``_scratch``), check device,
dtype, shape and contiguity of every operand, launch on the current stream
and raise if the C entry point returns a CUDA error.  The parameter block
of a SolverParams is built once (``_fparams``).  Each launch function's
host time goes into ``utils.host_spans`` by its kernel id
(``host_spans.call``): ``<id>.prep`` from its entry to its ctypes call,
``<id>.call`` the call.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time

import torch

from .utils import host_spans

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
_SOURCES = ("step_kernel.cu", "grid_kernels.cu", "control_lanes.cu", "bp_probe.cu",
            "bp_refresh.cu", "grid_stages.cu", "fused_stages.cu")
_HEADERS = ("avbd_common.cuh", "step_kernel.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

# Order of the float parameter block (struct KParams in csrc/avbd_common.cuh).
_PARAM_NAMES = (
    "dt", "inv_dt2", "gdt2_0", "gdt2_1", "gdt2_2", "grav_0", "grav_1", "grav_2",
    "ghat_0", "ghat_1", "ghat_2", "g_len", "has_gravity", "half_dt", "alpha",
    "beta2", "beta_ang", "gamma", "decay", "penalty_min", "penalty_max",
    "manifold_penalty_cap", "collision_margin", "precull_margin",
    "stick_thresh_sq", "penetration_slop", "normal_contact_margin", "ws2", "st2",
    "warmstart_normal_min_dot", "stick_normal_min_dot", "normal_force_cap",
    "linear_damping", "angular_damping", "max_angular_speed", "relaxation",
    "reach_const", "fall_freeze_y", "has_fall_freeze", "post_stabilize", "beta",
    "joint_penalty_cap", "joint_dual_rate", "joint_ema_rate",
)


class _Lib:
    """The loaded library plus its build record."""

    def __init__(self, cdll, path, build_seconds, log):
        self.cdll = cdll
        self.path = path
        self.build_seconds = build_seconds
        self.log = log


_LIBS = {}        # extra -D defines (none: the main build) -> _Lib
_ACTIVE = None    # the library the launch functions use; None: the main build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def build(force: bool = False, defines: tuple = ()) -> _Lib:
    """Compile csrc/ (if needed) and load the library; returns it.

    ``defines`` ("NAME=VALUE" strings) builds another library with those
    compile-time choices, for checks and comparisons only, never the main
    path: ``AVBD_RACE_DELAY=ns`` makes odd thread blocks of the resident
    kernels sleep before each read of other blocks' poses and each pose
    write (the race check); ``AVBD_FIN_BLOCKS=b``, ``AVBD_PRED_BLOCKS=b``
    and ``AVBD_BAL_BLOCKS=b`` launch k_grid_finalize, k_grid_predict and
    k_ballistic_step on b blocks and ``AVBD_GATES_THREADS=t`` k_step_gates
    on blocks of t threads (the checks and timings of their geometry).  The launch
    functions use such a library only inside ``using(lib)``."""
    defines = tuple(defines)
    if not force and defines in _LIBS:
        return _LIBS[defines]
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    h = hashlib.sha256(" ".join(flags).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    os.makedirs(_BUILD, exist_ok=True)
    path = os.path.join(_BUILD, f"libavbd3d_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = load_build_log(path)
    if force or not os.path.exists(path):
        log = ""
        nvcc = _nvcc()
        stem = path[:-len(".so")]
        objs = [f"{stem}.{os.path.splitext(src)[0]}.{os.getpid()}.o" for src in _SOURCES]
        procs = [subprocess.Popen([nvcc, *flags, "-c", os.path.join(_CSRC, src), "-o", obj],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_SOURCES, objs)]
        failed = []
        for src, proc in zip(_SOURCES, procs):
            out, _ = proc.communicate()
            log += f"== {src}\n{out}"
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        for obj in objs:
            os.remove(obj)
        store_build_log(path, log)
        os.replace(tmp, path)
    cdll = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    cdll.avbd_n_params.argtypes = []
    cdll.avbd_n_params.restype = ci
    cdll.avbd_step.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_float),
                               ci, ci, ci, ci, ci, ci, ci, ci, ci, ctypes.POINTER(ci), vp]
    cdll.avbd_step.restype = ci
    cdll.avbd_collide.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_float),
                                  ci, ci, ci, vp]
    cdll.avbd_collide.restype = ci
    cdll.avbd_solve_loop.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_float),
                                     ci, ci, ci, ci, ci, ctypes.POINTER(ci), vp]
    cdll.avbd_solve_loop.restype = ci
    cdll.avbd_control_lanes.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_float),
                                        ci, ci, ci, vp]
    cdll.avbd_control_lanes.restype = ci
    cdll.avbd_bp_probe.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_float),
                                   ci, ci, vp]
    cdll.avbd_bp_probe.restype = ci
    cdll.avbd_collide_grid.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_float),
                                       ci, ci, ci, vp]
    cdll.avbd_collide_grid.restype = ci
    cdll.avbd_iterblock_grid.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_float),
                                         ci, ci, ci, ci, ctypes.POINTER(ci),
                                         ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ci), vp]
    cdll.avbd_iterblock_grid.restype = ci
    cdll.avbd_bp_tables.argtypes = [ctypes.POINTER(vp), ci, ci, ctypes.c_float, vp]
    cdll.avbd_bp_tables.restype = ci
    cdll.avbd_bp_lists.argtypes = [ctypes.POINTER(vp), ci, ci, ci, ci, ci, ci, ctypes.c_float,
                                   ci, ci, vp]
    cdll.avbd_bp_lists.restype = ci
    cdll.avbd_refresh_needed.argtypes = [ctypes.POINTER(vp), ci, ctypes.c_float, ctypes.c_float,
                                         vp]
    cdll.avbd_refresh_needed.restype = ci
    cf = ctypes.c_float
    cdll.avbd_grid_gates.argtypes = [ctypes.POINTER(vp), ci, cf, cf, cf, cf, cf, vp]
    cdll.avbd_grid_gates.restype = ci
    cdll.avbd_grid_predict.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(cf), ci, ci, vp]
    cdll.avbd_grid_predict.restype = ci
    cdll.avbd_grid_finalize.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(cf), ci, ci, ci, vp]
    cdll.avbd_grid_finalize.restype = ci
    cdll.avbd_step_gates.argtypes = [ctypes.POINTER(vp), ci, cf, vp]
    cdll.avbd_step_gates.restype = ci
    cdll.avbd_launch_floor.argtypes = [ctypes.POINTER(vp), ci, ci, cf, vp]
    cdll.avbd_launch_floor.restype = ci
    cdll.avbd_ballistic_step.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(cf), ci, ci, vp]
    cdll.avbd_ballistic_step.restype = ci
    if cdll.avbd_n_params() != len(_PARAM_NAMES):
        raise RuntimeError(
            f"parameter block mismatch: kernel {cdll.avbd_n_params()} floats, "
            f"binding {len(_PARAM_NAMES)}")
    lib = _LIBS[defines] = _Lib(cdll, path, time.perf_counter() - t0, log)
    return lib


def _log_path(lib_path: str) -> str:
    return os.path.splitext(lib_path)[0] + ".log"


def store_build_log(lib_path: str, log: str) -> None:
    """Writes a build's nvcc/ptxas log beside the library it built (same
    stem, ``.log``), whole or not at all, before the library appears, so
    a process that finds the library cached finds its log too."""
    dest = _log_path(lib_path)
    tmp = f"{dest}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(log)
    os.replace(tmp, dest)


def load_build_log(lib_path: str) -> str:
    """The log ``store_build_log`` kept for the library at ``lib_path``;
    "" where there is none (a library built before logs were kept)."""
    try:
        with open(_log_path(lib_path)) as f:
            return f.read()
    except FileNotFoundError:
        return ""


def _lib() -> _Lib:
    return _ACTIVE if _ACTIVE is not None else build()


@contextlib.contextmanager
def using(lib: _Lib):
    """Route every launch through ``lib`` (a build of ``build``) inside the
    block."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, lib
    try:
        yield lib
    finally:
        _ACTIVE = before


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of every kernel in a ``ptxas -v`` log:
    {kernel name: {"registers": r, "spill_bytes": stores + loads}}, the name
    demangled as far as its identifier and its integer and bool template
    arguments (``_Z8k_sweepsILi768EEv4Dims...`` -> ``k_sweeps<768>``,
    ``_Z14k_joint_sweepsILi512ELb0EEv...`` -> ``k_joint_sweeps<512, false>``)."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            sym = m.group(1)
            mm = re.match(r"_Z(\d+)", sym)
            name = sym
            if mm:
                end = mm.end() + int(mm.group(1))
                targs = re.match(r"I((?:L[ib]\d+E)+)E", sym[end:])
                name = sym[mm.end():end]
                if targs:
                    vals = [("true" if v == "1" else "false") if t == "b" else v
                            for t, v in re.findall(r"L([ib])(\d+)E", targs.group(1))]
                    name += "<" + ", ".join(vals) + ">"
            usage[name] = {"registers": None, "spill_bytes": None}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage


def _plan_arg(plan):
    """A ``solver_cuda.SweepPlan`` as the 6 ints the entry points take
    (``struct SweepPlan`` order)."""
    return (ctypes.c_int * 6)(plan.tile, plan.threads, plan.slots_per_thread,
                              plan.smem_bytes, plan.cluster, plan.grid)


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
        "beta": params.beta,
        "joint_penalty_cap": params.joint_penalty_cap,
        "joint_dual_rate": params.joint_dual_rate,
        "joint_ema_rate": params.joint_ema_rate,
    }
    return [vals[k] for k in _PARAM_NAMES]


def probe_reach_const(params) -> float:
    """K7's reach constant: its plain version writes 4 * dt * dt * |g|, the
    control lanes' (KParams.reach_const) 4 * dt**2 * |g|; the two can
    differ in the last bit before rounding to float32, so the probe's
    parameter block holds its own."""
    g_len = float(sum(x * x for x in params.gravity) ** 0.5)
    return 4.0 * params.dt * params.dt * g_len


@functools.lru_cache(maxsize=8)
def _fparams(params, probe: bool = False):
    """The parameter block of ``params`` as the ctypes float array the entry
    points take (``probe``: K7's, with ``probe_reach_const``).  A
    SolverParams is frozen, so its block is built once and kept; the cache
    holds the blocks of the last 8 (params, probe) pairs."""
    vals = param_block(params)
    if probe:
        vals[_PARAM_NAMES.index("reach_const")] = probe_reach_const(params)
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
    """The data pointers of ``tensors`` as the entry points take them (None:
    a null pointer)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() if t is not None else None
                                              for t in tensors])


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_SCRATCH = {}   # (device index, stream handle, name) -> tensor

# Bodies a block of K2 and K7 takes (LANES_WARPS, PROBE_WARPS: a warp a body)
# and K2's partials a block (LANE_PARTS), as control_lanes.cu and bp_probe.cu
# define them; they size the scratch.
_WARP_BODIES = 8
_LANE_PARTS = 8


def _blocks(n: int) -> int:
    return -(-n // _WARP_BODIES)


def _scratch(dev, stream: int, name: str, numel: int, dtype):
    """A buffer a kernel passes between its own blocks within one launch
    (per-block partials, a second pass's per-body values, the ticket by
    which the last block finds itself, 0 before and after every launch).
    Held per (device, stream), where launches run in order, and grown
    when a larger world comes; zeroed when made."""
    key = (dev.index, stream, name)
    t = _SCRATCH.get(key)
    if t is None or t.numel() < numel:
        t = _SCRATCH[key] = torch.zeros(numel, dtype=dtype, device=dev)
    return t


def _raise_on(code, what):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _body_operands(b, n_groups, device, names, lead=()):
    """The body fields ``names`` of ``b``, checked; ``lead``: a leading
    batch shape."""
    f32 = torch.float32
    shapes = {"pos": (3,), "quat": (4,), "size": (3,), "radius": (), "linvel": (3,),
              "angvel": (3,), "prev_linvel": (3,), "prev_angvel": (3,), "mass": (),
              "inv_mass": (),
              "friction": (), "inertia": (3,), "inv_inertia": (3,)}
    return [_check(getattr(b, k), k, lead + shapes[k] + (n_groups, 128), f32, device)
            for k in names]


_CACHE_SHAPES = ((), (), (4,), (4, 3), (4, 3), (3,), (4,), (4,), (4,), (4,), (12,), (12,))


def _cache_operands(cache_args, dc, g, device, stick=torch.float32):
    """The 12 cache leaves (the stick latches as ``stick``: float32 0 / 1, or
    the cache's own bool), checked."""
    types = [torch.int32] * 3 + [torch.float32] * 3 + [stick] + [torch.float32] * 5
    return [_check(t, f"cache[{j}]", s + (dc, g, 128), dt, device)
            for j, (t, s, dt) in enumerate(zip(cache_args, _CACHE_SHAPES, types))]


def _empty_as(tensors):
    """Uninitialised outputs shaped as ``tensors``; ``torch.empty`` is one
    dispatcher op where ``empty_like`` is two, once per output per step."""
    return [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]


def _cuda_device(b):
    dev = b.pos.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels need CUDA tensors")
    return dev


# Kernel operands of the joint and spring rows (the reference's _JFIELDS and
# _SFIELDS, solver_tpu.py:766-767, 785-786): leading component shape and dtype.
JOINT_FIELDS = (("other", (), torch.int32), ("world", (), torch.int32),
                ("side", (), torch.int32), ("anchor_a", (3,), torch.float32),
                ("anchor_b", (3,), torch.float32), ("rest", (4,), torch.float32),
                ("stiff_lin", (), torch.float32), ("stiff_ang", (), torch.float32),
                ("rmotor", (6,), torch.float32), ("lam", (6,), torch.float32),
                ("penalty", (6,), torch.float32))
SPRING_FIELDS = (("other", (), torch.int32), ("world", (), torch.int32),
                 ("side", (), torch.int32), ("anchor_a", (3,), torch.float32),
                 ("anchor_b", (3,), torch.float32), ("rrest", (), torch.float32),
                 ("rstiff", (), torch.float32), ("penalty", (), torch.float32))


def _row_operands(rows, fields, width, g, device, what):
    """A joint / spring container's slot leaves, checked; placeholders when
    the world has none (the kernel reads them only when its width > 0)."""
    if width == 0:
        return [torch.empty((0,), dtype=dt, device=device) for _n, _s, dt in fields]
    return [_check(getattr(rows, name), f"{what}.{name}", s + (width, g, 128), dt, device)
            for name, s, dt in fields]


def launch_step(cache_args, nb, key, thr, b, anchor, anchor_quat, params,
                n_main: int, k_rebuild: int, cand, joints=None, springs=None,
                n_colors: int = 1, *, plan):
    """Run the fused step kernel with the sweep plan ``plan``
    (``solver_cuda.sweep_plan``).  ``cache_args``: the 12 old cache leaves
    in ``solver_cuda.CACHE_FIELDS`` order, the stick latches the cache's own
    bools; ``joints`` / ``springs``: the containers of a jointed world (None
    or empty otherwise), whose slot leaves follow the contact operands;
    ``cand``: the refresh's directed candidates (() int32), from which
    diag's row 1 holds the step's 16 diagnostics lanes in the state layout
    (pair overflow cand - kept).  Returns (12 new cache leaves, stick
    bool; 6 body leaves; diag (8, 128); (j_lam, j_pen, s_pen) with None for
    an absent family)."""
    t0 = host_spans.begin("K1.prep")
    dev = b.pos.device
    d, g, _ = nb.shape
    dc = cache_args[0].shape[0]
    n = g * 128
    if dc > d:
        raise ValueError(f"cache width {dc} must be <= candidate width {d}")
    f32, i32 = torch.float32, torch.int32
    old = _cache_operands(cache_args, dc, g, dev, stick=torch.bool)
    ins = [_check(nb, "nb", (d, g, 128), i32, dev), _check(key, "key", (d, g, 128), i32, dev),
           _check(thr, "thr", (g, 128), i32, dev)]
    ins += _body_operands(b, g, dev, ("pos", "quat", "size", "radius", "linvel", "angvel",
                                      "prev_linvel", "mass", "inv_mass", "friction",
                                      "inertia", "inv_inertia"))
    ins += [_check(anchor, "anchor", (3, g, 128), f32, dev),
            _check(anchor_quat, "anchor_quat", (4, g, 128), f32, dev)]
    cand = _check(cand, "cand", (), i32, dev)
    lib = _card_lib(dev)
    new = _empty_as(old)
    body_out = [torch.empty((c, g, 128), dtype=f32, device=dev) for c in (3, 4, 3, 3, 3, 3)]
    diag = torch.empty((8, 128), dtype=f32, device=dev)
    scratch = [torch.empty(s, dtype=f32, device=dev)
               for s in ((3, n), (4, n), (36, dc, n), (24, n))]
    scratch += [torch.empty((dc, n), dtype=i32, device=dev),
                torch.empty((3,), dtype=i32, device=dev)]
    tensors = old + ins + new + body_out + [diag] + scratch
    tensors += [cand, torch.empty((4, dc, n), dtype=f32, device=dev)]
    dj = joints.dj if joints is not None else 0
    ds = springs.ds if springs is not None else 0
    row_out = (None, None, None)
    if dj or ds:
        tensors += _row_operands(joints, JOINT_FIELDS, dj, g, dev, "joints")
        tensors.append(_check(joints.color, "joints.color", (g, 128), i32, dev) if dj
                       else torch.empty((0,), dtype=i32, device=dev))
        tensors += _row_operands(springs, SPRING_FIELDS, ds, g, dev, "springs")
        row_out = (torch.empty((6, dj, g, 128), dtype=f32, device=dev) if dj else None,
                   torch.empty((6, dj, g, 128), dtype=f32, device=dev) if dj else None,
                   torch.empty((ds, g, 128), dtype=f32, device=dev) if ds else None)
        tensors += [t if t is not None else torch.empty((0,), dtype=f32, device=dev)
                    for t in row_out]
        tensors += [torch.empty(s, dtype=f32, device=dev) for s in ((3, n), (4, n))]
    iters_end = n_main + (1 if params.post_stabilize else 0)
    code = host_spans.call("K1", t0, lib.cdll.avbd_step,
                           _ptrs(tensors), _fparams(params), n, d, dc, dj, ds, int(n_colors),
                           int(n_main), int(iters_end), int(k_rebuild), _plan_arg(plan),
                           _stream(dev))
    _raise_on(code, "step kernel launch")
    return new, tuple(body_out), diag, row_out


def launch_collide(cache_args, nb, key, thr, b, params):
    """Run K3, the collide half of the step kernel.  Returns (12 new cache
    leaves, kept directed slots () int32, dropped manifolds () int32)."""
    t0 = host_spans.begin("K3.prep")
    lib = _lib()
    dev = _cuda_device(b)
    d, g, _ = nb.shape
    dc = cache_args[0].shape[0]
    if dc > d:
        raise ValueError(f"cache width {dc} must be <= candidate width {d}")
    i32 = torch.int32
    old = _cache_operands(cache_args, dc, g, dev)
    ins = [_check(nb, "nb", (d, g, 128), i32, dev), _check(key, "key", (d, g, 128), i32, dev),
           _check(thr, "thr", (g, 128), i32, dev)]
    ins += _body_operands(b, g, dev, ("pos", "quat", "size", "inv_mass"))
    new = _empty_as(old)
    counters = torch.empty((3,), dtype=i32, device=dev)
    tensors = old + ins + new + [torch.empty((dc, g * 128), dtype=i32, device=dev), counters]
    code = host_spans.call("K3", t0, lib.cdll.avbd_collide,
                           _ptrs(tensors), _fparams(params), g * 128, d, dc, _stream(dev))
    _raise_on(code, "collide kernel launch")
    return new, counters[0], counters[1]


def launch_solve_loop(cache_args, b, params, n_main: int, k_rebuild: int, *, plan):
    """Run K4, the solve half of the step kernel for a contact-only world,
    with the sweep plan ``plan``.
    Returns (6 body leaves, lam, penalty, stick (0/1 float32), diag (8, 128)
    with lanes 0-8 filled)."""
    t0 = host_spans.begin("K4.prep")
    lib = _lib()
    dev = _cuda_device(b)
    dc, g, _ = cache_args[0].shape
    n = g * 128
    f32 = torch.float32
    cache = _cache_operands(cache_args, dc, g, dev)
    ins = _body_operands(b, g, dev, ("pos", "quat", "linvel", "angvel", "prev_linvel", "mass",
                                     "inv_mass", "friction", "inertia", "inv_inertia"))
    body_out = [torch.empty((c, g, 128), dtype=f32, device=dev) for c in (3, 4, 3, 3, 3, 3)]
    rows = _empty_as([cache[10], cache[11], cache[6]])
    diag = torch.empty((8, 128), dtype=f32, device=dev)
    scratch = [torch.empty(s, dtype=f32, device=dev)
               for s in ((3, n), (4, n), (36, dc, n), (24, n))]
    scratch.append(torch.empty((3,), dtype=torch.int32, device=dev))
    tensors = cache + ins + body_out + rows + [diag] + scratch
    iters_end = n_main + (1 if params.post_stabilize else 0)
    code = host_spans.call("K4", t0, lib.cdll.avbd_solve_loop,
                           _ptrs(tensors), _fparams(params), n, dc, int(n_main), int(iters_end),
                           int(k_rebuild), _plan_arg(plan), _stream(dev))
    _raise_on(code, "solve-loop kernel launch")
    return tuple(body_out), rows[0], rows[1], rows[2], diag


def launch_control(nb, b, anchor, anchor_quat, params, out=None):
    """Run the control-lanes kernel; returns the (5,) float32 lanes, or
    (B, 5) for a batch of B worlds (every operand with a leading B).
    ``out``: a contiguous (5,) float32 tensor (a view, e.g. lanes 11-15 of
    a diagnostics vector) the kernel writes the lanes into, returned."""
    t0 = host_spans.begin("K2.prep")
    dev = b.pos.device
    lead = tuple(nb.shape[:-3])
    batch = lead[0] if lead else 1
    d, g, _ = nb.shape[-3:]
    f32 = torch.float32
    ins = [_check(nb, "nb", lead + (d, g, 128), torch.int32, dev)]
    ins += _body_operands(b, g, dev, ("pos", "quat", "size", "radius", "linvel", "angvel",
                                      "inv_mass"), lead)
    ins += [_check(anchor, "anchor", lead + (3, g, 128), f32, dev),
            _check(anchor_quat, "anchor_quat", lead + (4, g, 128), f32, dev)]
    n = g * 128
    if out is not None:
        _check(out, "out", lead + (5,), f32, dev)
    lib = _card_lib(dev)
    if out is None:
        out = torch.empty(lead + (5,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = [_scratch(dev, stream, "lanes_part", batch * _LANE_PARTS * _blocks(n), f32),
               _scratch(dev, stream, "lanes_dv", batch * 4 * n, f32),
               _scratch(dev, stream, "lanes_ticket", batch, torch.int32)]
    code = host_spans.call("K2", t0, lib.cdll.avbd_control_lanes,
                           _ptrs(ins + [out] + scratch), _fparams(params), n, d, batch,
                           ctypes.c_void_p(stream))
    _raise_on(code, "control-lanes kernel launch")
    return out


def launch_bp_probe(nb, b, params):
    """Run K7, the broadphase probe; returns (min_sep () f32, n_slots ()
    int32, near (G, 128) bool)."""
    t0 = host_spans.begin("K7.prep")
    lib = _lib()
    dev = _cuda_device(b)
    d, g, _ = nb.shape
    ins = [_check(nb, "nb", (d, g, 128), torch.int32, dev)]
    ins += _body_operands(b, g, dev, ("pos", "quat", "size", "radius", "linvel", "angvel"))
    n = g * 128
    min_sep = torch.empty((), dtype=torch.float32, device=dev)
    n_slots = torch.empty((), dtype=torch.int32, device=dev)
    near = torch.empty((g, 128), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = [_scratch(dev, stream, "probe_min", _blocks(n), torch.float32),
               _scratch(dev, stream, "probe_cnt", _blocks(n), torch.int32),
               _scratch(dev, stream, "probe_ticket", 1, torch.int32)]
    code = host_spans.call("K7", t0, lib.cdll.avbd_bp_probe,
                           _ptrs(ins + [min_sep, n_slots, near] + scratch),
                           _fparams(params, probe=True), n, d, ctypes.c_void_p(stream))
    _raise_on(code, "broadphase probe kernel launch")
    return min_sep, n_slots, near


def launch_collide_grid(cache_args, nb, key, thr, b, params):
    """Run K5, the grid tier's collide.  ``cache_args``: the 12 old cache
    leaves (stick as float32).  Returns (12 new cache leaves, kept mask
    (D, G, 128) f32, once mask (DC, G, 128) bool, dropped manifolds () i32)."""
    t0 = host_spans.begin("K5.prep")
    lib = _lib()
    dev = _cuda_device(b)
    d, g, _ = nb.shape
    dc = cache_args[0].shape[0]
    if dc > d:
        raise ValueError(f"cache width {dc} must be <= candidate width {d}")
    i32 = torch.int32
    old = _cache_operands(cache_args, dc, g, dev)
    ins = [_check(nb, "nb", (d, g, 128), i32, dev), _check(key, "key", (d, g, 128), i32, dev),
           _check(thr, "thr", (g, 128), i32, dev)]
    ins += _body_operands(b, g, dev, ("pos", "quat", "size", "inv_mass"))
    new = _empty_as(old)
    keptmask = torch.empty((d, g, 128), dtype=torch.float32, device=dev)
    once = torch.empty((dc, g, 128), dtype=torch.bool, device=dev)
    nbc = torch.empty((dc, g, 128), dtype=i32, device=dev)
    counters = torch.empty((3,), dtype=i32, device=dev)
    tensors = old + ins + new + [keptmask, once, nbc, counters]
    code = host_spans.call("K5", t0, lib.cdll.avbd_collide_grid,
                           _ptrs(tensors), _fparams(params), g * 128, d, dc, _stream(dev))
    _raise_on(code, "grid collide kernel launch")
    return new, keptmask, once, counters[1]


def launch_iterblock_grid(contacts, b, pos, quat, lam, pen, stickf, ip, iq, params,
                          blk: int, spec, *, plan):
    """Run K6 with the sweep plan ``plan``: ``len(spec)`` iterations, (alpha,
    do_dual, rebuild, ramp) each, from the launch-start poses, partners
    outside a slot's logical block of ``blk`` bodies read at those poses.  Returns (pos, quat, lam,
    pen, stick f32, sep (4, DC, G, 128))."""
    t0 = host_spans.begin("K6.prep")
    lib = _lib()
    dev = _cuda_device(b)
    dc, g, _ = contacts.other.shape
    n = g * 128
    if blk <= 0 or n % blk:
        raise ValueError(f"logical block of {blk} bodies does not divide N = {n}")
    f32, i32 = torch.float32, torch.int32
    slot = (dc, g, 128)
    ins = [_check(contacts.other, "other", slot, i32, dev),
           _check(contacts.count, "count", slot, i32, dev),
           _check(contacts.r_a, "r_a", (4, 3) + slot, f32, dev),
           _check(contacts.r_b, "r_b", (4, 3) + slot, f32, dev),
           _check(contacts.normal, "normal", (3,) + slot, f32, dev)]
    ins += [_check(getattr(contacts, k), k, (4,) + slot, f32, dev)
            for k in ("c0_n", "c0_t1", "c0_t2")]
    carry = [_check(pos, "pos", (3, g, 128), f32, dev), _check(quat, "quat", (4, g, 128), f32, dev),
             _check(lam, "lam", (12,) + slot, f32, dev), _check(pen, "pen", (12,) + slot, f32, dev),
             _check(stickf, "stick", (4,) + slot, f32, dev)]
    ins += carry
    ins += _body_operands(b, g, dev, ("mass", "inv_mass", "friction", "inertia", "inv_inertia"))
    ins += [_check(ip, "ip", (3, g, 128), f32, dev), _check(iq, "iq", (4, g, 128), f32, dev)]
    outs = _empty_as(carry)
    geom = torch.empty((36,) + slot, dtype=f32, device=dev)
    scratch = [geom, torch.empty((24, n), dtype=f32, device=dev)]
    flags = (ctypes.c_int * (3 * len(spec)))(
        *[int(v) for _a, do_dual, rebuild, ramp in spec for v in (do_dual, rebuild, ramp)])
    alphas = (ctypes.c_float * len(spec))(*[a for a, *_ in spec])
    code = host_spans.call("K6", t0, lib.cdll.avbd_iterblock_grid,
                           _ptrs(ins + outs + scratch), _fparams(params), n, dc, int(blk),
                           len(spec), flags, alphas, _plan_arg(plan), _stream(dev))
    _raise_on(code, "grid iteration kernel launch")
    return tuple(outs) + (geom[24:28],)


# Threads a block of k_bp_tables and k_refresh_needed (csrc/bp_refresh.cu:
# a thread a body) and the largest candidate width of k_bp_lists.
_BP_THREADS = 256
BP_MAX_DEGREE = 64
# Keys a row's selection buffer holds in k_bp_lists (BPL_CAP); a fuller row
# is cut to its D smallest.
BP_ROW_BUFFER = 2 * BP_MAX_DEGREE
# Rows a block of k_bp_lists may take (csrc/bp_refresh.cu: 8 warps; 32, 16
# and 8 rows: 4, 2 or 1 a warp; 4 and 2 rows: each row's columns split over
# 2 or 4 warps).
BP_ROWS_PER_BLOCK = (32, 16, 8, 4, 2)


def bp_rows_per_block(n_rows: int, batch: int, sms: int) -> int:
    """Rows a block of k_bp_lists: the most that still give the SMs 1.5
    blocks each (each block reads the column table once from L2, so more
    rows a block move fewer bytes; fewer blocks leave SMs idle), else the
    fewest (more warps on each row).  On an H100 (132 SMs) that is the
    fastest of the five at N = 1024, 2048, 5120 and 16384 (PERF.md §6)."""
    for r in BP_ROWS_PER_BLOCK:
        if n_rows % r == 0 and 2 * (n_rows // r) * batch >= 3 * sms:
            return r
    return BP_ROWS_PER_BLOCK[-1]


def _card_lib(dev) -> _Lib:
    """The library, once the operands (checked first) lie on a card."""
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels need CUDA tensors")
    return _lib()


def launch_bp_tables(pos, quat, ext, ext_scale: float, radius, dyn_key):
    """Run k_bp_tables: the broadphase's per-body table (N, 8) float32,
    (centre, radius, world-AABB halves, dynamic 1 / 0), and the largest
    half extent () float32; the halves are ``ext * ext_scale``, dynamic is
    ``dyn_key > 0``.  With a leading batch axis B on every operand, B
    tables and (B,) maxima (one launch)."""
    t0 = host_spans.begin("R.prep")
    dev = pos.device
    lead = tuple(pos.shape[:-3])
    batch = lead[0] if lead else 1
    g = radius.shape[-2]
    n = g * 128
    f32 = torch.float32
    ins = [_check(pos, "pos", lead + (3, g, 128), f32, dev),
           _check(quat, "quat", lead + (4, g, 128), f32, dev),
           _check(ext, "ext", lead + (3, g, 128), f32, dev),
           _check(radius, "radius", lead + (g, 128), f32, dev),
           _check(dyn_key, "dyn_key", lead + (g, 128), f32, dev)]
    lib = _card_lib(dev)
    table = torch.empty(lead + (n, 8), dtype=f32, device=dev)
    max_wh = torch.empty(lead, dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    blocks = -(-n // _BP_THREADS)
    scratch = [_scratch(dev, stream, "bp_part_max", batch * blocks, f32),
               _scratch(dev, stream, "bp_tables_ticket", batch, torch.int32)]
    code = host_spans.call("R", t0, lib.cdll.avbd_bp_tables,
                           _ptrs(ins + [table, max_wh] + scratch), n, batch,
                           ctypes.c_float(ext_scale), ctypes.c_void_p(stream))
    _raise_on(code, "broadphase tables kernel launch")
    return table, max_wh


def launch_bp_lists(rows, cols, max_wh, exclusions, degree: int, margin: float, row0: int = 0,
                    rows_per_block: int = 0):
    """Run k_bp_lists: the candidate lists of the rows of table ``rows``
    (n_rows, 8) (global ids ``row0`` ..) against every body of table
    ``cols`` (N, 8), keys packed with ``max_wh`` and N; ``exclusions`` (E,
    G_rows, 128) int32.  Returns nb, key (D, G_rows, 128) int32, thr
    (G_rows, 128) int32, cand, slack, kept, dropped (() int32, f32, int32,
    int32; over these rows).  With a leading batch axis B on every
    operand, each world's (one launch).  ``rows_per_block`` (one of
    ``BP_ROWS_PER_BLOCK``; 0: ``bp_rows_per_block``'s choice) sets the
    blocks' rows; the results do not depend on it."""
    t0 = host_spans.begin("R.prep")
    dev = rows.device
    if not 1 <= degree <= BP_MAX_DEGREE:
        raise ValueError(f"candidate width {degree} outside 1..{BP_MAX_DEGREE}")
    lead = tuple(rows.shape[:-2])
    batch = lead[0] if lead else 1
    n_rows, n = rows.shape[-2], cols.shape[-2]
    if n_rows % 128 or n % 128 or n_rows > n:
        raise ValueError(f"tables of {n_rows} rows and {n} columns: multiples of 128, rows <= "
                         "columns expected")
    g = n_rows // 128
    n_excl = exclusions.shape[-3] if exclusions.dim() == len(lead) + 3 else 0
    if rows_per_block and rows_per_block not in BP_ROWS_PER_BLOCK:
        raise ValueError(f"rows a block {rows_per_block}: one of {BP_ROWS_PER_BLOCK} expected")
    f32, i32 = torch.float32, torch.int32
    ins = [_check(rows, "rows", lead + (n_rows, 8), f32, dev),
           _check(cols, "cols", lead + (n, 8), f32, dev),
           _check(max_wh, "max_wh", lead, f32, dev),
           _check(exclusions, "exclusions", lead + (n_excl, g, 128), i32, dev)]
    lib = _card_lib(dev)
    nb = torch.empty(lead + (degree, g, 128), dtype=i32, device=dev)
    key = torch.empty(lead + (degree, g, 128), dtype=i32, device=dev)
    thr = torch.empty(lead + (g, 128), dtype=i32, device=dev)
    counts = torch.empty(lead + (3,), dtype=i32, device=dev)
    slack = torch.empty(lead, dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rpb = rows_per_block or bp_rows_per_block(
        n_rows, batch, torch.cuda.get_device_properties(dev).multi_processor_count)
    blocks = n_rows // rpb
    scratch = [_scratch(dev, stream, "bp_part_cnt", batch * 2 * blocks, i32),
               _scratch(dev, stream, "bp_part_slack", batch * blocks, f32),
               _scratch(dev, stream, "bp_lists_ticket", batch, i32)]
    q_max = (2**31 - 1) // n - 1
    code = host_spans.call("R", t0, lib.cdll.avbd_bp_lists,
                           _ptrs(ins + [nb, key, thr, counts, slack] + scratch), n_rows, n,
                           int(row0), int(degree), n_excl, q_max, ctypes.c_float(margin), batch,
                           rpb, ctypes.c_void_p(stream))
    _raise_on(code, "broadphase lists kernel launch")
    cand, kept, dropped = counts.unbind(-1)
    return nb, key, thr, cand, slack, kept, dropped


def launch_refresh_needed(b, anchor, anchor_quat, slack, margin: float):
    """Run k_refresh_needed on the Bodies ``b`` against the cache anchors:
    returns (need () bool, (dev_mm, dev_raw) (2,) float32), need =
    dev_mm > 0.5 * margin or dev_raw > slack + margin in float32."""
    t0 = host_spans.begin("P.prep")
    dev = b.pos.device
    g = b.mass.shape[-2]
    n = g * 128
    f32 = torch.float32
    ins = _body_operands(b, g, dev, ("pos", "quat", "radius", "inv_mass"))
    ins += [_check(anchor, "anchor", (3, g, 128), f32, dev),
            _check(anchor_quat, "anchor_quat", (4, g, 128), f32, dev),
            _check(slack, "slack", (), f32, dev)]
    lib = _card_lib(dev)
    devs = torch.empty((2,), dtype=f32, device=dev)
    need = torch.empty((), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = [_scratch(dev, stream, "refresh_part", _LANE_PARTS * _blocks(n), f32),
               _scratch(dev, stream, "refresh_dv", 4 * n, f32),
               _scratch(dev, stream, "refresh_ticket", 1, torch.int32)]
    code = host_spans.call("P", t0, lib.cdll.avbd_refresh_needed,
                           _ptrs(ins + [devs, need] + scratch), n, ctypes.c_float(0.5 * margin),
                           ctypes.c_float(margin), ctypes.c_void_p(stream))
    _raise_on(code, "refresh predicate kernel launch")
    return need, devs


# Threads a block of k_grid_gates (csrc/grid_stages.cu, avbd_common.cuh:
# STAGE_THREADS).
_GS_THREADS = 256


def launch_grid_gates(b, anchor, anchor_quat, slack, params):
    """Run k_grid_gates on the Bodies ``b`` against the cache anchors: the
    fall-freeze (when ``params.fall_freeze_y`` > -1e8), the refresh
    predicate and the unrefined speed gates in one launch.  Returns (linvel,
    angvel, inv_mass: the frozen fields, or ``b``'s own without the freeze;
    out (6,) float32: need, stale_ok, calm as 1 / 0, dev_mm, dev_raw, the
    largest v^2 of a dynamic body)."""
    t0 = host_spans.begin("G.prep")
    dev = b.pos.device
    g = b.mass.shape[-2]
    n = g * 128
    f32 = torch.float32
    ins = _body_operands(b, g, dev, ("pos", "quat", "linvel", "angvel", "inv_mass", "radius"))
    ins += [_check(anchor, "anchor", (3, g, 128), f32, dev),
            _check(anchor_quat, "anchor_quat", (4, g, 128), f32, dev),
            _check(slack, "slack", (), f32, dev)]
    lib = _card_lib(dev)
    freeze = params.fall_freeze_y > -1.0e8
    frozen = _empty_as(ins[2:5]) if freeze else [None] * 3
    out = torch.empty((6,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = [_scratch(dev, stream, "gates_part", _LANE_PARTS * _blocks(n), f32),
               _scratch(dev, stream, "gates_part_dev", -(-n // _GS_THREADS), f32),
               _scratch(dev, stream, "gates_ticket", 1, torch.int32)]
    ptrs = (ctypes.c_void_p * 16)(*[t.data_ptr() for t in ins],
                                   *[t.data_ptr() if t is not None else None for t in frozen],
                                   out.data_ptr(), *[t.data_ptr() for t in scratch])
    calm = min(params.impact_speed_min, params.lhs_stale_speed_max)
    code = host_spans.call("G", t0, lib.cdll.avbd_grid_gates,
                           ptrs, n, float(params.fall_freeze_y), 0.5 * params.bp_margin,
                           float(params.bp_margin), params.lhs_stale_speed_max**2, calm**2,
                           ctypes.c_void_p(stream))
    _raise_on(code, "grid gates kernel launch")
    lv, av, im = (f if f is not None else t for f, t in zip(frozen, ins[2:5]))
    return lv, av, im, out


def launch_grid_predict(b, stick, params):
    """Run k_grid_predict: the grid step's prediction from the Bodies ``b``
    and the contact cache's stick latches (4, DC, G, 128) bool.  Returns
    (linvel, angvel (3, G, 128) sanitized, ip (3, G, 128), iq (4, G, 128),
    ps (3, G, 128), stick as 0 / 1 float32, rows sanitized () int32)."""
    t0 = host_spans.begin("PR.prep")
    dev = b.pos.device
    g = b.mass.shape[-2]
    n = g * 128
    dc = stick.shape[1]
    f32 = torch.float32
    ins = _body_operands(b, g, dev, ("pos", "quat", "linvel", "angvel", "prev_linvel",
                                     "inv_mass"))
    ins.append(_check(stick, "stick", (4, dc, g, 128), torch.bool, dev))
    lib = _card_lib(dev)
    outs = [torch.empty((c, g, 128), dtype=f32, device=dev) for c in (3, 3, 3, 4, 3)]
    outs.append(torch.empty((4, dc, g, 128), dtype=f32, device=dev))
    outs.append(torch.empty((), dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    fold = _scratch(dev, stream, "predict_fold_ticket", 1, torch.int64)   # count and ticket
    code = host_spans.call("PR", t0, lib.cdll.avbd_grid_predict,
                           _ptrs(ins + outs + [fold]), _fparams(params), n, 4 * dc,
                           ctypes.c_void_p(stream))
    _raise_on(code, "grid predict kernel launch")
    return tuple(outs)


def launch_grid_finalize(b, pos, quat, linvel, angvel, sanitized, contacts, sep, once, kept,
                         cand, dropped, params):
    """Run k_grid_finalize: the pose sanitizes and finalize of a grid step.
    ``b``: the step's Bodies; ``pos`` / ``quat``: K6's last poses;
    ``linvel`` / ``angvel``: the prediction's sanitized velocities;
    ``sanitized``: its count; ``contacts``: the cache after the step, stick
    latches as K6's 0 / 1 floats; ``sep`` (4, DC, G, 128): K6's last
    separations; ``once`` (DC, G, 128) bool and ``kept`` (D, G, 128) float32:
    K5's masks; ``cand`` / ``dropped``: the refresh's candidates and K5's
    dropped manifolds (() int32).  Returns (pos, quat, linvel, angvel,
    prev_linvel, prev_angvel, stick bool, the 16 diagnostics lanes)."""
    t0 = host_spans.begin("FN.prep")
    dev = b.pos.device
    g = b.mass.shape[-2]
    n = g * 128
    dc = contacts.other.shape[0]
    d = kept.shape[0]
    f32, i32 = torch.float32, torch.int32
    slot = (dc, g, 128)
    ins = [_check(pos, "pos", (3, g, 128), f32, dev), _check(quat, "quat", (4, g, 128), f32, dev)]
    ins += _body_operands(b, g, dev, ("pos", "quat", "linvel", "angvel"))
    ins += [_check(linvel, "linvel", (3, g, 128), f32, dev),
            _check(angvel, "angvel", (3, g, 128), f32, dev)]
    ins += _body_operands(b, g, dev, ("prev_linvel", "prev_angvel", "inv_mass"))
    ins += [_check(sanitized, "sanitized", (), i32, dev),
            _check(contacts.count, "count", slot, i32, dev),
            _check(contacts.other, "other", slot, i32, dev),
            _check(sep, "sep", (4,) + slot, f32, dev),
            _check(contacts.lam, "lam", (12,) + slot, f32, dev),
            _check(once, "once", slot, torch.bool, dev),
            _check(contacts.stick, "stick", (4,) + slot, f32, dev),
            _check(kept, "kept", (d, g, 128), f32, dev),
            _check(cand, "cand", (), i32, dev),
            _check(dropped, "dropped", (), i32, dev)]
    lib = _card_lib(dev)
    outs = [torch.empty((c, g, 128), dtype=f32, device=dev) for c in (3, 4, 3, 3, 3, 3)]
    outs.append(torch.empty((4,) + slot, dtype=torch.bool, device=dev))
    outs.append(torch.empty((16,), dtype=f32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    fold = _scratch(dev, stream, "finalize_fold_ticket", 11, i32)   # 10 words, the ticket
    code = host_spans.call("FN", t0, lib.cdll.avbd_grid_finalize,
                           _ptrs(ins + outs + [fold]), _fparams(params), n, dc, d,
                           ctypes.c_void_p(stream))
    _raise_on(code, "grid finalize kernel launch")
    return tuple(outs)


def launch_step_gates(b, diag, slack, dropped, params):
    """Run k_step_gates on the Bodies ``b``: the fall-freeze (when
    ``params.fall_freeze_y`` > -1e8) and the step's control vector.
    ``diag``: the world's 16 diagnostics lanes; ``slack`` / ``dropped``: its
    broadphase cache's (() float32 / int32).  Returns (linvel, angvel,
    inv_mass: the frozen fields in new tensors, or ``b``'s own without the
    freeze; out (18,) float32: lanes 0-15, slack, dropped)."""
    t0 = host_spans.begin("SG.prep")
    dev = b.pos.device
    g = b.mass.shape[-2]
    n = g * 128
    ins = _body_operands(b, g, dev, ("pos", "linvel", "angvel", "inv_mass"))
    ins += [_check(diag, "diag", (16,), torch.float32, dev),
            _check(slack, "slack", (), torch.float32, dev),
            _check(dropped, "dropped", (), torch.int32, dev)]
    lib = _card_lib(dev)
    freeze = params.fall_freeze_y > -1.0e8
    frozen = _empty_as(ins[1:4]) if freeze else [None] * 3
    out = torch.empty((18,), dtype=torch.float32, device=dev)
    code = host_spans.call("SG", t0, lib.cdll.avbd_step_gates,
                           _ptrs(ins + frozen + [out]), n, float(params.fall_freeze_y),
                           _stream(dev))
    _raise_on(code, "step gates kernel launch")
    lv, av, im = (f if f is not None else t for f, t in zip(frozen, ins[1:4]))
    return lv, av, im, out


def launch_floor(b, src, dst, loads: int, freeze_y: float):
    """Run k_launch_floor at k_step_gates' grid and block with the
    fall-freeze on, for the Bodies ``b`` (N of them) and float32 ``src`` /
    ``dst`` of 7 N floats each: ``loads`` 0, empty (the least a launch of
    that shape takes on the card); 1, a thread copying a float of ``src``
    to ``dst`` (a load and a store); 3, k_step_gates' own access to the
    bodies without its control vector: a thread loading its body's
    inv_mass and pos.y and its float of ``src`` before its one store, the
    float zeroed where the body is below ``freeze_y``."""
    dev = b.pos.device
    g = b.mass.shape[-2]
    n = g * 128
    f32 = torch.float32
    ins = [_check(src, "src", src.shape, f32, dev),
           _check(b.inv_mass, "inv_mass", (g, 128), f32, dev),
           _check(b.pos, "pos", (3, g, 128), f32, dev),
           _check(dst, "dst", src.shape, f32, dev)]
    if src.numel() != 7 * n or loads not in (0, 1, 3):
        raise ValueError(f"launch floor: {src.numel()} floats for N = {n}, {loads} loads")
    lib = _card_lib(dev)
    code = lib.cdll.avbd_launch_floor(_ptrs(ins), n, loads, float(freeze_y), _stream(dev))
    _raise_on(code, "launch floor kernel launch")


def launch_ballistic_step(b, contacts, params):
    """Run k_ballistic_step: the ballistic step of the Bodies ``b`` but its
    control lanes, reading ``contacts.count`` / ``other`` / ``lam`` as the
    cache holds them.  Returns (pos, quat, linvel, angvel, prev_linvel,
    prev_angvel, diag (16,) float32 with lanes 11-15 at CONTROL_RESET)."""
    t0 = host_spans.begin("BS.prep")
    dev = b.pos.device
    g = b.mass.shape[-2]
    n = g * 128
    dc = contacts.other.shape[0]
    f32, i32 = torch.float32, torch.int32
    slot = (dc, g, 128)
    ins = _body_operands(b, g, dev, ("pos", "quat", "linvel", "angvel", "prev_linvel",
                                     "prev_angvel", "inv_mass"))
    ins += [_check(contacts.count, "count", slot, i32, dev),
            _check(contacts.other, "other", slot, i32, dev),
            _check(contacts.lam, "lam", (12,) + slot, f32, dev)]
    lib = _card_lib(dev)
    outs = [torch.empty((c, g, 128), dtype=f32, device=dev) for c in (3, 4, 3, 3, 3, 3)]
    outs.append(torch.empty((16,), dtype=f32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    fold = _scratch(dev, stream, "ballistic_fold_ticket", 8, i32)   # 7 words, the ticket
    code = host_spans.call("BS", t0, lib.cdll.avbd_ballistic_step,
                           _ptrs(ins + outs + [fold]), _fparams(params), n, dc,
                           ctypes.c_void_p(stream))
    _raise_on(code, "ballistic step kernel launch")
    return tuple(outs)
