"""avbd3d_tpu_torch — the AVBD 3D rigid-body engine on PyTorch and CUDA.

A port of ``avbd3d_tpu`` (JAX, the reference) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).  Same state layouts, same
scenes, same step; every device is named explicitly:

    from avbd3d_tpu_torch import load_scene, run_steps
    scene = load_scene("Stress1000", device="cuda")
    world = run_steps(scene.world, scene.params, scene.cap, 300)

On CPU tensors the kernels' plain PyTorch versions run; on CUDA tensors the
kernels (built from ``csrc/`` at first use) run or the call raises.
This package never imports JAX.
"""

from .config import Capacity, SolverParams, default_params
from .models.scenes import SCENE_NAMES, SCENES, Scene, SceneBuilder, load_scene
from .solver import run_steps, step
from .state import Bodies, Contacts, Diagnostics, World

__all__ = [
    "Bodies",
    "Capacity",
    "Contacts",
    "Diagnostics",
    "SCENES",
    "SCENE_NAMES",
    "Scene",
    "SceneBuilder",
    "SolverParams",
    "World",
    "default_params",
    "load_scene",
    "run_steps",
    "step",
]

__version__ = "0.1.0"
