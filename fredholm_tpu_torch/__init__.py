"""fredholm_tpu_torch: the PyTorch/CUDA port of fredholm_tpu.

Renders dense scenes (<= 1024 faces) and clustered ones (the cluster
hierarchy, up to 4096 superclusters) under a constant or Hosek sky, with
area lights and a directional sun, through hand-written CUDA kernels on
an NVIDIA GPU (csrc/) or their plain PyTorch twins on the CPU. Imports
torch and numpy only, never jax and never the fredholm_tpu package.
"""

__version__ = "0.2.0"

from .camera import Camera  # noqa: F401
from .renderer import Renderer  # noqa: F401
from .scene.procedural import (  # noqa: F401
    cornell_box,
    furnace_sphere,
    hosek_sweep_scene,
    sphere_array_test,
    sphere_grid_test,
    terrain,
)
from .scene.types import Material, Scene  # noqa: F401

__all__ = ["Camera", "Material", "Renderer", "Scene", "cornell_box",
           "furnace_sphere", "hosek_sweep_scene", "sphere_array_test",
           "sphere_grid_test", "terrain"]
