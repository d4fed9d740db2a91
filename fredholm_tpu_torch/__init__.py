"""fredholm_tpu_torch: the PyTorch/CUDA port of fredholm_tpu.

Slice 1 renders dense scenes (<= 1024 faces) under a constant sky with
area lights, through hand-written CUDA kernels on an NVIDIA GPU
(csrc/) or their plain PyTorch twins on the CPU. Imports torch and numpy
only, never jax and never the fredholm_tpu package.
"""

__version__ = "0.1.0"

from .camera import Camera  # noqa: F401
from .renderer import Renderer  # noqa: F401
from .scene.procedural import cornell_box  # noqa: F401
from .scene.types import Material, Scene  # noqa: F401

__all__ = ["Camera", "Material", "Renderer", "Scene", "cornell_box"]
