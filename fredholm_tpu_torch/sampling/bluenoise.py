"""Screen-space blue-noise dithered sampling.

Port of fredholm_tpu/sampling/bluenoise.py: every pixel draws from one
shared Owen-scrambled Sobol sequence, rotated (Cranley-Patterson) by its
own value from a void-and-cluster ranking tile and decorrelated across
dimensions by fract(dim * golden ratio):

    u(pixel, index, dim) = fract(sobol_owen(index, dim, seed)
                                 + bn(pixel) + fract(dim * phi))

The tile is the reference's assets/bluenoise_rank_128.npy, read by path.
The dither values and the per-dimension offset are computed in numpy
float32, as the reference computes them, so every draw is bit-equal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..assets import asset_path
from .sobol import sobol_owen_float

_TILE_SIZE = 128
_PHI = 0.6180339887498949  # fract(golden ratio)


@functools.lru_cache(maxsize=1)
def dither_tile() -> np.ndarray:
    """[128, 128] float32 rotation values in [0, 1)."""
    rank = np.load(asset_path("bluenoise_rank_128.npy"))
    return (rank.astype(np.float32) + 0.5) / float(rank.size)


@functools.lru_cache(maxsize=4)
def _device_tile(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(dither_tile(), device=device)


def bn_shift(pixel_i, pixel_j):
    """Per-pixel blue-noise rotation in [0, 1) (one tile gather); pixel
    coordinates as integer tensors."""
    return _device_tile(pixel_i.device)[pixel_j % _TILE_SIZE, pixel_i % _TILE_SIZE]


def _dim_offset(dimension: int) -> float:
    """fract(dim * phi) in float32, as a Python float (exact)."""
    return float(np.fmod(np.float32(dimension) * np.float32(_PHI), np.float32(1.0)))


def blue_noise_1d(shift, index, dimension, frame_seed):
    """1D dithered draw: shift [N] from bn_shift, index [N] the per-pixel
    sample count (uint32 values in int64), frame_seed a uint32. dimension:
    a Python int (returns [N]) or a sequence of D of them (returns [N, D],
    one Sobol pass for all)."""
    base = sobol_owen_float(index, dimension, frame_seed)
    if not isinstance(dimension, (tuple, list)):
        return torch.fmod(base + shift + _dim_offset(dimension), 1.0)
    offset = torch.tensor([_dim_offset(d) for d in dimension], dtype=torch.float32,
                          device=base.device)
    return torch.fmod(base + shift[..., None] + offset, 1.0)


def blue_noise_2d(shift, index, dimension: int, frame_seed):
    """2D dithered draw from the Sobol dimension pair (dim, dim + 1)."""
    return blue_noise_1d(shift, index, (dimension, dimension + 1), frame_seed)
