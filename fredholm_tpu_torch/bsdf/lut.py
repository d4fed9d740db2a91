"""Directional-albedo lookup tables (host numpy loaders only).

Port of the loaders of fredholm_tpu/bsdf/lut.py: the 16x16 GGX reflection
table (F0=1 and Schlick-tail channels) and the 16x16 sheen table, read by
path from the reference's assets/lut_*.npy (lut.cu:965-1081 semantics).
"""

from __future__ import annotations

import functools

import numpy as np

from ..assets import asset_path

LUT_SIZE = 16


@functools.lru_cache(maxsize=1)
def reflection_lut_np() -> np.ndarray:
    """[16, 16, 2] float32 over (cos_theta_o, roughness)."""
    return np.load(asset_path("lut_reflection.npy"))


@functools.lru_cache(maxsize=1)
def sheen_lut_np() -> np.ndarray:
    """[16, 16] float32 sheen directional albedo."""
    return np.load(asset_path("lut_sheen.npy"))
