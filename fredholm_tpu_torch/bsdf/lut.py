"""Directional-albedo lookup tables.

Port of fredholm_tpu/bsdf/lut.py: the 16x16 GGX reflection table (F0=1
and Schlick-tail channels) and the 16x16 sheen table, read by path from
the reference's assets/lut_*.npy, and their bilinear fetches
(lut.cu:965-1081 semantics).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# torch lookups (lut.py:198-262): bilinear with a truncated base index,
# over stacked tensors (the wavefront integrator's BSDF). The fused
# pipeline's column form fetches by weighted sums (fused/cbsdf.py).


def _bilinear_fetch_2d(table, u, v):
    """table [S, S] or [S, S, C] on the device of u; u, v [...] in [0, 1]."""
    size = table.shape[0]
    i = torch.clamp((u * size).to(torch.int32), 0, size - 1)
    j = torch.clamp((v * size).to(torch.int32), 0, size - 1)
    i1 = torch.clamp(i + 1, max=size - 1)
    j1 = torch.clamp(j + 1, max=size - 1)
    hx = u * size - i
    hy = v * size - j
    il, jl, i1l, j1l = (x.to(torch.int64) for x in (i, j, i1, j1))
    t0 = table[il, jl]
    t1 = table[i1l, jl]
    t2 = table[il, j1l]
    t3 = table[i1l, j1l]
    if table.dim() == 3:
        hx = hx[..., None]
        hy = hy[..., None]
    tx0 = (1.0 - hx) * t0 + hx * t1
    tx1 = (1.0 - hx) * t2 + hx * t3
    return (1.0 - hy) * tx0 + hy * tx1


@functools.lru_cache(maxsize=8)
def device_table(name: str, device: torch.device) -> torch.Tensor:
    """The "reflection" [16, 16, 2] or "sheen" [16, 16] table on `device`,
    contiguous, copied once (a copy per fetch would stall the card's
    queue). The wavefront's fetches and the shading kernel
    (csrc/shade.cu) read them."""
    loader = {"reflection": reflection_lut_np, "sheen": sheen_lut_np}[name]
    return torch.as_tensor(loader(), device=device).contiguous()


def compute_directional_albedo_reflection(wo, roughness, f0):
    """lut.cu:985-994: F0 * R + (1 - F0) * G at (|wo.y|, roughness)."""
    u = torch.abs(wo[..., 1])
    v = torch.clamp(roughness, 0.0, 1.0)
    rg = _bilinear_fetch_2d(device_table("reflection", u.device), u, v)
    return f0 * rg[..., 0] + (1.0 - f0) * rg[..., 1]


def compute_directional_albedo_sheen(wo, roughness):
    """lut.cu:1075-1081."""
    u = torch.abs(wo[..., 1])
    v = torch.clamp(roughness, 0.0, 1.0)
    return _bilinear_fetch_2d(device_table("sheen", u.device), u, v)
