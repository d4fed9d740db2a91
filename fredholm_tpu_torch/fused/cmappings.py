"""Component-form sample mappings + sampler draws.

Port of fredholm_tpu/fused/cmappings.py (sampling.cu:47-110, cmj.cu,
sobol.cu:10661-10742). uint32 planes are int64 tensors (core/rng.py).
"""

from __future__ import annotations

import math

import torch

from ..core.rng import mul32, u32, xxhash32_4
from ..sampling.cmj import CMJ_M, CMJ_N, cmj_permute_pow2, cmj_randfloat
from ..sampling.sobol import sobol_owen_float
from .cvec import V3, normalize


def draw_sobol_1d(sample_idx, dim: int, seed):
    """Owen-Sobol 1D draw at dimension `dim` (sampling.cu:19-22)."""
    return sobol_owen_float(sample_idx, int(dim), seed)


def draw_cmj_2d(n_spp, image_idx, depth: int, scramble):
    """CMJ 2D draw at dimension slot `depth` (cmj.cu:60-82); returns
    (fx, fy)."""
    n_spp = u32(n_spp)
    index = n_spp % (CMJ_M * CMJ_N)
    key = xxhash32_4(n_spp // (CMJ_M * CMJ_N), image_idx, depth, scramble)
    index_p = cmj_permute_pow2(index, CMJ_M * CMJ_N, mul32(key, 0x51633E2D))
    sx = cmj_permute_pow2(index_p % CMJ_M, CMJ_M, mul32(key, 0xA511E9B3))
    sy = cmj_permute_pow2(index_p // CMJ_M, CMJ_N, mul32(key, 0x63D83595))
    jx = cmj_randfloat(index_p, mul32(key, 0xA399D265))
    jy = cmj_randfloat(index_p, mul32(key, 0x711AD6A5))
    f32 = torch.float32
    fx = (
        (index_p % CMJ_M).to(f32) + (sy.to(f32) + jx) / CMJ_N
    ) / CMJ_M
    fy = (
        (index_p // CMJ_M).to(f32) + (sx.to(f32) + jy) / CMJ_M
    ) / CMJ_N
    return fx, fy


def sample_concentric_disk(u0, u1):
    """Shirley-Chiu concentric disk map (sampling.cu:54-64); returns (x, y)."""
    x = 2.0 * u0 - 1.0
    y = 2.0 * u1 - 1.0
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)
    safe_x = torch.where(x == 0.0, 1.0, x)
    safe_y = torch.where(y == 0.0, 1.0, y)
    theta = torch.where(
        use_x,
        0.25 * math.pi * (y / safe_x),
        0.5 * math.pi - 0.25 * math.pi * (x / safe_y),
    )
    px = r * torch.cos(theta)
    py = r * torch.sin(theta)
    degenerate = (x == 0.0) & (y == 0.0)
    return torch.where(degenerate, 0.0, px), torch.where(degenerate, 0.0, py)


def sample_cosine_weighted_hemisphere(u0, u1) -> V3:
    """Cosine hemisphere about +Y (sampling.cu:66-78)."""
    x, z = sample_concentric_disk(u0, u1)
    y = torch.sqrt(torch.clamp(1.0 - x * x - z * z, min=0.0))
    return V3(x, y, z)


def sample_triangle(u0, u1):
    """Uniform barycentrics (sampling.cu:80-84); returns (b0, b1)."""
    su0 = torch.sqrt(u0)
    return 1.0 - su0, u1 * su0


def sample_vndf(wo: V3, ax, ay, u0, u1) -> V3:
    """Heitz 2018 GGX visible-normal sampling (sampling.cu:87-110)."""
    vh = normalize(V3(ax * wo.x, wo.y, ay * wo.z))

    lensq = vh.x * vh.x + vh.z * vh.z
    inv_len = torch.where(lensq > 0.0, 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-30)), 0.0)
    has_len = lensq > 0.0
    t1 = V3(
        torch.where(has_len, vh.z * inv_len, 0.0),
        torch.zeros_like(vh.y),
        torch.where(has_len, -vh.x * inv_len, 1.0),
    )
    t2 = V3(
        vh.y * t1.z - vh.z * t1.y,
        vh.z * t1.x - vh.x * t1.z,
        vh.x * t1.y - vh.y * t1.x,
    )

    r = torch.sqrt(u0)
    phi = 2.0 * math.pi * u1
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh.y)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = V3(
        p1 * t1.x + p2 * t2.x + p3 * vh.x,
        p1 * t1.y + p2 * t2.y + p3 * vh.y,
        p1 * t1.z + p2 * t2.z + p3 * vh.z,
    )
    return normalize(V3(ax * nh.x, torch.clamp(nh.y, min=0.0), ay * nh.z))
