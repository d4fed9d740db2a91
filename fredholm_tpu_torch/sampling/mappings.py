"""Sample-space mappings over stacked tensors: disks, the cosine
hemisphere, triangles, GGX visible normals and the small discrete CDF.

Port of fredholm_tpu/sampling/mappings.py (sampling.cu:47-150); the
column-form twin of the fused pipeline is fused/cmappings.py. Local
frames have +Y as the normal.
"""

from __future__ import annotations

import math

import torch

from ..core.vecmath import cross, normalize, vec3


def sample_uniform_disk(u):
    """sampling.cu:47-52; u [..., 2] -> [..., 2]."""
    r = torch.sqrt(u[..., 0])
    theta = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_concentric_disk(u):
    """Shirley-Chiu concentric disk map (sampling.cu:54-64)."""
    u0 = 2.0 * u - 1.0
    x, y = u0[..., 0], u0[..., 1]
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)
    safe_x = torch.where(x == 0.0, 1.0, x)
    safe_y = torch.where(y == 0.0, 1.0, y)
    theta = torch.where(
        use_x,
        0.25 * math.pi * (y / safe_x),
        0.5 * math.pi - 0.25 * math.pi * (x / safe_y),
    )
    p = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    degenerate = (x == 0.0) & (y == 0.0)
    return torch.where(degenerate[..., None], 0.0, p)


def sample_cosine_weighted_hemisphere(u):
    """Cosine hemisphere about +Y (sampling.cu:66-78); returns [..., 3]."""
    d = sample_concentric_disk(u)
    x, z = d[..., 0], d[..., 1]
    y = torch.sqrt(torch.clamp(1.0 - x * x - z * z, min=0.0))
    return vec3(x, y, z)


def sample_triangle(u):
    """Uniform barycentrics (sampling.cu:80-84); returns [..., 2]."""
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


def sample_vndf(wo, alpha, u):
    """Heitz 2018 GGX visible-normal sampling (sampling.cu:87-110). wo
    [..., 3] local outgoing direction, alpha [..., 2], u [..., 2]; returns
    the sampled half vector."""
    ax = alpha[..., 0]
    ay = alpha[..., 1]
    vh = normalize(vec3(ax * wo[..., 0], wo[..., 1], ay * wo[..., 2]))

    lensq = vh[..., 0] * vh[..., 0] + vh[..., 2] * vh[..., 2]
    inv_len = torch.where(lensq > 0.0, 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-30)), 0.0)
    zero = torch.zeros_like(inv_len)
    t1 = torch.where(
        (lensq > 0.0)[..., None],
        vec3(vh[..., 2] * inv_len, zero, -vh[..., 0] * inv_len),
        vec3(zero, zero, zero + 1.0),
    )
    t2 = cross(vh, t1)

    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 1])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))[..., None] * vh
    )
    return normalize(vec3(ax * nh[..., 0], torch.clamp(nh[..., 1], min=0.0), ay * nh[..., 2]))


def discrete_sample_cdf(weights, u):
    """An index from a small discrete distribution (DiscreteDistribution1D,
    sampling.cu:112-150). weights [..., K] >= 0, u [...]; returns (idx,
    pmf of idx). A batch of total weight 0 gives index K-1 with pmf 0."""
    total = weights.sum(dim=-1, keepdim=True)
    pmf = weights / torch.where(total > 0.0, total, 1.0)
    # the running sum, left to right, column by column: torch.cumsum over
    # a short last axis runs a slow scan kernel on the card
    k = weights.shape[-1]
    cdf = pmf[..., 0]
    idx = (u >= cdf).to(torch.int64)
    for j in range(1, k):
        cdf = cdf + pmf[..., j]
        idx = idx + (u >= cdf)
    idx = torch.clamp(idx, max=k - 1)
    return idx, torch.gather(pmf, -1, idx[..., None])[..., 0]
