"""Fresnel terms over stacked tensors: dielectric, conductor, the
artist-friendly metallic map, the polarized variants and Airy thin-film
interference.

Port of fredholm_tpu/bsdf/fresnel.py (bxdf.cu:107-116, :267-424;
Gulbrandsen 2014, Belcour & Barla 2017). Colors are [..., 3]. Constant
factors the reference folds in float32 are folded here in numpy float32,
in its order, so they carry the same bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.vecmath import xyz_to_rgb


def fresnel_schlick(cos, f0):
    """bxdf.cu:267-271."""
    t = torch.clamp(1.0 - cos, min=0.0)
    t2 = t * t
    return f0 + torch.clamp(1.0 - f0, min=0.0) * (t * (t2 * t2))


def fresnel_dielectric(cos, ior):
    """Exact unpolarized dielectric fresnel (bxdf.cu:274-283); ior is the
    relative IOR eta_t / eta_i, cos the |cos| at the interface. 1 under
    total internal reflection."""
    temp = ior * ior + cos * cos - 1.0
    g = torch.sqrt(torch.clamp(temp, min=0.0))
    t0 = (g - cos) / (g + cos)
    t1 = ((g + cos) * cos - 1.0) / ((g - cos) * cos + 1.0)
    fr = 0.5 * t0 * t0 * (1.0 + t1 * t1)
    return torch.where(temp < 0.0, 1.0, fr)


def fresnel_conductor(cos, ior, k):
    """Unpolarized conductor fresnel (bxdf.cu:286-299); ior, k [..., 3]."""
    if cos.dim() < ior.dim():
        cos = cos[..., None]
    c2 = cos * cos
    two_eta_cos = 2.0 * ior * cos
    t0 = ior * ior + k * k
    t1 = t0 * c2
    rs = (t0 - two_eta_cos + c2) / (t0 + two_eta_cos + c2)
    rp = (t1 - two_eta_cos + 1.0) / (t1 + two_eta_cos + 1.0)
    return 0.5 * (rp + rs)


def artist_friendly_metallic_fresnel(reflectivity, edge_tint):
    """Gulbrandsen 2014 (bxdf.cu:107-116): artist (reflectivity, edge tint)
    colors -> physical (n, k)."""
    r = torch.clamp(reflectivity, 0.0, 0.99)
    g = edge_tint
    r_sqrt = torch.sqrt(r)
    n = g * (1.0 - r) / (1.0 + r) + (1.0 - g) * (1.0 + r_sqrt) / (1.0 - r_sqrt)
    t1 = n + 1.0
    t2 = n - 1.0
    k = torch.sqrt(torch.clamp((r * (t1 * t1) - t2 * t2) / (1.0 - r), min=0.0))
    return n, k


# ---------------------------------------------------------------------------
# polarized fresnel + thin film (bxdf.cu:301-424)


def fresnel_dielectric_polarized(cos, ior1, ior2):
    """(R_p, R_s, phi_p, phi_s); bxdf.cu:301-323."""
    sin2 = 1.0 - cos * cos
    eta = ior1 / ior2
    tir = eta * eta * sin2 > 1.0

    inv_eta2 = 1.0 / torch.clamp(eta * eta, min=1e-12)
    s = torch.sqrt(torch.clamp(sin2 - inv_eta2, min=0.0))
    phi_p_tir = 2.0 * torch.atan(-eta * eta * s / torch.clamp(cos, min=1e-12))
    phi_s_tir = 2.0 * torch.atan(-s / torch.clamp(cos, min=1e-12))

    cos2 = torch.sqrt(torch.clamp(1.0 - eta * eta * sin2, min=0.0))
    r_p = (ior2 * cos - ior1 * cos2) / torch.clamp(ior2 * cos + ior1 * cos2, min=1e-12)
    r_s = (ior1 * cos - ior2 * cos2) / torch.clamp(ior1 * cos + ior2 * cos2, min=1e-12)
    phi_p = torch.where(r_p < 0.0, math.pi, 0.0)
    phi_s = torch.where(r_s < 0.0, math.pi, 0.0)

    R_p = torch.where(tir, 1.0, r_p * r_p)
    R_s = torch.where(tir, 1.0, r_s * r_s)
    phi_p = torch.where(tir, phi_p_tir, phi_p)
    phi_s = torch.where(tir, phi_s_tir, phi_s)
    return R_p, R_s, phi_p, phi_s


def fresnel_conductor_polarized(cos, ior1, ior2, k2):
    """(R_p, R_s, phi_p, phi_s) as [..., 3]; bxdf.cu:325-354. ior1 is
    per lane [...] and is lifted to [..., 1]."""
    cos_ = cos[..., None]
    ior1 = torch.broadcast_to(ior1, cos.shape)[..., None]
    a = ior2 * ior2 * (1.0 - k2 * k2) - ior1 * ior1 * (1.0 - cos_ * cos_)
    b2 = 2.0 * ior2 * ior2 * k2
    b = torch.sqrt(torch.clamp(a * a + b2 * b2, min=0.0))
    u = torch.sqrt(torch.clamp(0.5 * (a + b), min=0.0))
    v = torch.sqrt(torch.clamp(0.5 * (b - a), min=0.0))

    def sq(x):
        return x * x

    R_s = (sq(ior1 * cos_ - u) + v * v) / torch.clamp(sq(ior1 * cos_ + u) + v * v, min=1e-12)
    phi_s = torch.atan2(2.0 * ior1 * v * cos_, u * u + v * v - sq(ior1 * cos_)) + math.pi
    R_p = (
        sq(ior2 * ior2 * (1.0 - k2 * k2) * cos_ - ior1 * u)
        + sq(2.0 * ior2 * ior2 * k2 * cos_ - ior1 * v)
    ) / torch.clamp(
        sq(ior2 * ior2 * (1.0 - k2 * k2) * cos_ + ior1 * u)
        + sq(2.0 * ior2 * ior2 * k2 * cos_ + ior1 * v),
        min=1e-12,
    )
    phi_p = torch.atan2(
        2.0 * ior1 * ior2 * ior2 * cos_ * (2.0 * k2 * u - (1.0 - k2 * k2) * v),
        sq(ior2 * ior2 * (1.0 + k2 * k2) * cos_) - ior1 * ior1 * (u * u + v * v),
    )

    # pure-dielectric layers fall back to the scalar polarized formula
    is_dielectric = (k2 == 0.0).all(dim=-1)[..., None]
    dp, ds, dphi_p, dphi_s = fresnel_dielectric_polarized(cos, ior1[..., 0], ior2[..., 0])
    R_p = torch.where(is_dielectric, dp[..., None], R_p)
    R_s = torch.where(is_dielectric, ds[..., None], R_s)
    phi_p = torch.where(is_dielectric, dphi_p[..., None], phi_p)
    phi_s = torch.where(is_dielectric, dphi_s[..., None], phi_s)
    return R_p, R_s, phi_p, phi_s


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


# CIE observer as three gaussians in OPD space (bxdf.cu:357-371), with the
# constant factor val * sqrt(2 pi var) folded in float32 as jnp folds it
_SENS_POS = (1.6810e6, 1.7953e6, 2.2084e6)
_SENS_VAR = (4.3278e9, 9.3046e9, 6.6121e9)
_SENS_SCALE = tuple(float(x) for x in _f32([5.4856e-13, 4.4201e-13, 5.2481e-13])
                    * np.sqrt(_f32(2.0 * math.pi) * _f32(_SENS_VAR)))
_X_EXTRA_SCALE = float(np.float32(9.7470e-14) * np.sqrt(np.float32(2.0 * math.pi * 4.5282e9)))


def _eval_sensitivity(opd, shift):
    """Spectral sensitivity in RGB (bxdf.cu:357-371); opd [...], shift
    [..., 3]."""
    phase = 2.0 * math.pi * opd
    chans = []
    for c in range(3):
        x = (_SENS_SCALE[c] * torch.cos(_SENS_POS[c] * phase + shift[..., c])
             * torch.exp(-_SENS_VAR[c] * phase * phase))
        if c == 0:
            x = x + (_X_EXTRA_SCALE * torch.cos(2.2399e6 * phase + shift[..., 0])
                     * torch.exp(-4.5282e9 * phase * phase))
        chans.append(x / 1.0685e-7)
    return xyz_to_rgb(torch.stack(chans, dim=-1))


def fresnel_airy(cos, ior1, ior2, thickness_nm, ior3, k3):
    """Airy thin-film interference reflectance (bxdf.cu:375-424). cos, ior1,
    ior2, thickness_nm: [...]; ior3, k3: [..., 3]. Returns [..., 3] in
    [0, 1]."""
    R12p, R12s, phi12p, phi12s = fresnel_dielectric_polarized(cos, ior1, ior2)
    T12p = 1.0 - R12p
    T12s = 1.0 - R12s

    s1 = 1.0 - cos * cos
    eta = ior1 / ior2
    c2 = torch.sqrt(torch.clamp(1.0 - eta * eta * s1, min=0.0))

    phi21p = math.pi - phi12p
    phi21s = math.pi - phi12s

    R23p, R23s, phi23p, phi23s = fresnel_conductor_polarized(cos, ior2, ior3, k3)

    opd = 2.0 * ior2 * (thickness_nm * 1e-9) * c2
    phi2p = phi21p[..., None] + phi23p
    phi2s = phi21s[..., None] + phi23s

    T121p = (T12p * T12p)[..., None]
    Rsp = T121p * R23p / torch.clamp(1.0 - R23p * R12p[..., None], min=1e-12)
    T121s = (T12s * T12s)[..., None]
    Rss = T121s * R23s / torch.clamp(1.0 - R23s * R12s[..., None], min=1e-12)

    intensity = R12p[..., None] + Rsp + R12s[..., None] + Rss

    cmp_ = Rsp - torch.sqrt(T121p)
    cms = Rss - torch.sqrt(T121s)
    for m in range(1, 4):
        cmp_ = cmp_ * torch.sqrt(torch.clamp(R23p * R12p[..., None], min=0.0))
        cms = cms * torch.sqrt(torch.clamp(R23s * R12s[..., None], min=0.0))
        sp = 2.0 * _eval_sensitivity(m * opd, m * phi2p)
        ss = 2.0 * _eval_sensitivity(m * opd, m * phi2s)
        intensity = intensity + (cmp_ * sp + cms * ss)

    return torch.clamp(0.5 * intensity, 0.0, 1.0)
