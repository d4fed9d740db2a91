"""BxDF lobes over stacked tensors (port of fredholm_tpu/bsdf/lobes.py,
bxdf.cu): Lambert, Oren-Nayar, diffuse transmission, GGX reflection with
dielectric, conductor or thin-film (Airy) fresnel under VNDF sampling,
Walter 2007 rough transmission with its TIR fallback, and the
Estevez-Kulla sheen. Local frames have +Y as the shading normal; lobe
parameters are per lane. `sample` functions return (wi, f, pdf).
"""

from __future__ import annotations

import math

import torch

from ..core.vecmath import dot, normalize, reflect, refract, splat
from ..sampling.mappings import sample_cosine_weighted_hemisphere, sample_vndf
from .fresnel import fresnel_airy, fresnel_conductor, fresnel_dielectric

INV_PI = 1.0 / math.pi


# ---------------------------------------------------------------------------
# shading-frame trig (bxdf.cu:9-79); +Y is the normal


def abs_cos_theta(w):
    return torch.abs(w[..., 1])


def sin2_theta(w):
    return torch.clamp(1.0 - w[..., 1] * w[..., 1], min=0.0)


def sin_theta(w):
    return torch.sqrt(sin2_theta(w))


def sin_phi(w):
    return w[..., 2] / torch.sqrt(torch.clamp(sin2_theta(w), min=1e-20))


def cos_phi(w):
    return w[..., 0] / torch.sqrt(torch.clamp(sin2_theta(w), min=1e-20))


def roughness_to_alpha(roughness, anisotropy):
    """Imageworks remap (bxdf.cu:96-104); returns [..., 2]."""
    r2 = roughness * roughness
    return torch.stack([r2 * (1.0 + anisotropy), r2 * (1.0 - anisotropy)], dim=-1)


# ---------------------------------------------------------------------------
# Lambert (bxdf.cu:119-148)


def lambert_eval(albedo, wo, wi):
    return albedo * INV_PI


def lambert_pdf(wo, wi):
    return abs_cos_theta(wi) * INV_PI


def lambert_sample(albedo, wo, u):
    wi = sample_cosine_weighted_hemisphere(u)
    return wi, lambert_eval(albedo, wo, wi), lambert_pdf(wo, wi)


# ---------------------------------------------------------------------------
# Oren-Nayar (bxdf.cu:151-205) and its flip, diffuse transmission
# (bxdf.cu:209-264)


def oren_nayar_eval(albedo, roughness, wo, wi):
    sigma2 = roughness * roughness
    a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    b = 0.45 * sigma2 / (sigma2 + 0.09)

    s_theta_o = sin_theta(wo)
    s_theta_i = sin_theta(wi)
    both = (s_theta_i > 1e-4) & (s_theta_o > 1e-4)
    c = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo)
    c_max = torch.where(both, torch.clamp(c, min=0.0), 0.0)

    use_i = abs_cos_theta(wi) > abs_cos_theta(wo)
    s_alpha = torch.where(use_i, s_theta_o, s_theta_i)
    t_beta = torch.where(
        use_i,
        s_theta_i / torch.clamp(abs_cos_theta(wi), min=1e-8),
        s_theta_o / torch.clamp(abs_cos_theta(wo), min=1e-8),
    )
    return albedo * ((a + b * c_max * s_alpha * t_beta) * INV_PI)[..., None]


def oren_nayar_pdf(wo, wi):
    return abs_cos_theta(wi) * INV_PI


def oren_nayar_sample(albedo, roughness, wo, u):
    wi = sample_cosine_weighted_hemisphere(u)
    return wi, oren_nayar_eval(albedo, roughness, wo, wi), oren_nayar_pdf(wo, wi)


diffuse_transmission_eval = oren_nayar_eval
diffuse_transmission_pdf = oren_nayar_pdf


def diffuse_transmission_sample(albedo, roughness, wo, u):
    wi = -sample_cosine_weighted_hemisphere(u)
    return wi, oren_nayar_eval(albedo, roughness, wo, wi), oren_nayar_pdf(wo, wi)


# ---------------------------------------------------------------------------
# GGX (bxdf.cu:484-512)


def ggx_d(wh, alpha):
    ax = alpha[..., 0]
    ay = alpha[..., 1]
    t = (
        wh[..., 0] * wh[..., 0] / torch.clamp(ax * ax, min=1e-12)
        + wh[..., 2] * wh[..., 2] / torch.clamp(ay * ay, min=1e-12)
        + wh[..., 1] * wh[..., 1]
    )
    return 1.0 / (math.pi * ax * ay * t * t)


def ggx_lambda(w, alpha):
    ax = alpha[..., 0]
    ay = alpha[..., 1]
    t = (ax * ax * (w[..., 0] * w[..., 0]) + ay * ay * (w[..., 2] * w[..., 2])) / torch.clamp(
        w[..., 1] * w[..., 1], min=1e-12)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + t))


def ggx_g1(w, alpha):
    return 1.0 / (1.0 + ggx_lambda(w, alpha))


def ggx_g2(wo, wi, alpha):
    return 1.0 / (1.0 + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha))


def ggx_d_visible(w, wh, alpha):
    return (
        ggx_g1(w, alpha)
        * torch.abs(dot(w, wh))
        * ggx_d(wh, alpha)
        / torch.clamp(abs_cos_theta(w), min=1e-8)
    )


# ---------------------------------------------------------------------------
# microfacet reflection, dielectric fresnel (bxdf.cu:428-518)


def microfacet_reflection_dielectric_eval(ior, alpha, wo, wi):
    wh = normalize(wo + wi, eps=1e-20)
    f = fresnel_dielectric(torch.abs(dot(wo, wh)), ior)
    d = ggx_d(wh, alpha)
    g = ggx_g2(wo, wi, alpha)
    denom = torch.clamp(abs_cos_theta(wo) * abs_cos_theta(wi), min=1e-8)
    return splat(0.25 * f * d * g / denom)


def microfacet_reflection_dielectric_pdf(alpha, wo, wi):
    wh = normalize(wo + wi, eps=1e-20)
    return 0.25 * ggx_d_visible(wo, wh, alpha) / torch.clamp(torch.abs(dot(wo, wh)), min=1e-8)


def microfacet_reflection_dielectric_sample(ior, alpha, wo, u):
    wh = sample_vndf(wo, alpha, u)
    wi = reflect(wo, wh)
    f = microfacet_reflection_dielectric_eval(ior, alpha, wo, wi)
    pdf = microfacet_reflection_dielectric_pdf(alpha, wo, wi)
    return wi, f, pdf


# ---------------------------------------------------------------------------
# microfacet reflection with the Airy thin-film fresnel (lobes.py:218-254,
# bxdf.cu:428-457 with a film); thickness 0 falls back to the dielectric
# term per lane


def microfacet_reflection_thinfilm_eval(ior, tf_ior, tf_thickness, alpha, wo, wi):
    wh = normalize(wo + wi, eps=1e-20)
    cos_wh = torch.abs(dot(wo, wh))
    f_airy = fresnel_airy(
        cos_wh,
        torch.ones_like(cos_wh),
        tf_ior,
        tf_thickness,
        splat(torch.broadcast_to(ior, cos_wh.shape)),
        torch.zeros(cos_wh.shape + (3,), dtype=cos_wh.dtype, device=cos_wh.device),
    )
    f_plain = splat(fresnel_dielectric(cos_wh, ior))
    f = torch.where((tf_thickness > 0.0)[..., None], f_airy, f_plain)
    d = ggx_d(wh, alpha)
    g = ggx_g2(wo, wi, alpha)
    denom = torch.clamp(abs_cos_theta(wo) * abs_cos_theta(wi), min=1e-8)
    return f * (0.25 * d * g / denom)[..., None]


def microfacet_reflection_thinfilm_sample(ior, tf_ior, tf_thickness, alpha, wo, u):
    wh = sample_vndf(wo, alpha, u)
    wi = reflect(wo, wh)
    f = microfacet_reflection_thinfilm_eval(ior, tf_ior, tf_thickness, alpha, wo, wi)
    pdf = microfacet_reflection_dielectric_pdf(alpha, wo, wi)
    return wi, f, pdf


# ---------------------------------------------------------------------------
# microfacet reflection, conductor fresnel (bxdf.cu:522-611)


def microfacet_reflection_conductor_eval(ior3, k3, alpha, wo, wi):
    wh = normalize(wo + wi, eps=1e-20)
    f = fresnel_conductor(torch.abs(dot(wo, wh)), ior3, k3)
    d = ggx_d(wh, alpha)
    g = ggx_g2(wo, wi, alpha)
    denom = torch.clamp(abs_cos_theta(wo) * abs_cos_theta(wi), min=1e-8)
    return 0.25 * f * (d * g / denom)[..., None]


microfacet_reflection_conductor_pdf = microfacet_reflection_dielectric_pdf


def microfacet_reflection_conductor_sample(ior3, k3, alpha, wo, u):
    wh = sample_vndf(wo, alpha, u)
    wi = reflect(wo, wh)
    f = microfacet_reflection_conductor_eval(ior3, k3, alpha, wo, wi)
    pdf = microfacet_reflection_conductor_pdf(alpha, wo, wi)
    return wi, f, pdf


# ---------------------------------------------------------------------------
# microfacet transmission, Walter 2007 (bxdf.cu:615-740)


def _transmission_half_vector(ior_i, ior_t, wo, wi):
    wh = normalize(-(ior_i[..., None] * wo + ior_t[..., None] * wi), eps=1e-20)
    return torch.where((wh[..., 1] < 0.0)[..., None], -wh, wh)


def microfacet_transmission_eval(ior_i, ior_t, alpha, wo, wi):
    wh = _transmission_half_vector(ior_i, ior_t, wo, wi)
    f = fresnel_dielectric(torch.abs(dot(wo, wh)), ior_t / ior_i)
    d = ggx_d(wh, alpha)
    g = ggx_g2(wo, wi, alpha)
    wo_dot_wh = dot(wo, wh)
    wi_dot_wh = dot(wi, wh)
    t = ior_i * wo_dot_wh + ior_t * wi_dot_wh
    denom = torch.clamp(abs_cos_theta(wo) * abs_cos_theta(wi) * t * t, min=1e-10)
    val = (
        torch.abs(wo_dot_wh)
        * torch.abs(wi_dot_wh)
        * ior_t
        * ior_t
        * torch.clamp(1.0 - f, min=0.0)
        * g
        * d
        / denom
    )
    return splat(val)


def microfacet_transmission_pdf(ior_i, ior_t, alpha, wo, wi):
    wh = _transmission_half_vector(ior_i, ior_t, wo, wi)
    wi_dot_wh = dot(wi, wh)
    t = ior_i * dot(wo, wh) + ior_t * wi_dot_wh
    return (
        ggx_d_visible(wo, wh, alpha)
        * ior_t
        * ior_t
        * torch.abs(wi_dot_wh)
        / torch.clamp(t * t, min=1e-10)
    )


def microfacet_transmission_sample(ior_i, ior_t, alpha, wo, u):
    wh = sample_vndf(wo, alpha, u)
    wt, ok = refract(wo, wh, ior_i, ior_t)

    # total internal reflection fallback (bxdf.cu:659-679)
    wr = reflect(wo, wh)
    fr = fresnel_dielectric(torch.abs(dot(wo, wh)), ior_t / ior_i)
    d = ggx_d(wh, alpha)
    g_r = ggx_g2(wo, wr, alpha)
    denom_r = torch.clamp(abs_cos_theta(wo) * abs_cos_theta(wr), min=1e-8)
    f_tir = splat(0.25 * fr * d * g_r / denom_r)
    pdf_tir = 0.25 * ggx_d_visible(wo, wh, alpha) / torch.clamp(
        torch.abs(dot(wr, wh)), min=1e-8)

    f_t = microfacet_transmission_eval(ior_i, ior_t, alpha, wo, wt)
    pdf_t = microfacet_transmission_pdf(ior_i, ior_t, alpha, wo, wt)

    wi = torch.where(ok[..., None], wt, wr)
    f = torch.where(ok[..., None], f_t, f_tir)
    pdf = torch.where(ok, pdf_t, pdf_tir)
    return wi, f, pdf


# ---------------------------------------------------------------------------
# production sheen (Estevez & Kulla 2017; bxdf.cu:743-822)


def _sheen_l(x, roughness):
    t = 1.0 - roughness
    t2 = t * t

    def interp(p0, p1):
        return t2 * p0 + (1.0 - t2) * p1

    a = interp(25.3245, 21.5473)
    b = interp(3.32435, 3.82987)
    c = interp(0.16801, 0.19823)
    d = interp(-1.27393, -1.97760)
    e = interp(-4.85967, -4.32054)
    if not isinstance(x, torch.Tensor):
        x = torch.full_like(roughness, x)
    return a / (1.0 + b * torch.pow(torch.clamp(x, min=1e-8), c)) + d * x + e


def _sheen_lambda(w, roughness):
    cos = abs_cos_theta(w)
    return torch.where(
        cos < 0.5,
        torch.exp(_sheen_l(cos, roughness)),
        torch.exp(2.0 * _sheen_l(0.5, roughness) - _sheen_l(1.0 - cos, roughness)),
    )


def sheen_d(wh, roughness):
    s = sin_theta(wh)
    inv_r = 1.0 / torch.clamp(roughness, min=1e-4)
    return (2.0 + inv_r) * torch.pow(torch.clamp(s, min=1e-8), inv_r) / (2.0 * math.pi)


def sheen_eval(roughness, wo, wi):
    wh = normalize(wo + wi, eps=1e-20)
    d = sheen_d(wh, roughness)
    g = 1.0 / (1.0 + _sheen_lambda(wo, roughness) + _sheen_lambda(wi, roughness))
    denom = torch.clamp(abs_cos_theta(wo) * abs_cos_theta(wi), min=1e-8)
    return splat(0.25 * d * g / denom)


def sheen_pdf(wo, wi):
    return abs_cos_theta(wi) * INV_PI


def sheen_sample(roughness, wo, u):
    wh = sample_cosine_weighted_hemisphere(u)
    wi = reflect(wo, wh)
    return wi, sheen_eval(roughness, wo, wi), sheen_pdf(wo, wi)
