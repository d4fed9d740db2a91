"""Component-form Arnold-Standard-Surface BSDF (all seven lobes).

Port of fredholm_tpu/fused/cbsdf.py (bsdf.cu + bxdf.cu): the same lobe
set, weights, pmf, guard masks and evaluation order, over V3 component
triples of torch tensors. It is the plain twin of the BSDF inside the
shading kernel (csrc/shade.cu) and the oracle for later kernel work.
The directional-albedo LUT fetches stay gather-free weighted sums over the
16x16 tables, exactly as the reference computes them.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..bsdf import lut as lut_mod
from .cmappings import sample_cosine_weighted_hemisphere, sample_vndf
from .cvec import (
    V3,
    dot,
    normalize,
    reflect,
    refract,
    rgb_to_luminance,
    vsplat,
    where3,
)

INV_PI = 1.0 / math.pi

ALL_LOBES = ("coat", "metal", "specular", "transmission", "sheen",
             "diffuse_t", "diffuse_r")


def _san(v):
    return torch.where(torch.isfinite(v), v, 0.0)


def _san3(v: V3) -> V3:
    return V3(_san(v.x), _san(v.y), _san(v.z))


# ---------------------------------------------------------------------------
# shading-frame trig (bxdf.cu:9-79); +Y is the normal


def abs_cos_theta(w: V3):
    return torch.abs(w.y)


def sin2_theta(w: V3):
    return torch.clamp(1.0 - w.y * w.y, min=0.0)


def sin_theta(w: V3):
    return torch.sqrt(sin2_theta(w))


def sin_phi(w: V3):
    return w.z / torch.sqrt(torch.clamp(sin2_theta(w), min=1e-20))


def cos_phi(w: V3):
    return w.x / torch.sqrt(torch.clamp(sin2_theta(w), min=1e-20))


def roughness_to_alpha(roughness, anisotropy):
    """Imageworks remap (bxdf.cu:96-104); returns (ax, ay)."""
    r2 = roughness * roughness
    return r2 * (1.0 + anisotropy), r2 * (1.0 - anisotropy)


# ---------------------------------------------------------------------------
# fresnel


def fresnel_dielectric(cos, ior):
    """Exact unpolarized dielectric fresnel (bxdf.cu:274-283)."""
    temp = ior * ior + cos * cos - 1.0
    g = torch.sqrt(torch.clamp(temp, min=0.0))
    t0 = (g - cos) / (g + cos)
    t1 = ((g + cos) * cos - 1.0) / ((g - cos) * cos + 1.0)
    fr = 0.5 * t0 * t0 * (1.0 + t1 * t1)
    return torch.where(temp < 0.0, 1.0, fr)


def _fresnel_conductor_1(cos, ior, k):
    c2 = cos * cos
    two_eta_cos = 2.0 * ior * cos
    t0 = ior * ior + k * k
    t1 = t0 * c2
    rs = (t0 - two_eta_cos + c2) / (t0 + two_eta_cos + c2)
    rp = (t1 - two_eta_cos + 1.0) / (t1 + two_eta_cos + 1.0)
    return 0.5 * (rp + rs)


def fresnel_conductor(cos, ior: V3, k: V3) -> V3:
    """Unpolarized conductor fresnel (bxdf.cu:286-299), per channel."""
    return V3(
        _fresnel_conductor_1(cos, ior.x, k.x),
        _fresnel_conductor_1(cos, ior.y, k.y),
        _fresnel_conductor_1(cos, ior.z, k.z),
    )


def _artist_fresnel_1(r, g):
    r = torch.clamp(r, 0.0, 0.99)
    r_sqrt = torch.sqrt(r)
    n = g * (1.0 - r) / (1.0 + r) + (1.0 - g) * (1.0 + r_sqrt) / (1.0 - r_sqrt)
    t1 = n + 1.0
    t2 = n - 1.0
    k = torch.sqrt(torch.clamp((r * (t1 * t1) - t2 * t2) / (1.0 - r), min=0.0))
    return n, k


def artist_friendly_metallic_fresnel(reflectivity: V3, edge_tint: V3):
    """Gulbrandsen 2014 (bxdf.cu:107-116)."""
    nx, kx = _artist_fresnel_1(reflectivity.x, edge_tint.x)
    ny, ky = _artist_fresnel_1(reflectivity.y, edge_tint.y)
    nz, kz = _artist_fresnel_1(reflectivity.z, edge_tint.z)
    return V3(nx, ny, nz), V3(kx, ky, kz)


# ---------------------------------------------------------------------------
# gather-free LUT fetches (lut.cu:965-1081 semantics)


def _bilinear_weights_16(u):
    """Truncated-bilinear hat weights over 16 bins (list of 16 tensors)."""
    xi = u * 16.0
    i = torch.clamp(torch.floor(xi), 0.0, 15.0)
    i1 = torch.clamp(i + 1.0, max=15.0)
    hx = xi - i
    return [
        torch.where(i == float(k), 1.0 - hx, 0.0) + torch.where(i1 == float(k), hx, 0.0)
        for k in range(16)
    ]


def _lut_fetch_16x16(table_np: np.ndarray, u, v):
    """Bilinear fetch from a host-constant [16,16] table as a weighted sum."""
    wu = _bilinear_weights_16(u)
    wv = _bilinear_weights_16(v)
    out = torch.zeros_like(u)
    t = np.asarray(table_np, np.float64)
    for j in range(16):
        row = None
        for i in range(16):
            c = float(t[i, j])
            if c == 0.0:
                continue
            term = wu[i] * c
            row = term if row is None else row + term
        if row is not None:
            out = out + wv[j] * row
    return out


def compute_directional_albedo_reflection(wo: V3, roughness, f0):
    """lut.cu:985-994: F0*R + (1-F0)*G at (|wo.y|, roughness)."""
    table = lut_mod.reflection_lut_np()
    u = torch.abs(wo.y)
    v = torch.clamp(roughness, 0.0, 1.0)
    r = _lut_fetch_16x16(table[..., 0], u, v)
    g = _lut_fetch_16x16(table[..., 1], u, v)
    return f0 * r + (1.0 - f0) * g


def compute_directional_albedo_sheen(wo: V3, roughness):
    """lut.cu:1075-1081."""
    table = lut_mod.sheen_lut_np()
    u = torch.abs(wo.y)
    v = torch.clamp(roughness, 0.0, 1.0)
    return _lut_fetch_16x16(table, u, v)


# ---------------------------------------------------------------------------
# GGX common (bxdf.cu:484-512)


def ggx_d(wh: V3, ax, ay):
    t = (
        wh.x * wh.x / torch.clamp(ax * ax, min=1e-12)
        + wh.z * wh.z / torch.clamp(ay * ay, min=1e-12)
        + wh.y * wh.y
    )
    return 1.0 / (math.pi * ax * ay * t * t)


def ggx_lambda(w: V3, ax, ay):
    t = (ax * ax * w.x * w.x + ay * ay * w.z * w.z) / torch.clamp(w.y * w.y, min=1e-12)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + t))


def ggx_g1(w: V3, ax, ay):
    return 1.0 / (1.0 + ggx_lambda(w, ax, ay))


def ggx_g2(wo: V3, wi: V3, ax, ay):
    return 1.0 / (1.0 + ggx_lambda(wo, ax, ay) + ggx_lambda(wi, ax, ay))


def ggx_d_visible(w: V3, wh: V3, ax, ay):
    return (
        ggx_g1(w, ax, ay)
        * torch.abs(dot(w, wh))
        * ggx_d(wh, ax, ay)
        / torch.clamp(abs_cos_theta(w), min=1e-8)
    )


# ---------------------------------------------------------------------------
# diffuse lobes (bxdf.cu:119-264)


def _oren_nayar_scalar(roughness, wo: V3, wi: V3):
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
    return (a + b * c_max * s_alpha * t_beta) * INV_PI


def oren_nayar_eval(albedo: V3, roughness, wo: V3, wi: V3) -> V3:
    s = _oren_nayar_scalar(roughness, wo, wi)
    return V3(albedo.x * s, albedo.y * s, albedo.z * s)


def oren_nayar_pdf(wo: V3, wi: V3):
    return abs_cos_theta(wi) * INV_PI


def oren_nayar_sample(albedo: V3, roughness, wo: V3, u0, u1):
    wi = sample_cosine_weighted_hemisphere(u0, u1)
    return wi, oren_nayar_eval(albedo, roughness, wo, wi), oren_nayar_pdf(wo, wi)


def diffuse_transmission_sample(albedo: V3, roughness, wo: V3, u0, u1):
    """Flipped Oren-Nayar BTDF (bxdf.cu:209-264)."""
    wi = -sample_cosine_weighted_hemisphere(u0, u1)
    return (
        wi,
        oren_nayar_eval(albedo, roughness, wo, wi),
        oren_nayar_pdf(wo, wi),
    )


# ---------------------------------------------------------------------------
# microfacet lobes (bxdf.cu:428-740)


def microfacet_reflection_dielectric_eval(ior, ax, ay, wo: V3, wi: V3) -> V3:
    wh = normalize(wo + wi, eps=1e-20)
    f = fresnel_dielectric(torch.abs(dot(wo, wh)), ior)
    d = ggx_d(wh, ax, ay)
    g = ggx_g2(wo, wi, ax, ay)
    denom = torch.clamp(abs_cos_theta(wo) * abs_cos_theta(wi), min=1e-8)
    return vsplat(0.25 * f * d * g / denom)


def microfacet_reflection_dielectric_pdf(ax, ay, wo: V3, wi: V3):
    wh = normalize(wo + wi, eps=1e-20)
    return 0.25 * ggx_d_visible(wo, wh, ax, ay) / torch.clamp(
        torch.abs(dot(wo, wh)), min=1e-8)


def microfacet_reflection_dielectric_sample(ior, ax, ay, wo: V3, u0, u1):
    wh = sample_vndf(wo, ax, ay, u0, u1)
    wi = reflect(wo, wh)
    f = microfacet_reflection_dielectric_eval(ior, ax, ay, wo, wi)
    pdf = microfacet_reflection_dielectric_pdf(ax, ay, wo, wi)
    return wi, f, pdf


def microfacet_reflection_conductor_eval(
    ior3: V3, k3: V3, ax, ay, wo: V3, wi: V3
) -> V3:
    wh = normalize(wo + wi, eps=1e-20)
    f = fresnel_conductor(torch.abs(dot(wo, wh)), ior3, k3)
    d = ggx_d(wh, ax, ay)
    g = ggx_g2(wo, wi, ax, ay)
    s = d * g / torch.clamp(abs_cos_theta(wo) * abs_cos_theta(wi), min=1e-8)
    return V3(0.25 * f.x * s, 0.25 * f.y * s, 0.25 * f.z * s)


def microfacet_reflection_conductor_sample(ior3, k3, ax, ay, wo, u0, u1):
    wh = sample_vndf(wo, ax, ay, u0, u1)
    wi = reflect(wo, wh)
    f = microfacet_reflection_conductor_eval(ior3, k3, ax, ay, wo, wi)
    pdf = microfacet_reflection_dielectric_pdf(ax, ay, wo, wi)
    return wi, f, pdf


def _transmission_half_vector(ior_i, ior_t, wo: V3, wi: V3) -> V3:
    wh = normalize(
        V3(
            -(ior_i * wo.x + ior_t * wi.x),
            -(ior_i * wo.y + ior_t * wi.y),
            -(ior_i * wo.z + ior_t * wi.z),
        ),
        eps=1e-20,
    )
    return where3(wh.y < 0.0, -wh, wh)


def microfacet_transmission_eval(ior_i, ior_t, ax, ay, wo: V3, wi: V3) -> V3:
    wh = _transmission_half_vector(ior_i, ior_t, wo, wi)
    f = fresnel_dielectric(torch.abs(dot(wo, wh)), ior_t / ior_i)
    d = ggx_d(wh, ax, ay)
    g = ggx_g2(wo, wi, ax, ay)
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
    return vsplat(val)


def microfacet_transmission_pdf(ior_i, ior_t, ax, ay, wo: V3, wi: V3):
    wh = _transmission_half_vector(ior_i, ior_t, wo, wi)
    wi_dot_wh = dot(wi, wh)
    t = ior_i * dot(wo, wh) + ior_t * wi_dot_wh
    return (
        ggx_d_visible(wo, wh, ax, ay)
        * ior_t
        * ior_t
        * torch.abs(wi_dot_wh)
        / torch.clamp(t * t, min=1e-10)
    )


def microfacet_transmission_sample(ior_i, ior_t, ax, ay, wo: V3, u0, u1):
    wh = sample_vndf(wo, ax, ay, u0, u1)
    wt, ok = refract(wo, wh, ior_i, ior_t)

    # total internal reflection fallback (bxdf.cu:659-679)
    wr = reflect(wo, wh)
    fr = fresnel_dielectric(torch.abs(dot(wo, wh)), ior_t / ior_i)
    d = ggx_d(wh, ax, ay)
    g_r = ggx_g2(wo, wr, ax, ay)
    denom_r = torch.clamp(abs_cos_theta(wo) * abs_cos_theta(wr), min=1e-8)
    f_tir = vsplat(0.25 * fr * d * g_r / denom_r)
    pdf_tir = 0.25 * ggx_d_visible(wo, wh, ax, ay) / torch.clamp(
        torch.abs(dot(wr, wh)), min=1e-8)

    f_t = microfacet_transmission_eval(ior_i, ior_t, ax, ay, wo, wt)
    pdf_t = microfacet_transmission_pdf(ior_i, ior_t, ax, ay, wo, wt)

    wi = where3(ok, wt, wr)
    f = where3(ok, f_t, f_tir)
    pdf = torch.where(ok, pdf_t, pdf_tir)
    return wi, f, pdf


# ---------------------------------------------------------------------------
# production sheen (Estevez & Kulla 2017; bxdf.cu:743-822)


def _sheen_l(x, roughness):
    def interp(p0, p1):
        t = 1.0 - roughness
        t2 = t * t
        return t2 * p0 + (1.0 - t2) * p1

    a = interp(25.3245, 21.5473)
    b = interp(3.32435, 3.82987)
    c = interp(0.16801, 0.19823)
    d = interp(-1.27393, -1.97760)
    e = interp(-4.85967, -4.32054)
    if not isinstance(x, torch.Tensor):
        x = torch.full_like(roughness, x)
    return a / (1.0 + b * torch.exp(c * torch.log(torch.clamp(x, min=1e-8)))) + d * x + e


def _sheen_lambda(w: V3, roughness):
    cos = abs_cos_theta(w)
    return torch.where(
        cos < 0.5,
        torch.exp(_sheen_l(cos, roughness)),
        torch.exp(2.0 * _sheen_l(0.5, roughness) - _sheen_l(1.0 - cos, roughness)),
    )


def sheen_d(wh: V3, roughness):
    s = sin_theta(wh)
    inv_r = 1.0 / torch.clamp(roughness, min=1e-4)
    return (2.0 + inv_r) * torch.exp(
        inv_r * torch.log(torch.clamp(s, min=1e-8))
    ) / (2.0 * math.pi)


def sheen_eval(roughness, wo: V3, wi: V3) -> V3:
    wh = normalize(wo + wi, eps=1e-20)
    d = sheen_d(wh, roughness)
    g = 1.0 / (1.0 + _sheen_lambda(wo, roughness) + _sheen_lambda(wi, roughness))
    denom = torch.clamp(abs_cos_theta(wo) * abs_cos_theta(wi), min=1e-8)
    return vsplat(0.25 * d * g / denom)


def sheen_pdf(wo: V3, wi: V3):
    return abs_cos_theta(wi) * INV_PI


def sheen_sample(roughness, wo: V3, u0, u1):
    wh = sample_cosine_weighted_hemisphere(u0, u1)
    wi = reflect(wo, wh)
    return wi, sheen_eval(roughness, wo, wi), sheen_pdf(wo, wi)


# ---------------------------------------------------------------------------
# layered BSDF (bsdf.cu:11-378)


def setup(wo: V3, sp: Dict, is_entering, lobes_on=ALL_LOBES) -> Dict:
    """BSDF 'constructor' (bsdf.cu:11-127); sp values are tensors/V3s.

    Reproduces the reference's coat-absorption ctor-order quirk (coat
    absorption uses the PRE-albedo coat color, bsdf.cu:27-30)."""
    ni = torch.where(is_entering, 1.0, 1.5)
    nt = torch.where(is_entering, 1.5, 1.0)
    eta = nt / ni

    on = frozenset(lobes_on)
    coat_lum = rgb_to_luminance(sp["coat_color"])
    spec_lum = rgb_to_luminance(sp["specular_color"])
    sheen_lum = rgb_to_luminance(sp["sheen_color"])

    f0 = ((nt - ni) / (nt + ni)) ** 2
    zero = torch.zeros_like(sp["coat"])
    coat_albedo = (
        torch.where(
            (sp["coat"] * coat_lum > 0.0) & is_entering,
            compute_directional_albedo_reflection(wo, sp["coat_roughness"], f0),
            0.0,
        )
        if "coat" in on
        else zero
    )
    spec_albedo = (
        torch.where(
            (sp["specular"] * spec_lum > 0.0) & (eta >= 1.0),
            compute_directional_albedo_reflection(
                wo, sp["specular_roughness"], f0
            ),
            0.0,
        )
        if "specular" in on
        else zero
    )
    sheen_albedo = (
        torch.where(
            (sp["sheen"] * sheen_lum > 0.0) & is_entering,
            compute_directional_albedo_sheen(wo, sp["sheen_roughness"]),
            0.0,
        )
        if "sheen" in on
        else zero
    )

    cc = sp["coat_color"]
    cw = sp["coat"]
    one = torch.ones_like(cw)
    coat_absorption = V3(
        one + (cc.x - 1.0) * cw,
        one + (cc.y - 1.0) * cw,
        one + (cc.z - 1.0) * cw,
    )

    # disable reflective lobes when evaluating from inside (bsdf.cu:56-62)
    coat = torch.where(is_entering, sp["coat"], 0.0)
    metalness = torch.where(is_entering, sp["metalness"], 0.0)
    specular = torch.where(is_entering, sp["specular"], 0.0)
    sheen = torch.where(is_entering, sp["sheen"], 0.0)
    diffuse = torch.where(is_entering, sp["diffuse"], 0.0)

    # lobe weights (bsdf.cu:67-93)
    c = coat * coat_albedo
    s = specular * spec_albedo
    sh = sheen * sheen_albedo
    w0 = c
    w1 = (1.0 - c) * metalness
    w2 = (1.0 - c) * (1.0 - metalness) * s
    w3 = (1.0 - c) * (1.0 - metalness) * (1.0 - s) * sp["transmission"]
    w4 = (1.0 - c) * (1.0 - metalness) * (1.0 - s) * sh
    w5 = (
        (1.0 - c)
        * (1.0 - metalness)
        * (1.0 - s)
        * (1.0 - sp["transmission"])
        * (1.0 - sh)
        * sp["subsurface"]
        * sp["thin_walled"]
    )
    w6 = (
        (1.0 - c)
        * (1.0 - metalness)
        * (1.0 - s)
        * (1.0 - sp["transmission"])
        * (1.0 - sh)
        * (1.0 - sp["subsurface"])
        * diffuse
    )
    weights = (w0, w1, w2, w3, w4, w5, w6)
    total = w0 + w1 + w2 + w3 + w4 + w5 + w6
    inv_total = 1.0 / torch.where(total > 0.0, total, 1.0)
    pmf = tuple(w * inv_total for w in weights)

    if "metal" in on:
        metal_n, metal_k = artist_friendly_metallic_fresnel(
            V3(
                torch.clamp(sp["base_color"].x, 0.0, 0.99),
                torch.clamp(sp["base_color"].y, 0.0, 0.99),
                torch.clamp(sp["base_color"].z, 0.0, 0.99),
            ),
            V3(
                torch.clamp(sp["specular_color"].x, 0.0, 0.99),
                torch.clamp(sp["specular_color"].y, 0.0, 0.99),
                torch.clamp(sp["specular_color"].z, 0.0, 0.99),
            ),
        )
    else:
        metal_n = metal_k = V3(one, one, one)

    coat_ax, coat_ay = roughness_to_alpha(sp["coat_roughness"], zero)
    spec_ax, spec_ay = roughness_to_alpha(sp["specular_roughness"], zero)

    return {
        "lobes_on": on,
        "sp": {
            **sp,
            "coat": coat,
            "metalness": metalness,
            "specular": specular,
            "sheen": sheen,
            "diffuse": diffuse,
        },
        "ni": ni,
        "nt": nt,
        "eta": eta,
        "coat_lum": coat_lum,
        "spec_lum": spec_lum,
        "sheen_lum": sheen_lum,
        "coat_absorption": coat_absorption,
        "coat_albedo": coat_albedo,
        "spec_albedo": spec_albedo,
        "sheen_albedo": sheen_albedo,
        "pmf": pmf,
        "metal_n": metal_n,
        "metal_k": metal_k,
        "coat_ax": coat_ax,
        "coat_ay": coat_ay,
        "spec_ax": spec_ax,
        "spec_ay": spec_ay,
    }


def _lobe_evals(ctx, wo: V3, wi: V3):
    """All 7 lobe values + pdfs, guard-masked (bsdf.cu:129-176, :295-339).
    Returns (f: 7-tuple of V3, pdf: 7-tuple of tensors)."""
    sp = ctx["sp"]
    on = ctx["lobes_on"]

    z1 = torch.zeros_like(wo.y)
    z3 = V3(z1, z1, z1)

    def gate3(mask, v: V3) -> V3:
        v = _san3(v)
        return V3(torch.where(mask, v.x, 0.0), torch.where(mask, v.y, 0.0),
                  torch.where(mask, v.z, 0.0))

    def gate1(mask, v):
        return torch.where(mask, _san(v), 0.0)

    fs, ps = [], []

    if "coat" in on:
        m = sp["coat"] * ctx["coat_lum"] > 0.0
        fs.append(gate3(m, microfacet_reflection_dielectric_eval(
            ctx["eta"], ctx["coat_ax"], ctx["coat_ay"], wo, wi)))
        ps.append(gate1(m, microfacet_reflection_dielectric_pdf(
            ctx["coat_ax"], ctx["coat_ay"], wo, wi)))
    else:
        fs.append(z3)
        ps.append(z1)

    if "metal" in on:
        m = sp["metalness"] > 0.0
        fs.append(gate3(m, microfacet_reflection_conductor_eval(
            ctx["metal_n"], ctx["metal_k"], ctx["spec_ax"], ctx["spec_ay"],
            wo, wi)))
        ps.append(gate1(m, microfacet_reflection_dielectric_pdf(
            ctx["spec_ax"], ctx["spec_ay"], wo, wi)))
    else:
        fs.append(z3)
        ps.append(z1)

    if "specular" in on:
        m = sp["specular"] * ctx["spec_lum"] > 0.0
        fs.append(gate3(m, microfacet_reflection_dielectric_eval(
            ctx["eta"], ctx["spec_ax"], ctx["spec_ay"], wo, wi)))
        ps.append(gate1(m, microfacet_reflection_dielectric_pdf(
            ctx["spec_ax"], ctx["spec_ay"], wo, wi)))
    else:
        fs.append(z3)
        ps.append(z1)

    if "transmission" in on:
        m = sp["transmission"] > 0.0
        fs.append(gate3(m, microfacet_transmission_eval(
            ctx["ni"], ctx["nt"], ctx["spec_ax"], ctx["spec_ay"], wo, wi)))
        ps.append(gate1(m, microfacet_transmission_pdf(
            ctx["ni"], ctx["nt"], ctx["spec_ax"], ctx["spec_ay"], wo, wi)))
    else:
        fs.append(z3)
        ps.append(z1)

    if "sheen" in on:
        m = sp["sheen"] * ctx["sheen_lum"] > 0.0
        fs.append(gate3(m, sheen_eval(sp["sheen_roughness"], wo, wi)))
        ps.append(gate1(m, sheen_pdf(wo, wi)))
    else:
        fs.append(z3)
        ps.append(z1)

    if "diffuse_t" in on:
        m = sp["subsurface"] * sp["thin_walled"] > 0.0
        fs.append(gate3(m, oren_nayar_eval(
            sp["base_color"], sp["diffuse_roughness"], wo, wi)))
        ps.append(gate1(m, oren_nayar_pdf(wo, wi)))
    else:
        fs.append(z3)
        ps.append(z1)

    if "diffuse_r" in on:
        m = sp["diffuse"] > 0.0
        fs.append(gate3(m, oren_nayar_eval(
            sp["base_color"], sp["diffuse_roughness"], wo, wi)))
        ps.append(gate1(m, oren_nayar_pdf(wo, wi)))
    else:
        fs.append(z3)
        ps.append(z1)

    return tuple(fs), tuple(ps)


def eval(ctx, wo: V3, wi: V3) -> V3:
    """Layered mixture evaluation (bsdf.cu:129-212)."""
    sp = ctx["sp"]
    f, _ = _lobe_evals(ctx, wo, wi)
    coat, metal, spec, trans, sheen, dt, dr = f

    ret = vsplat(sp["coat"]) * coat
    f_mult = ctx["coat_absorption"]

    ret = ret + f_mult * vsplat(sp["metalness"]) * metal
    f_mult = f_mult * vsplat(1.0 - sp["metalness"])

    ret = ret + f_mult * vsplat(sp["specular"]) * sp["specular_color"] * spec
    f_mult = f_mult * (
        1.0 - vsplat(sp["specular"]) * sp["specular_color"]
        * vsplat(ctx["spec_albedo"])
    )

    ret = ret + f_mult * vsplat(sp["transmission"]) * sp[
        "transmission_color"
    ] * trans
    f_mult = f_mult * vsplat(1.0 - sp["transmission"])

    ret = ret + f_mult * vsplat(sp["sheen"]) * sp["sheen_color"] * sheen
    f_mult = f_mult * vsplat(1.0 - sp["sheen"] * ctx["sheen_albedo"])

    ret = ret + f_mult * vsplat(sp["subsurface"]) * sp[
        "subsurface_color"
    ] * vsplat(sp["thin_walled"]) * dt
    f_mult = f_mult * vsplat(1.0 - sp["subsurface"])

    ret = ret + f_mult * vsplat(sp["diffuse"]) * dr
    return ret


def eval_pdf(ctx, wo: V3, wi: V3):
    """Mixture pdf (bsdf.cu:295-345)."""
    _, pdf = _lobe_evals(ctx, wo, wi)
    out = torch.zeros_like(wo.y)
    for pm, p in zip(ctx["pmf"], pdf):
        out = out + pm * p
    return out


def _layer_multipliers(ctx):
    """Per-lobe throughput multipliers for sample() (bsdf.cu:221-290)."""
    sp = ctx["sp"]
    ca = ctx["coat_absorption"]
    spec_att = 1.0 - vsplat(sp["specular"]) * sp["specular_color"] * vsplat(
        ctx["spec_albedo"]
    )
    sheen_att_s = 1.0 - sp["sheen"] * ctx["sheen_albedo"]

    m0 = vsplat(sp["coat"])
    m1 = ca * vsplat(sp["metalness"])
    base2 = ca * vsplat(1.0 - sp["metalness"])
    m2 = base2 * vsplat(sp["specular"]) * sp["specular_color"]
    base3 = base2 * spec_att
    m3 = base3 * vsplat(sp["transmission"]) * sp["transmission_color"]
    base4 = base3 * vsplat(1.0 - sp["transmission"])
    m4 = base4 * vsplat(sp["sheen"]) * sp["sheen_color"]
    base5 = base4 * vsplat(sheen_att_s)
    m5 = (
        base5
        * vsplat(sp["subsurface"])
        * sp["subsurface_color"]
        * vsplat(sp["thin_walled"])
    )
    m6 = base5 * vsplat(1.0 - sp["subsurface"]) * vsplat(sp["diffuse"])
    return (m0, m1, m2, m3, m4, m5, m6)


def sample(ctx, wo: V3, u, v0, v1):
    """Sample one lobe then its direction (bsdf.cu:214-293).

    u: lobe-select uniform; (v0, v1): direction uniforms.
    Returns (wi V3, f V3, pdf)."""
    sp = ctx["sp"]
    on = ctx["lobes_on"]
    pmf = ctx["pmf"]

    # discrete CDF select over 7 bins, unrolled (sampling.cu:112-150)
    cdf = []
    acc = torch.zeros_like(u)
    for k in range(7):
        acc = acc + pmf[k]
        cdf.append(acc)
    idx = torch.zeros_like(u, dtype=torch.int32)
    for k in range(7):
        idx = idx + (u >= cdf[k]).to(torch.int32)
    idx = torch.clamp(idx, max=6)
    pmf_sel = torch.zeros_like(u)
    for k in range(7):
        pmf_sel = torch.where(idx == k, pmf[k], pmf_sel)

    z1 = torch.zeros_like(u)
    z3 = V3(z1, z1, z1)

    cands = []
    if "coat" in on:
        cands.append(microfacet_reflection_dielectric_sample(
            ctx["eta"], ctx["coat_ax"], ctx["coat_ay"], wo, v0, v1))
    else:
        cands.append((z3, z3, z1))
    if "metal" in on:
        cands.append(microfacet_reflection_conductor_sample(
            ctx["metal_n"], ctx["metal_k"], ctx["spec_ax"], ctx["spec_ay"],
            wo, v0, v1))
    else:
        cands.append((z3, z3, z1))
    if "specular" in on:
        cands.append(microfacet_reflection_dielectric_sample(
            ctx["eta"], ctx["spec_ax"], ctx["spec_ay"], wo, v0, v1))
    else:
        cands.append((z3, z3, z1))
    if "transmission" in on:
        cands.append(microfacet_transmission_sample(
            ctx["ni"], ctx["nt"], ctx["spec_ax"], ctx["spec_ay"], wo, v0, v1))
    else:
        cands.append((z3, z3, z1))
    if "sheen" in on:
        cands.append(sheen_sample(sp["sheen_roughness"], wo, v0, v1))
    else:
        cands.append((z3, z3, z1))
    if "diffuse_t" in on:
        cands.append(diffuse_transmission_sample(
            sp["base_color"], sp["diffuse_roughness"], wo, v0, v1))
    else:
        cands.append((z3, z3, z1))
    if "diffuse_r" in on:
        cands.append(oren_nayar_sample(
            sp["base_color"], sp["diffuse_roughness"], wo, v0, v1))
    else:
        cands.append((z3, z3, z1))

    mult = _layer_multipliers(ctx)

    wi, f, pdf = z3, z3, z1
    for k in range(7):
        if ALL_LOBES[k] not in on:
            continue
        sel = idx == k
        wi_k, f_k, p_k = cands[k]
        f_k = f_k * mult[k]
        wi = where3(sel, wi_k, wi)
        f = where3(sel, f_k, f)
        pdf = torch.where(sel, p_k, pdf)

    return wi, _san3(f), _san(pdf * pmf_sel)
