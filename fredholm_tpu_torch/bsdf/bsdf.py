"""Arnold-Standard-Surface-style layered BSDF over a stacked wavefront.

Port of fredholm_tpu/bsdf/bsdf.py (bsdf.cu): seven lobes (coat, metal,
specular, transmission, sheen, diffuse transmission, diffuse reflection)
with directional-albedo energy weights, layer attenuation and discrete
lobe selection; every active lobe is evaluated masked. `lobes_on` names
the lobes any material of the scene can activate, so the others are not
computed; "thin_film" in it switches the specular lobe's fresnel to the
Airy term. The fused pipeline's column-form twin is fused/cbsdf.py.

  ctx = setup(wo, sp, is_entering, lobes_on)
  f = eval(ctx, wo, wi)                # [N, 3]
  pdf = eval_pdf(ctx, wo, wi)          # [N]
  wi, f, pdf = sample(ctx, wo, u, v)   # lobe select + that lobe's sample
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.vecmath import lerp, rgb_to_luminance
from ..sampling.mappings import discrete_sample_cdf
from . import lobes
from .fresnel import artist_friendly_metallic_fresnel
from .lut import compute_directional_albedo_reflection, compute_directional_albedo_sheen

ALL_LOBES = ("coat", "metal", "specular", "transmission", "sheen",
             "diffuse_t", "diffuse_r")


def _sanitize(v):
    return torch.where(torch.isfinite(v), v, 0.0)


def _sum(terms):
    """Left-to-right sum (the order XLA:CPU reduces a short row in)."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def setup(wo, sp: Dict, is_entering, lobes_on=ALL_LOBES) -> Dict:
    """BSDF constructor (bsdf.cu:11-127); sp holds [N] / [N, 3] tensors.

    Keeps the reference's coat-absorption quirk: absorption is
    lerp(1, coat_color, coat), read before the coat albedo is known
    (bsdf.cu:27-30)."""
    ni = torch.where(is_entering, 1.0, 1.5)
    nt = torch.where(is_entering, 1.5, 1.0)
    eta = nt / ni

    on = frozenset(lobes_on)
    coat_lum = rgb_to_luminance(sp["coat_color"])
    spec_lum = rgb_to_luminance(sp["specular_color"])
    sheen_lum = rgb_to_luminance(sp["sheen_color"])

    r0 = (nt - ni) / (nt + ni)
    f0 = r0 * r0
    zero = torch.zeros_like(sp["coat"])
    coat_albedo = (
        torch.where(
            (sp["coat"] * coat_lum > 0.0) & is_entering,
            compute_directional_albedo_reflection(wo, sp["coat_roughness"], f0),
            0.0,
        )
        if "coat" in on else zero
    )
    spec_albedo = (
        torch.where(
            (sp["specular"] * spec_lum > 0.0) & (eta >= 1.0),
            compute_directional_albedo_reflection(wo, sp["specular_roughness"], f0),
            0.0,
        )
        if "specular" in on else zero
    )
    sheen_albedo = (
        torch.where(
            (sp["sheen"] * sheen_lum > 0.0) & is_entering,
            compute_directional_albedo_sheen(wo, sp["sheen_roughness"]),
            0.0,
        )
        if "sheen" in on else zero
    )

    coat_absorption = lerp(torch.ones_like(sp["coat_color"]), sp["coat_color"],
                           sp["coat"][..., None])

    # reflective lobes are off when evaluating from inside (bsdf.cu:56-62)
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
    w5 = ((1.0 - c) * (1.0 - metalness) * (1.0 - s) * (1.0 - sp["transmission"])
          * (1.0 - sh) * sp["subsurface"] * sp["thin_walled"])
    w6 = ((1.0 - c) * (1.0 - metalness) * (1.0 - s) * (1.0 - sp["transmission"])
          * (1.0 - sh) * (1.0 - sp["subsurface"]) * diffuse)
    weights = [w0, w1, w2, w3, w4, w5, w6]
    total = _sum(weights)
    pmf = torch.stack(weights, dim=-1) / torch.where(total > 0.0, total, 1.0)[..., None]

    if "metal" in on:
        metal_n, metal_k = artist_friendly_metallic_fresnel(
            torch.clamp(sp["base_color"], 0.0, 0.99),
            torch.clamp(sp["specular_color"], 0.0, 0.99),
        )
    else:
        metal_n = metal_k = torch.ones_like(sp["base_color"])

    return {
        "lobes_on": on,
        "sp": {**sp, "coat": coat, "metalness": metalness, "specular": specular,
               "sheen": sheen, "diffuse": diffuse},
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
        "coat_alpha": lobes.roughness_to_alpha(sp["coat_roughness"], zero),
        "spec_alpha": lobes.roughness_to_alpha(sp["specular_roughness"], zero),
    }


def _lobe_evals(ctx, wo, wi):
    """The seven lobes' values [N, 3] and pdfs [N] at (wo, wi), masked by
    their guards (bsdf.cu:129-176, :295-339); None for an inactive lobe."""
    sp = ctx["sp"]
    on = ctx["lobes_on"]

    def gated(mask, f, p):
        return (torch.where(mask[..., None], _sanitize(f), 0.0),
                torch.where(mask, _sanitize(p), 0.0))

    out = [None] * 7
    if "coat" in on:
        out[0] = gated(
            sp["coat"] * ctx["coat_lum"] > 0.0,
            lobes.microfacet_reflection_dielectric_eval(ctx["eta"], ctx["coat_alpha"], wo, wi),
            lobes.microfacet_reflection_dielectric_pdf(ctx["coat_alpha"], wo, wi))
    if "metal" in on:
        out[1] = gated(
            sp["metalness"] > 0.0,
            lobes.microfacet_reflection_conductor_eval(
                ctx["metal_n"], ctx["metal_k"], ctx["spec_alpha"], wo, wi),
            lobes.microfacet_reflection_conductor_pdf(ctx["spec_alpha"], wo, wi))
    if "specular" in on:
        if "thin_film" in on:
            # the Airy interference fresnel on the specular lobe
            # (bxdf.cu:448-454)
            f_spec = lobes.microfacet_reflection_thinfilm_eval(
                ctx["eta"], sp["thin_film_ior"], sp["thin_film_thickness"],
                ctx["spec_alpha"], wo, wi)
        else:
            f_spec = lobes.microfacet_reflection_dielectric_eval(
                ctx["eta"], ctx["spec_alpha"], wo, wi)
        out[2] = gated(sp["specular"] * ctx["spec_lum"] > 0.0, f_spec,
                       lobes.microfacet_reflection_dielectric_pdf(ctx["spec_alpha"], wo, wi))
    if "transmission" in on:
        out[3] = gated(
            sp["transmission"] > 0.0,
            lobes.microfacet_transmission_eval(ctx["ni"], ctx["nt"], ctx["spec_alpha"], wo, wi),
            lobes.microfacet_transmission_pdf(ctx["ni"], ctx["nt"], ctx["spec_alpha"], wo, wi))
    if "sheen" in on:
        out[4] = gated(sp["sheen"] * ctx["sheen_lum"] > 0.0,
                       lobes.sheen_eval(sp["sheen_roughness"], wo, wi), lobes.sheen_pdf(wo, wi))
    if "diffuse_t" in on:
        out[5] = gated(
            sp["subsurface"] * sp["thin_walled"] > 0.0,
            lobes.diffuse_transmission_eval(sp["base_color"], sp["diffuse_roughness"], wo, wi),
            lobes.diffuse_transmission_pdf(wo, wi))
    if "diffuse_r" in on:
        out[6] = gated(sp["diffuse"] > 0.0,
                       lobes.oren_nayar_eval(sp["base_color"], sp["diffuse_roughness"], wo, wi),
                       lobes.oren_nayar_pdf(wo, wi))
    return out


def _zero_or(x, like):
    return torch.zeros_like(like) if x is None else x


def eval(ctx, wo, wi):
    """Layered mixture evaluation (bsdf.cu:129-212); returns [N, 3]."""
    sp = ctx["sp"]
    f = [_zero_or(e and e[0], wo) for e in _lobe_evals(ctx, wo, wi)]
    coat, metal, spec, trans, sheen, dt, dr = f

    ret = sp["coat"][..., None] * coat
    f_mult = ctx["coat_absorption"]

    ret = ret + f_mult * sp["metalness"][..., None] * metal
    f_mult = f_mult * (1.0 - sp["metalness"])[..., None]

    ret = ret + f_mult * sp["specular"][..., None] * sp["specular_color"] * spec
    f_mult = f_mult * (1.0 - sp["specular"][..., None] * sp["specular_color"]
                       * ctx["spec_albedo"][..., None])

    ret = ret + f_mult * sp["transmission"][..., None] * sp["transmission_color"] * trans
    f_mult = f_mult * (1.0 - sp["transmission"])[..., None]

    ret = ret + f_mult * sp["sheen"][..., None] * sp["sheen_color"] * sheen
    f_mult = f_mult * (1.0 - (sp["sheen"] * ctx["sheen_albedo"])[..., None])

    ret = ret + (f_mult * sp["subsurface"][..., None] * sp["subsurface_color"]
                 * sp["thin_walled"][..., None] * dt)
    f_mult = f_mult * (1.0 - sp["subsurface"])[..., None]

    return ret + f_mult * sp["diffuse"][..., None] * dr


def eval_pdf(ctx, wo, wi):
    """Mixture pdf (bsdf.cu:295-345); returns [N]."""
    pmf = ctx["pmf"]
    pdfs = [_zero_or(e and e[1], wo[..., 0]) for e in _lobe_evals(ctx, wo, wi)]
    return _sum([pmf[..., k] * pdfs[k] for k in range(7)])


def _layer_multipliers(ctx):
    """Per-lobe throughput multipliers of sample() (bsdf.cu:221-290), a
    list of seven [N, 3]."""
    sp = ctx["sp"]
    one = torch.ones_like(sp["base_color"])
    ca = ctx["coat_absorption"]
    spec_att = 1.0 - sp["specular"][..., None] * sp["specular_color"] \
        * ctx["spec_albedo"][..., None]
    sheen_att = 1.0 - (sp["sheen"] * ctx["sheen_albedo"])[..., None]

    m0 = sp["coat"][..., None] * one
    m1 = ca * sp["metalness"][..., None]
    base2 = ca * (1.0 - sp["metalness"])[..., None]
    m2 = base2 * sp["specular"][..., None] * sp["specular_color"]
    base3 = base2 * spec_att
    m3 = base3 * sp["transmission"][..., None] * sp["transmission_color"]
    base4 = base3 * (1.0 - sp["transmission"])[..., None]
    m4 = base4 * sp["sheen"][..., None] * sp["sheen_color"]
    base5 = base4 * sheen_att
    m5 = base5 * sp["subsurface"][..., None] * sp["subsurface_color"] * sp["thin_walled"][..., None]
    m6 = base5 * (1.0 - sp["subsurface"])[..., None] * sp["diffuse"][..., None]
    return [m0, m1, m2, m3, m4, m5, m6]


def sample(ctx, wo, u, v):
    """Sample one lobe, then its direction (bsdf.cu:214-293). u [N] the
    lobe-select uniform, v [N, 2] the direction uniforms. Returns (wi
    [N, 3], f [N, 3], pdf [N])."""
    sp = ctx["sp"]
    on = ctx["lobes_on"]
    idx, pmf_sel = discrete_sample_cdf(ctx["pmf"], u)

    cands = [None] * 7
    if "coat" in on:
        cands[0] = lobes.microfacet_reflection_dielectric_sample(
            ctx["eta"], ctx["coat_alpha"], wo, v)
    if "metal" in on:
        cands[1] = lobes.microfacet_reflection_conductor_sample(
            ctx["metal_n"], ctx["metal_k"], ctx["spec_alpha"], wo, v)
    if "specular" in on:
        if "thin_film" in on:
            cands[2] = lobes.microfacet_reflection_thinfilm_sample(
                ctx["eta"], sp["thin_film_ior"], sp["thin_film_thickness"],
                ctx["spec_alpha"], wo, v)
        else:
            cands[2] = lobes.microfacet_reflection_dielectric_sample(
                ctx["eta"], ctx["spec_alpha"], wo, v)
    if "transmission" in on:
        cands[3] = lobes.microfacet_transmission_sample(
            ctx["ni"], ctx["nt"], ctx["spec_alpha"], wo, v)
    if "sheen" in on:
        cands[4] = lobes.sheen_sample(sp["sheen_roughness"], wo, v)
    if "diffuse_t" in on:
        cands[5] = lobes.diffuse_transmission_sample(
            sp["base_color"], sp["diffuse_roughness"], wo, v)
    if "diffuse_r" in on:
        cands[6] = lobes.oren_nayar_sample(sp["base_color"], sp["diffuse_roughness"], wo, v)

    mult = _layer_multipliers(ctx)
    wi = torch.zeros_like(wo)
    f = torch.zeros_like(wo)
    pdf = torch.zeros_like(u)
    for k, cand in enumerate(cands):
        if cand is None:
            continue
        sel = idx == k
        wi = torch.where(sel[..., None], cand[0], wi)
        f = torch.where(sel[..., None], cand[1] * mult[k], f)
        pdf = torch.where(sel, cand[2], pdf)
    return wi, _sanitize(f), _sanitize(pdf * pmf_sel)
