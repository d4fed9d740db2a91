"""Wavefront path tracer with NEE + MIS, and the progressive accumulation
(port of fredholm_tpu/integrator/pt.py).

`render_sample` is the reference's wavefront integrator: all N = W*H pixel
lanes advance together, one bounce at a time, in its stacked [N, 3] layout
and the sampler draw order of pt.cu:418-944:

  RR -> trace radiance -> [miss: sky on first hit] ->
  NEE (sun?, sky, area?) -> BSDF light ray (MIS) -> next bounce.

The bounce loop ends when no lane is alive (one host read a bounce), as the
reference's while_loop does, so `n_lane_slots` counts executed bounces.
Traces go through the kernel wrappers: dense scenes B1 (closest hit,
accel/dense.py) and B3 (any hit), clustered scenes B4/B5
(accel/clustered.py), whose hit slots key the B6 attribute fetch
(fused/slot_fetch.py). The rest is plain PyTorch, as the reference
computes it in jnp. Untextured scenes only: `render_sample` raises on a
scene with texture kinds (they render through the fused pipeline) and
`Renderer.set_scene` refuses alpha cutout, so the shading frame is the
interpolated normal's.

The pixel swizzle of the reference only reorders lanes (every draw is
keyed by the pixel), so lane i is pixel i here.

`render_progressive` runs the fused pipeline (fused/pt_fused.py) or
`render_sample`, as params["use_fused"] says, and keeps the reference's
streaming average `coef * (nf * old + new)` keyed by the per-pixel sample
count (pt.cu:480-501), so `render(n); render(m)` equals `render(n + m)`.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..accel import clustered, dense
from ..bsdf import bsdf as bsdf_mod
from ..camera import pixel_uv, sample_ray_thinlens
from ..core.vecmath import (
    cartesian_to_spherical,
    cross,
    dot,
    is_finite3,
    length,
    local_to_world,
    normalize,
    orthonormal_basis,
    ray_origin_offset,
    rgb_to_luminance,
    world_to_local,
)
from ..experimental import resident
from ..fused.pt_fused import RAY_TMAX, SHADOW_RAY_EPS, SKY_CONSTANT, SKY_HOSEK
from ..fused.slot_fetch import fetch_geom_by_slot
from ..sampling.mappings import (
    sample_concentric_disk,
    sample_cosine_weighted_hemisphere,
    sample_triangle,
)
from ..sampling.sampler import init_sampler_state, sample_1d_n, sample_2d_n
from ..sky.hosek import sky_radiance

# ---------------------------------------------------------------------------
# traces


def _ray_buffer(o, d, t_max):
    """The wrappers' [7, N] ray buffer: rows o xyz, d xyz, tmax."""
    return torch.cat([o.T, d.T, t_max[None]]).contiguous()


def _use_resident(dev: Dict, coherent: bool) -> bool:
    """Whether a trace takes the ray-resident traversal (B7; pt.py:98-114):
    incoherent, an identity instance and the resident tables present
    (built at set_scene under FREDHOLM_TRAV_RESIDENT=1)."""
    return "clusters" in dev and resident.routes(dev["clusters"], coherent)


def trace_closest(dev: Dict, o, d, t_max, coherent: bool = True) -> Dict:
    """optixTrace RAY_TYPE_RADIANCE / LIGHT analog (pt.py:117-131): B7 for
    an incoherent trace where `_use_resident` says, else B4 on clustered
    scenes, else B1. Returns {t, prim, u, v, hit[, inst, slot]}. The
    wavefront's own traces keep coherent=True, as the reference's."""
    rays = _ray_buffer(o, d, t_max)
    if _use_resident(dev, coherent):
        return resident.intersect_closest_resident(dev["clusters"], rays)
    if "clusters" in dev:
        hit = clustered.intersect_closest_clustered(dev["clusters"], rays)
    else:
        hit = dense.intersect_closest(dev["tri_soa"], rays, rays.shape[1])
    return {**hit, "hit": hit["prim"] >= 0}


def trace_any(dev: Dict, o, d, t_max, coherent: bool = True):
    """optixTrace RAY_TYPE_SHADOW analog (pt.py:211-227): B7-any for an
    incoherent trace where `_use_resident` says, else B5 on clustered
    scenes, else B3. Returns occluded bool [N]."""
    rays = _ray_buffer(o, d, t_max)
    if _use_resident(dev, coherent):
        return resident.intersect_any_resident(dev["clusters"], rays)
    if "clusters" in dev:
        return clustered.intersect_any_clustered(dev["clusters"], rays)
    return dense.intersect_any(dev["tri_soa"], rays, rays.shape[1])


# ---------------------------------------------------------------------------
# sky


def _sky(params: Dict, device) -> Dict:
    """The sky and sun parameters as tensors on `device`, once a sample."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    mode = params.get("sky_mode", SKY_CONSTANT)
    if mode not in (SKY_CONSTANT, SKY_HOSEK):
        raise NotImplementedError("IBL is not ported yet: the wavefront integrator "
                                  "takes a constant or Hosek sky")
    sky = {"mode": mode, "bg": f32(params.get("bg_color", np.zeros(3))),
           "intensity": float(params.get("sky_intensity", 1.0)),
           "sun": f32(params.get("sun_direction", np.asarray([0.0, 1.0, 0.0])))}
    if mode == SKY_HOSEK:
        sky["hosek"] = {k: f32(v) for k, v in params["hosek"].items()}
    dl = params.get("directional_light")
    if dl is not None:
        sky["dl"] = {"le": f32(dl["le"]), "dir": f32(dl["dir"]), "angle": f32(dl["angle"])}
    return sky


def eval_sky(sky: Dict, v):
    """Environment radiance [N, 3] for directions v [N, 3] (pt.cu:504-523),
    constant or Hosek."""
    if sky["mode"] == SKY_HOSEK:
        theta, _ = cartesian_to_spherical(v)
        gamma = torch.acos(torch.clamp(dot(sky["sun"], v), -1.0, 1.0))
        return sky["intensity"] * sky_radiance(sky["hosek"], theta, gamma)
    return sky["bg"].expand(v.shape)


# ---------------------------------------------------------------------------
# surface and shading parameters


def _interp(w0, w1, w2, a):
    """Barycentric interpolation of per-vertex rows a [N, 3, C]."""
    return w0 * a[:, 0] + w1 * a[:, 1] + w2 * a[:, 2]


def _face_data(dev: Dict, hit: Dict):
    """(verts [N, 3, 3], normals [N, 3, 3], uvs [N, 3, 2], mat_id [N]) of
    the hit faces: by B6 slot fetch on clustered scenes (misses are zero;
    pt.py:299-311), else by gathering the clamped prim's rows."""
    if "slot" in hit and "slot_rows" in dev:
        a = fetch_geom_by_slot(dev["slot_rows"], hit["slot"]).T
        return (a[:, 0:9].reshape(-1, 3, 3), a[:, 9:18].reshape(-1, 3, 3),
                a[:, 18:24].reshape(-1, 3, 2), torch.round(a[:, 25]).to(torch.int64))
    p = torch.clamp(hit["prim"].to(torch.int64), 0, dev["n_faces"] - 1)
    return (dev["face_verts"][p], dev["face_normals"][p], dev["face_uvs"][p],
            dev["face_mat"][p].to(torch.int64))


def fill_surface_info(dev: Dict, hit: Dict, ray_d) -> Dict:
    """pt.cu:141-179 over a wavefront (pt.py:314-360)."""
    fv, fn, fuv, mat_id = _face_data(dev, hit)
    w0 = (1.0 - hit["u"] - hit["v"])[:, None]
    w1 = hit["u"][:, None]
    w2 = hit["v"][:, None]

    x = _interp(w0, w1, w2, fv)
    n_g = normalize(cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]), eps=1e-20)
    n_s = normalize(_interp(w0, w1, w2, fn), eps=1e-20)
    texcoord = _interp(w0, w1, w2, fuv)

    is_entering = dot(-ray_d, n_g) > 0.0
    flip = torch.where(is_entering, 1.0, -1.0)[:, None]
    n_s = n_s * flip
    n_g = n_g * flip
    tangent, bitangent = orthonormal_basis(n_s)
    return {"x": x, "n_g": n_g, "n_s": n_s, "texcoord": texcoord, "tangent": tangent,
            "bitangent": bitangent, "is_entering": is_entering, "mat_id": mat_id}


def fill_shading_params(dev: Dict, mat_id) -> Dict:
    """pt.cu:181-280, the untextured branch (pt.py:379-399)."""
    m = dev["materials"]

    def g(name):
        return m[name][mat_id]

    sp = {k: g(k) for k in (
        "diffuse", "diffuse_roughness", "base_color", "specular", "specular_color",
        "metalness", "coat_color", "transmission", "transmission_color", "sheen",
        "sheen_color", "sheen_roughness", "subsurface", "subsurface_color", "thin_walled",
        "thin_film_thickness", "thin_film_ior")}
    sp["specular_roughness"] = torch.clamp(g("specular_roughness"), 0.01, 1.0)
    sp["coat"] = torch.clamp(g("coat"), 0.0, 1.0)
    sp["coat_roughness"] = torch.clamp(g("coat_roughness"), 0.0, 1.0)
    return sp


def get_emission(dev: Dict, mat_id):
    """pt.cu:131-139, untextured."""
    return dev["materials"]["emission_color"][mat_id]


def has_emission(dev: Dict, mat_id):
    """pt.cu:125-129."""
    m = dev["materials"]
    ec = m["emission_color"][mat_id]
    return ((ec[:, 0] > 0.0) | (ec[:, 1] > 0.0) | (ec[:, 2] > 0.0)
            | (m["emission_texture_id"][mat_id] >= 0))


# ---------------------------------------------------------------------------
# lights


def sample_position_on_light(dev: Dict, u, v2):
    """Uniform area-light sampling (pt.cu:282-322). Returns (p, n, le,
    pdf_area)."""
    n_lights = dev["n_lights"]
    idx = torch.clamp((u * n_lights).to(torch.int32), 0, max(n_lights - 1, 0)).to(torch.int64)
    fv = dev["light_verts"][idx]
    fn = dev["light_normals"][idx]

    bary = sample_triangle(v2)
    w0 = (1.0 - bary[:, 0] - bary[:, 1])[:, None]
    w1 = bary[:, 0:1]
    w2 = bary[:, 1:2]
    p = _interp(w0, w1, w2, fv)
    n = _interp(w0, w1, w2, fn)
    area = 0.5 * length(cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]))
    le = get_emission(dev, dev["light_mat"][idx].to(torch.int64))
    pdf = 1.0 / (n_lights * torch.clamp(area, min=1e-12))
    return p, n, le, pdf


def sample_position_on_directional_light(dl: Dict, u2):
    """pt.cu:324-342: a point on the sun disk 1e9 away."""
    dist = 1e9
    p_disk = sample_concentric_disk(u2)
    disk_radius = dist * torch.tan(torch.deg2rad(0.5 * dl["angle"]))
    t, b = orthonormal_basis(dl["dir"].expand(p_disk.shape[:-1] + (3,)))
    return dist * dl["dir"] + disk_radius * (t * p_disk[:, 0:1] + b * p_disk[:, 1:2])


def compute_mis_weight(pdf0, pdf1):
    """Balance heuristic (pt.cu:365-370)."""
    return pdf0 / (pdf0 + pdf1)


def regularize_weight(w):
    """Firefly clamp (pt.cu:372-376)."""
    return torch.clamp(w, 0.0, 1.0)


# ---------------------------------------------------------------------------
# one progressive sample of every pixel


def _where3(mask, a, b):
    return torch.where(mask[:, None], a, b)


def render_sample(dev: Dict, params: Dict, n_spp) -> Dict:
    """Trace one path per pixel; n_spp [N] the per-pixel sample counts
    (uint32 values in int64). Returns the per-sample AOVs (radiance,
    position, normal, depth, texcoord, albedo), each [N, ...], NaN/Inf
    scrubbed like pt.cu:469-478, and the counters n_path_vertices and
    n_lane_slots (float32 scalars)."""
    if "inst_table" in dev:
        raise NotImplementedError(
            "the wavefront integrator has no instanced scenes yet (the reference's "
            "_apply_inst_points, _apply_inst_normals and _gather_inst_rows, pt.py, are not "
            "ported); instanced scenes render through the fused pipeline: keep use_fused, the "
            "sobol_cmj sampler, no thin film and <= 16 area lights")
    if dev.get("tex_kinds"):
        raise NotImplementedError(
            f"the wavefront integrator has no textures yet (the textured "
            f"fill_shading_params and apply_normal_mapping, pt.py:335-384, are not ported); "
            f"this scene's texture kinds {tuple(dev['tex_kinds'])} render through the fused "
            f"pipeline: keep use_fused, the sobol_cmj sampler, no thin film and <= 16 "
            f"area lights")
    width, height = params["width"], params["height"]
    n = width * height
    max_depth = params["max_depth"]
    lobes_on = tuple(params["lobes_on"])
    device = n_spp.device
    sky = _sky(params, device)

    lane = torch.arange(n, dtype=torch.int64, device=device)
    px, py = lane % width, lane // width
    smp = init_sampler_state(lane, n_spp, n, params["seed"],
                             mode=params.get("sampler_mode", "sobol_cmj"), width=width)

    # camera ray (pt.cu:437-446): pixel jitter, then the lens sample
    u_cam, smp = sample_2d_n(smp, 2)
    uv = pixel_uv(px, py, u_cam[:, 0], width, height)
    origin, direction, _ = sample_ray_thinlens(params["camera"], uv, u_cam[:, 1])

    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
    throughput = torch.ones_like(zeros3)
    radiance = zeros3
    alive = torch.ones(n, dtype=torch.bool, device=device)
    firsthit = torch.ones_like(alive)
    position, normal_aov, albedo = zeros3, zeros3, zeros3
    depth_aov = torch.zeros(n, dtype=torch.float32, device=device)
    texcoord_aov = torch.zeros((n, 2), dtype=torch.float32, device=device)
    n_path_vertices = torch.zeros((), dtype=torch.float32, device=device)

    # a bounce's draws, taken in one pass per kind and handed out in the
    # reference's order: 1D RR, [area], light, bounce; 2D [sun], sky,
    # [area], light, bounce (the two counters are independent)
    has_area = dev["n_lights"] > 0
    n_1d = 3 + has_area
    n_2d = 3 + has_area + ("dl" in sky)

    depth = 0
    while depth < max_depth and bool(alive.any()):
        keep = alive
        u1s, smp = sample_1d_n(smp, n_1d)
        u2s, smp = sample_2d_n(smp, n_2d)
        draw_1d, draw_2d = iter(u1s.unbind(-1)), iter(u2s.unbind(-2))

        # --- russian roulette (pt.cu:455-462)
        u_rr = next(draw_1d)
        if depth == 0:
            rr_prob = torch.ones_like(u_rr)
        else:
            rr_prob = torch.clamp(rgb_to_luminance(throughput), 0.0, 1.0)
        alive = alive & (u_rr < rr_prob)
        thr = throughput / torch.clamp(rr_prob, min=1e-12)[:, None]

        # --- trace radiance ray
        hit = trace_closest(dev, origin, direction, torch.where(alive, RAY_TMAX, -1.0))
        hit_mask = hit["hit"] & alive

        # --- miss: sky on first hit (pt.cu:504-523)
        miss_first = alive & ~hit["hit"] & firsthit
        rad = radiance + _where3(miss_first, thr * eval_sky(sky, direction), 0.0)
        alive = alive & hit["hit"]
        n_path_vertices = n_path_vertices + alive.to(torch.float32).sum()

        # --- surface + shading params
        surf = fill_surface_info(dev, hit, direction)
        sp = fill_shading_params(dev, surf["mat_id"])
        tangent, nrm, bitangent = surf["tangent"], surf["n_s"], surf["bitangent"]

        # --- first-hit AOVs + emissive hit (pt.cu:745-760)
        capture = firsthit & hit_mask
        position = _where3(capture, surf["x"], position)
        normal_aov = _where3(capture, nrm, normal_aov)
        depth_aov = torch.where(capture, hit["t"], depth_aov)
        texcoord_aov = _where3(capture, surf["texcoord"], texcoord_aov)
        albedo = _where3(capture, sp["base_color"], albedo)

        emit_now = capture & has_emission(dev, surf["mat_id"])
        rad = rad + _where3(emit_now, thr * get_emission(dev, surf["mat_id"]), 0.0)
        alive = alive & ~emit_now
        firsthit = firsthit & ~capture

        # --- BSDF context
        wo = world_to_local(-direction, tangent, nrm, bitangent)
        ctx = bsdf_mod.setup(wo, sp, surf["is_entering"], lobes_on)
        shadow_origin = ray_origin_offset(surf["x"], surf["n_g"])

        # --- NEE (pt.cu:767-890): sun (optional), sky, area; all shadow
        # rays share one any-hit trace, the draws keep the reference's order
        nee_dirs, nee_tmax = [], []
        live_tmax = torch.where(alive, RAY_TMAX, -1.0)
        if "dl" in sky:
            p_sun = sample_position_on_directional_light(sky["dl"], next(draw_2d))
            sdir_dl = normalize(p_sun - shadow_origin)
            nee_dirs.append(sdir_dl)
            nee_tmax.append(live_tmax)

        wi_sky = sample_cosine_weighted_hemisphere(next(draw_2d))
        sdir_sky = local_to_world(wi_sky, tangent, nrm, bitangent)
        cos_sky = torch.abs(wi_sky[:, 1])
        pdf_sky = cos_sky / math.pi
        nee_dirs.append(sdir_sky)
        nee_tmax.append(live_tmax)

        if has_area:
            p_l, n_l, le_l, pdf_area = sample_position_on_light(dev, next(draw_1d),
                                                                next(draw_2d))
            to_l = p_l - shadow_origin
            r = length(to_l)
            sdir_area = to_l / torch.clamp(r, min=1e-12)[:, None]
            nee_dirs.append(sdir_area)
            nee_tmax.append(torch.where(alive, r - SHADOW_RAY_EPS, -1.0))

        k = len(nee_dirs)
        occ = trace_any(dev, shadow_origin.repeat(k, 1), torch.cat(nee_dirs),
                        torch.cat(nee_tmax)).view(k, n)
        part = iter(occ)

        if "dl" in sky:
            visible = alive & ~next(part)
            wi = world_to_local(sdir_dl, tangent, nrm, bitangent)
            f = bsdf_mod.eval(ctx, wo, wi)
            # the sun's pdf is 1
            mis_w = compute_mis_weight(1.0, bsdf_mod.eval_pdf(ctx, wo, wi))
            w = regularize_weight(thr * (mis_w * torch.abs(wi[:, 1]))[:, None] * f)
            rad = rad + _where3(visible, w * sky["dl"]["le"], 0.0)

        visible = alive & ~next(part)
        f = bsdf_mod.eval(ctx, wo, wi_sky)
        mis_w = compute_mis_weight(pdf_sky, bsdf_mod.eval_pdf(ctx, wo, wi_sky))
        scale = torch.where(pdf_sky > 0.0, mis_w * cos_sky / torch.clamp(pdf_sky, min=1e-12), 0.0)
        w = regularize_weight(thr * scale[:, None] * f)
        rad = rad + _where3(visible, w * eval_sky(sky, sdir_sky), 0.0)

        if has_area:
            front = dot(-sdir_area, n_l) > 0.0
            visible = alive & ~next(part) & front
            wi = world_to_local(sdir_area, tangent, nrm, bitangent)
            f = bsdf_mod.eval(ctx, wo, wi)
            pdf = r * r / torch.clamp(torch.abs(dot(-sdir_area, n_l)), min=1e-12) * pdf_area
            mis_w = compute_mis_weight(pdf, bsdf_mod.eval_pdf(ctx, wo, wi))
            w = regularize_weight(
                thr * (mis_w * torch.abs(wi[:, 1]) / torch.clamp(pdf, min=1e-12))[:, None] * f)
            rad = rad + _where3(visible, w * le_l, 0.0)

        # --- BSDF-sampled light ray with MIS (pt.cu:892-925)
        wi_l, f_l, pdf_l = bsdf_mod.sample(ctx, wo, next(draw_1d), next(draw_2d))
        ldir = local_to_world(wi_l, tangent, nrm, bitangent)
        transmitted = dot(ldir, surf["n_g"]) < 0.0
        lorigin = ray_origin_offset(surf["x"], _where3(transmitted, -surf["n_g"], surf["n_g"]))
        lhit = trace_closest(dev, lorigin, ldir, live_tmax)
        # the light hit's face: by prim from the face tables on every scene
        # (pt.py:872-877)
        lp = torch.clamp(lhit["prim"].to(torch.int64), 0, dev["n_faces"] - 1)
        l_mat = dev["face_mat"][lp].to(torch.int64)
        fv = dev["face_verts"][lp]
        fn = dev["face_normals"][lp]
        lw0 = (1.0 - lhit["u"] - lhit["v"])[:, None]
        lw1 = lhit["u"][:, None]
        lw2 = lhit["v"][:, None]
        l_p = _interp(lw0, lw1, lw2, fv)
        l_n = _interp(lw0, lw1, lw2, fn)
        l_area = 0.5 * length(cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]))
        hit_light = lhit["hit"] & has_emission(dev, l_mat) & (dot(-ldir, l_n) > 0.0)

        le = _where3(lhit["hit"], _where3(hit_light, get_emission(dev, l_mat), 0.0),
                     eval_sky(sky, ldir))
        r2 = dot(l_p - lorigin, l_p - lorigin)
        pdf_area_hit = 1.0 / (max(dev["n_lights"], 1) * torch.clamp(l_area, min=1e-12))
        pdf_light_hit = r2 / torch.clamp(torch.abs(dot(-ldir, l_n)), min=1e-12) * pdf_area_hit
        pdf_light = torch.where(hit_light, pdf_light_hit, torch.abs(wi_l[:, 1]) / math.pi)
        mis_w = compute_mis_weight(pdf_l, pdf_light)
        w = regularize_weight(thr * torch.where(
            pdf_l > 0.0, mis_w * torch.abs(wi_l[:, 1]) / torch.clamp(pdf_l, min=1e-12),
            0.0)[:, None] * f_l)
        rad = rad + _where3(alive, w * le, 0.0)

        # --- next bounce (pt.cu:927-943)
        wi_n, f_n, pdf_n = bsdf_mod.sample(ctx, wo, next(draw_1d), next(draw_2d))
        wi_world = local_to_world(wi_n, tangent, nrm, bitangent)
        bounce_w = torch.where(
            pdf_n > 0.0, torch.abs(wi_n[:, 1]) / torch.clamp(pdf_n, min=1e-12), 0.0)
        new_throughput = thr * f_n * bounce_w[:, None]
        transmitted = dot(wi_world, surf["n_g"]) < 0.0
        new_origin = ray_origin_offset(surf["x"], _where3(transmitted, -surf["n_g"], surf["n_g"]))

        # throughput NaN/Inf kill (pt.cu:469)
        alive = alive & is_finite3(new_throughput) & (pdf_n > 0.0)
        moved = keep & alive
        origin = _where3(moved, new_origin, origin)
        direction = _where3(moved, wi_world, direction)
        throughput = _where3(moved, new_throughput, throughput)
        radiance = _where3(keep, rad, radiance)
        depth += 1

    # radiance NaN scrub (pt.cu:474-478)
    radiance = _where3(is_finite3(radiance), radiance, 0.0)
    return {
        "radiance": radiance,
        "position": position,
        "normal": normal_aov,
        "depth": depth_aov,
        "texcoord": texcoord_aov,
        "albedo": albedo,
        "n_path_vertices": n_path_vertices,
        # lane-bounce slots executed (occupancy = n_path_vertices / this)
        "n_lane_slots": torch.tensor(float(depth * n), dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# progressive accumulation


def render_progressive(dev: Dict, params: Dict, layers: Dict, sample_count,
                       n_samples: int):
    """Accumulate n_samples progressive samples into the render layers.

    layers: make_layers() dict; sample_count: [N] int64 (uint32 values).
    The fused pipeline renders each sample where params["use_fused"] is
    true (the default), `render_sample` otherwise (pt.py:999-1002).
    Returns (new_layers, new_sample_count)."""
    if params.get("use_fused", True):
        from ..fused.pt_fused import render_sample_fused as sample_fn
    else:
        sample_fn = render_sample

    for _ in range(n_samples):
        out = sample_fn(dev, params, sample_count)
        nf = sample_count.to(torch.float32)
        coef = 1.0 / (nf + 1.0)

        def avg(old, new, vec):
            c = coef[:, None] if vec else coef
            nn = nf[:, None] if vec else nf
            return c * (nn * old + new)

        layers = {
            "beauty": avg(layers["beauty"], out["radiance"], True),
            "position": avg(layers["position"], out["position"], True),
            "normal": avg(layers["normal"], out["normal"], True),
            "depth": avg(layers["depth"], out["depth"], False),
            "texcoord": avg(layers["texcoord"], out["texcoord"], True),
            "albedo": avg(layers["albedo"], out["albedo"], True),
            # float32 like the reference (pt.py:1021): parity over speed
            "n_path_vertices": layers["n_path_vertices"]
            + out["n_path_vertices"],
            "n_lane_slots": layers["n_lane_slots"] + out["n_lane_slots"],
        }
        sample_count = sample_count + 1
    return layers, sample_count


def make_layers(n: int, device) -> Dict:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "beauty": z(n, 3),
        "position": z(n, 3),
        "normal": z(n, 3),
        "depth": z(n),
        "texcoord": z(n, 2),
        "albedo": z(n, 3),
        # lifetime count of shaded path vertices (for perf accounting)
        "n_path_vertices": z(),
        # lifetime count of executed lane-bounce slots
        "n_lane_slots": z(),
    }
