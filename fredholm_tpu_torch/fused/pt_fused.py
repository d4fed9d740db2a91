"""Fused wavefront integrator: raygen, per-bounce trace + shade, final
resolve (port of fredholm_tpu/fused/pt_fused.py).

The pipeline bodies (`raygen_body`, `mega_body`, `final_resolve_body`)
are the reference's jnp bodies written over torch tensors, line for line,
with the sampler draw order of pt.cu (RR, NEE, light, bounce). They are
the plain twins of the three CUDA kernels in csrc/shade.cu.

Around them sit the stage functions the kernels implement. A stage reads
and writes packed float32 planes so one kernel launch touches a handful
of buffers:

  state   [14, N]    o xyz, d xyz, thr rgb, rad rgb, nv, alive (0/1)
  pending [14, N]    c_sky rgb, c_area rgb, tpf rgb, pdf_l, wi_l_y, c_dl rgb
  aov     [12, N]    position, normal, depth, texcoord uv, albedo
  rays    [7, B*N]   o xyz, d xyz, tmax; one N-wide block per ray kind in
                     `FusedConfig.blocks` order: NEE blocks (sky, [dl],
                     [area]), then light, then rad

Dense scenes trace every block with one closest-hit call. Clustered
scenes split occlusion off (pt_fused.py:1272-1294): the blocks that need
only a boolean (`FusedConfig.occ_blocks`, a prefix of the buffer) ride
the any-hit kernel, the rest (a suffix) the closest-hit kernel, whose
hit slots key the attribute fetch (fused/slot_fetch.py). With
FREDHOLM_TRAV_RESIDENT=1 the incoherent traces (d > 0 and the final
stage) take the ray-resident traversal (experimental/resident.py), whose
hits carry no slot: their shading reads geometry by prim from
fused_table. FREDHOLM_COMPACT packs live rays ahead of each trace
(experimental/compact.py).

uint32 planes (n_spp, sample_idx, usv) are int64 tensors (core/rng.py).
Lane i is pixel i (no swizzle; the whole frame is one band).

Textures ride the fetch of the hit attributes (`fetch_texture_planes`,
the reference's gather-stage fetch, pt_fused.py:534): each kind in
`FusedConfig.tex_kinds` adds planes tx_<kind>_* to the attributes of the
radiance hit (and of the light ray's hit, for the emission texture), which
mega_body applies elementwise: the shading-parameter overrides, bump and
normal mapping, and the textured emission. The CUDA kernel fetches the
texels itself (csrc/shade.cu `k_mega_tex`).

Envelope: constant or Hosek sky, optional directional light, no alpha
cutout, <= MAX_KERNEL_LIGHTS area lights; the Renderer raises
NotImplementedError naming what is missing.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core.rng import MASK, mul32, u32, xxhash32
from ..scene.device import COL, GEOM_COLS, GEOM_COLS_USED, MAT_COLS, TEX_KINDS
from ..scene.texture import sample_texture_hdr
from . import cbsdf
from .cmappings import (
    draw_cmj_2d,
    draw_sobol_1d,
    sample_cosine_weighted_hemisphere,
    sample_concentric_disk,
    sample_triangle,
)
from .cvec import (
    V3,
    cross,
    dot,
    from_stacked,
    is_finite3,
    length,
    local_to_world,
    normalize,
    orthonormal_basis,
    ray_origin_offset,
    rgb_to_luminance,
    to_stacked,
    vsplat,
    where3,
    world_to_local,
)

RAY_TMAX = 1e9
SHADOW_RAY_EPS = 1e-3  # pt.cu:11
MAX_KERNEL_LIGHTS = 16

# packed plane rows (module docstring)
ST_O, ST_D, ST_THR, ST_RAD, ST_NV, ST_ALIVE, ST_ROWS = 0, 3, 6, 9, 12, 13, 14
PD_SKY, PD_AREA, PD_TPF, PD_PDF_L, PD_WI_L_Y, PD_DL, PD_ROWS = 0, 3, 6, 9, 10, 11, 14
AOV_POS, AOV_NRM, AOV_DEPTH, AOV_TU, AOV_TV, AOV_ALB, AOV_ROWS = 0, 3, 6, 7, 8, 9, 12
RAY_ROWS = 7

SKY_CONSTANT = 0
SKY_HOSEK = 2  # the reference's numbering (SKY_IBL = 1 is not ported)

# ---------------------------------------------------------------------------
# scalar-vector packing (pt_fused.py:240-289)

SV_SIZE = 64
_SV = {
    "cam": 0, "fov": 12, "F": 13, "focus": 14, "sky_intensity": 15,
    "bg": 16, "sun_dir": 19, "dl_le": 22, "dl_dir": 25, "dl_angle": 28,
    "hosek_cfg": 29, "hosek_rad": 56,
}
USV_SIZE = 8
_USV = {"seed_hash": 0, "n_pixels": 1}


def pack_scalars(params: Dict, n_pixels: int, device):
    """(sv [64] f32, usv [8] uint32-in-int64) on `device`.

    params: camera (Camera.device_params or numpy values), seed, and
    optionally bg_color, sky_intensity, sun_direction, directional_light
    {le, dir, angle} and hosek {configs [3, 9], radiances [3]}."""
    sv = np.zeros((SV_SIZE,), np.float32)
    cam = params["camera"]

    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    sv[0:12] = host(cam["transform"]).reshape(-1)
    sv[12] = host(cam["fov"])
    sv[13] = host(cam["F"])
    sv[14] = host(cam["focus"])
    sv[15] = host(params.get("sky_intensity", 1.0))
    sv[16:19] = host(params.get("bg_color", np.zeros(3)))
    sv[19:22] = host(params.get("sun_direction", np.zeros(3)))
    if "directional_light" in params:
        dl = params["directional_light"]
        sv[22:25] = host(dl["le"])
        sv[25:28] = host(dl["dir"])
        sv[28] = host(dl["angle"])
    if "hosek" in params:
        sv[29:56] = host(params["hosek"]["configs"]).reshape(-1)
        sv[56:59] = host(params["hosek"]["radiances"])
    usv = np.zeros((USV_SIZE,), np.int64)
    usv[0] = int(xxhash32(torch.tensor(int(params["seed"]) % (1 << 32))))
    usv[1] = n_pixels % (1 << 32)
    return (
        torch.as_tensor(sv, device=device),
        torch.as_tensor(usv, device=device),
    )


def _sv3(sv, base) -> V3:
    return V3(sv[base], sv[base + 1], sv[base + 2])


# ---------------------------------------------------------------------------
# static pipeline config


class FusedConfig(NamedTuple):
    """Static pipeline config (pt_fused.py:300-344 without IBL, which the
    port does not have yet)."""

    width: int
    height: int
    max_depth: int
    n_lights: int
    lobes_on: tuple
    sky_mode: int = SKY_CONSTANT
    has_dl: bool = False
    # wavefront compaction around the traces (experimental/compact.py)
    compact: str = "0"
    # texture kinds any scene material uses (a subset of TEX_KINDS, in its
    # order); empty: no texture fetch at all
    tex_kinds: tuple = ()

    @property
    def has_area(self) -> bool:
        return self.n_lights > 0

    @property
    def nee_blocks(self) -> tuple:
        return ("sky",) + (("dl",) if self.has_dl else ()) \
            + (("area",) if self.has_area else ())

    @property
    def blocks(self) -> tuple:
        """Ray blocks a bounce emits, in buffer order."""
        return self.nee_blocks + ("light", "rad")

    def occ_blocks(self, split: bool) -> tuple:
        """Blocks that need only an occlusion boolean and ride the any-hit
        trace when occlusion is split off (pt_fused.py:1287-1294): the NEE
        blocks, and the light block when no face emits. A prefix of
        `blocks`."""
        if not split:
            return ()
        return self.nee_blocks + (() if self.has_area else ("light",))

    @property
    def n1(self) -> int:  # Sobol 1D draws per bounce
        return 3 + (1 if self.has_area else 0)

    @property
    def n2(self) -> int:  # CMJ 2D draws per bounce
        return 3 + (1 if self.has_dl else 0) + (1 if self.has_area else 0)

    def sobol_dim(self, d: int, slot: int) -> int:
        """slot 0=rr, then area_u1 (if any), light_u1, bounce_u1 in order."""
        return 1 + d * self.n1 + slot

    def cmj_depth(self, d: int, slot: int) -> int:
        """slot among present [dl, sky, area, light, bounce] in order."""
        return 2 + d * self.n2 + slot


# ---------------------------------------------------------------------------
# pipeline bodies (twins of csrc/shade.cu)

# cos(pi/2 - 1e-3) in float32: the Hosek model's horizon clamp of theta
HOSEK_COS_T_MIN = float(np.float32(np.cos(0.5 * np.pi - 1e-3)))
_ACOS_COEFS = (0.0066700901, -0.0170881256, 0.0308918810, -0.0501743046,
               0.0889789874, -0.2145988016, 1.5707963050)


def _acos_poly(x):
    """acos by the Abramowitz-Stegun 4.4.45 polynomial, as the reference
    evaluates it (pt_fused.py:364-374; |err| < 2e-8 rad). The argument of
    the square root is clamped at 0, so |x| = 1 gives 0 and pi exactly."""
    ax = torch.abs(x)
    p = torch.full_like(ax, -0.0012624911)
    for c in _ACOS_COEFS:
        p = p * ax + c
    r = p * torch.sqrt(torch.clamp(1.0 - ax, min=0.0))
    return torch.where(x < 0.0, float(np.float32(np.pi)) - r, r)


def eval_sky_c(cfg: FusedConfig, sv, v: V3) -> V3:
    """Component-form eval_sky, constant or Hosek (pt_fused.py:377-421)."""
    if cfg.sky_mode == SKY_CONSTANT:
        bg = _sv3(sv, _SV["bg"])
        one = torch.ones_like(v.y)
        return V3(bg.x * one, bg.y * one, bg.z * one)
    intensity = sv[_SV["sky_intensity"]]
    sun = _sv3(sv, _SV["sun_dir"])
    cos_g = torch.clamp(sun.x * v.x + sun.y * v.y + sun.z * v.z, -1.0, 1.0)
    gamma = _acos_poly(cos_g)
    # theta = min(arccos(y), pi/2 - 1e-3)  =>  cos_t = max(y, cos(pi/2 - 1e-3))
    cos_t = torch.clamp(torch.clamp(v.y, -1.0, 1.0), min=HOSEK_COS_T_MIN)
    zenith = torch.sqrt(torch.clamp(cos_t, min=0.0))
    ray_m = cos_g * cos_g
    out = []
    for ch in range(3):
        base = _SV["hosek_cfg"] + 9 * ch
        c = [sv[base + k] for k in range(9)]
        exp_m = torch.exp(c[4] * gamma)
        # the reference's floor keeps mie_b > 0 where cos_g = +-1 and
        # c8 = +-1 (the forward / backward peak)
        mie_b = torch.clamp(1.0 + c[8] * c[8] - 2.0 * c[8] * cos_g, min=1e-8)
        mie_m = (1.0 + cos_g * cos_g) / (mie_b * torch.sqrt(mie_b))
        r = (1.0 + c[0] * torch.exp(c[1] / (cos_t + 0.01))) * (
            c[2] + c[3] * exp_m + c[5] * ray_m + c[6] * mie_m + c[7] * zenith
        )
        out.append(torch.clamp(r * sv[_SV["hosek_rad"] + ch], min=0.0))
    return V3(out[0] * intensity, out[1] * intensity, out[2] * intensity)


def raygen_body(cfg: FusedConfig, sv, usv, px, py, image_idx, n_spp):
    """Camera ray + depth-0 RR draw (pt.cu:418-462 head).

    px/py: f32 pixel coords; image_idx/n_spp: uint32 planes. Returns a
    state dict (o/d V3, tmax, thr V3, alive, sample_idx)."""
    seed_hash = usv[_USV["seed_hash"]]
    n_pixels = usv[_USV["n_pixels"]]
    sample_idx = (u32(image_idx) + mul32(u32(n_spp), n_pixels)) & MASK

    # camera draws: CMJ depths 0 (pixel jitter) and 1 (lens)
    jx, jy = draw_cmj_2d(n_spp, image_idx, 0, seed_hash)
    lx, ly = draw_cmj_2d(n_spp, image_idx, 1, seed_hash)

    # pixel_uv (camera.py:146-151)
    u = (2.0 * (px + jx) - cfg.width) / cfg.height
    v = (2.0 * (py + jy) - cfg.height) / cfg.height
    uvx, uvy = -u, v

    # thin-lens (camera.cu:24-53)
    f = 1.0 / torch.tan(0.5 * sv[_SV["fov"]])
    b = sv[_SV["focus"]]
    a = 1.0 / (1.0 + f - 1.0 / b)
    lens_radius = 2.0 * f / sv[_SV["F"]]

    zeros = torch.zeros_like(uvx)
    p_sensor = V3(uvx, uvy, zeros)
    p_lens_center = V3(zeros, zeros, zeros + f)
    dx, dy = sample_concentric_disk(lx, ly)
    p_lens = V3(
        p_lens_center.x + lens_radius * dx,
        p_lens_center.y + lens_radius * dy,
        p_lens_center.z,
    )
    stl = normalize(p_lens_center - p_sensor)
    t_obj = (a + b) / stl.z
    p_object = V3(
        p_sensor.x + t_obj * stl.x,
        p_sensor.y + t_obj * stl.y,
        p_sensor.z + t_obj * stl.z,
    )

    m = [sv[_SV["cam"] + k] for k in range(12)]
    origin = V3(
        m[0] * p_lens.x + m[1] * p_lens.y + m[2] * p_lens.z + m[3],
        m[4] * p_lens.x + m[5] * p_lens.y + m[6] * p_lens.z + m[7],
        m[8] * p_lens.x + m[9] * p_lens.y + m[10] * p_lens.z + m[11],
    )
    dloc = normalize(p_object - p_lens)
    dloc = V3(dloc.x, dloc.y, -dloc.z)  # z-flip (camera.cu:19)
    direction = V3(
        m[0] * dloc.x + m[1] * dloc.y + m[2] * dloc.z,
        m[4] * dloc.x + m[5] * dloc.y + m[6] * dloc.z,
        m[8] * dloc.x + m[9] * dloc.y + m[10] * dloc.z,
    )

    # depth-0 RR draw (prob 1; the draw is still consumed, pt.cu:455-462)
    u_rr = draw_sobol_1d(sample_idx, cfg.sobol_dim(0, 0), seed_hash)
    alive = u_rr < 1.0
    one = torch.ones_like(u_rr)
    return {
        "o": origin,
        "d": direction,
        "tmax": torch.where(alive, RAY_TMAX, -1.0),
        "thr": V3(one, one, one),
        "alive": alive,
        "sample_idx": sample_idx,
    }


def _interp3(attr, base, w0, w1, w2) -> V3:
    """Interpolate a per-vertex vec3 attribute laid out as 9 consecutive
    columns (v0.xyz, v1.xyz, v2.xyz) starting at `base`."""
    return V3(
        w0 * attr[base + 0] + w1 * attr[base + 3] + w2 * attr[base + 6],
        w0 * attr[base + 1] + w1 * attr[base + 4] + w2 * attr[base + 7],
        w0 * attr[base + 2] + w1 * attr[base + 5] + w2 * attr[base + 8],
    )


def _attr3(attr, name) -> V3:
    c = COL[name]
    return V3(attr[c], attr[c + 1], attr[c + 2])


def _shading_params_from_attr(attr) -> Dict:
    """fill_shading_params, no-texture path (pt.py:222-256)."""
    return {
        "base_color": _attr3(attr, "base_color"),
        "diffuse": attr[COL["diffuse"]],
        "diffuse_roughness": attr[COL["diffuse_roughness"]],
        "specular": attr[COL["specular"]],
        "specular_color": _attr3(attr, "specular_color"),
        "specular_roughness": torch.clamp(attr[COL["specular_roughness"]], 0.01, 1.0),
        "metalness": attr[COL["metalness"]],
        "coat": torch.clamp(attr[COL["coat"]], 0.0, 1.0),
        "coat_roughness": torch.clamp(attr[COL["coat_roughness"]], 0.0, 1.0),
        "coat_color": _attr3(attr, "coat_color"),
        "transmission": attr[COL["transmission"]],
        "transmission_color": _attr3(attr, "transmission_color"),
        "sheen": attr[COL["sheen"]],
        "sheen_color": _attr3(attr, "sheen_color"),
        "sheen_roughness": attr[COL["sheen_roughness"]],
        "subsurface": attr[COL["subsurface"]],
        "subsurface_color": _attr3(attr, "subsurface_color"),
        "thin_walled": attr[COL["thin_walled"]],
    }


def fetch_texture_planes(runs, cfg: FusedConfig, attrs: Dict, w1, w2) -> None:
    """The gather stage's texture fetch (pt_fused.py:534-584): for each
    kind in cfg.tex_kinds, add planes tx_<kind>_{has,r,g,b} (heightmap:
    tx_heightmap_{has,dfdu,dfdv}) to attrs, sampled at the hit's
    interpolated uv with the header in the material row's tx_<kind>
    columns. runs: the scene's [R, 16] texel runs (dev["tex_runs"])."""
    if not cfg.tex_kinds:
        return
    w0 = 1.0 - w1 - w2
    u = w0 * attrs[COL["uv0"]] + w1 * attrs[COL["uv1"]] + w2 * attrs[COL["uv2"]]
    v = w0 * attrs[COL["uv0"] + 1] + w1 * attrs[COL["uv1"] + 1] + w2 * attrs[COL["uv2"] + 1]
    for kind in cfg.tex_kinds:
        base = COL["tx_" + kind]
        tid = attrs[base]
        hdr = tuple(attrs[base + i] for i in range(1, 6))
        has = torch.where(tid >= 0.0, 1.0, 0.0)
        if kind == "heightmap":
            # bump mapping's forward differences (pt.cu:710-725): taps at
            # uv, uv + (1/w, 0) and uv + (0, 1/h). A material without a
            # heightmap takes a step of 0 where the reference divides by
            # its header (ROADMAP Queue C item 4): its planes are masked
            # either way
            du = torch.where(hdr[1] > 0.0, 1.0 / hdr[1], 0.0)
            dv = torch.where(hdr[2] > 0.0, 1.0 / hdr[2], 0.0)
            h0 = sample_texture_hdr(runs, u, v, hdr)[0]
            hdu = sample_texture_hdr(runs, u + du, v, hdr)[0]
            hdv = sample_texture_hdr(runs, u, v + dv, hdr)[0]
            attrs["tx_heightmap_has"] = has
            attrs["tx_heightmap_dfdu"] = hdu - h0
            attrs["tx_heightmap_dfdv"] = hdv - h0
            continue
        rgba = sample_texture_hdr(runs, u, v, hdr)
        attrs["tx_" + kind + "_has"] = has
        attrs["tx_" + kind + "_r"] = rgba[0]
        attrs["tx_" + kind + "_g"] = rgba[1]
        attrs["tx_" + kind + "_b"] = rgba[2]


def _apply_tex_overrides(cfg: FusedConfig, sp: Dict, attrs) -> None:
    """fill_shading_params' texture overrides (pt_fused.py:587-650) from
    the fetched planes."""
    kinds = cfg.tex_kinds
    if not kinds:
        return

    def has(k):
        return attrs["tx_" + k + "_has"] > 0.0

    def c3(k):
        return V3(attrs["tx_" + k + "_r"], attrs["tx_" + k + "_g"], attrs["tx_" + k + "_b"])

    def c1(k, ch="r"):
        return attrs["tx_" + k + "_" + ch]

    if "base_color" in kinds:
        sp["base_color"] = where3(has("base_color"), c3("base_color"), sp["base_color"])
    if "specular_color" in kinds:
        sp["specular_color"] = where3(has("specular_color"), c3("specular_color"),
                                      sp["specular_color"])
    if "specular_roughness" in kinds:
        sp["specular_roughness"] = torch.where(
            has("specular_roughness"), torch.clamp(c1("specular_roughness"), 0.01, 1.0),
            sp["specular_roughness"])
    if "metalness" in kinds:
        sp["metalness"] = torch.where(has("metalness"), c1("metalness"), sp["metalness"])
    if "metallic_roughness" in kinds:
        # glTF packing (pt.cu:230-236): g = roughness, b = metalness
        h = has("metallic_roughness")
        sp["specular_roughness"] = torch.where(
            h, torch.clamp(c1("metallic_roughness", "g"), 0.01, 1.0), sp["specular_roughness"])
        sp["metalness"] = torch.where(
            h, torch.clamp(c1("metallic_roughness", "b"), 0.0, 1.0), sp["metalness"])
    if "coat" in kinds:
        sp["coat"] = torch.where(has("coat"), torch.clamp(c1("coat"), 0.0, 1.0), sp["coat"])
    if "coat_roughness" in kinds:
        # reference quirk, mirrored: channel .g, not .r (pt_fused.py:644)
        sp["coat_roughness"] = torch.where(
            has("coat_roughness"), torch.clamp(c1("coat_roughness", "g"), 0.0, 1.0),
            sp["coat_roughness"])


def emission_from_attrs(cfg: FusedConfig, attrs) -> V3:
    """Emission with the emission-texture override (pt_fused.py:652-666)."""
    le = _attr3(attrs, "emission_color")
    if "emission" in cfg.tex_kinds:
        le = where3(attrs["tx_emission_has"] > 0.0,
                    V3(attrs["tx_emission_r"], attrs["tx_emission_g"], attrs["tx_emission_b"]),
                    le)
    return le


def _select_light(light_table, n_lights: int, u1):
    """Light-row select by sampled index (pt.cu:282-322 head). The row's
    le is the material's untextured emission_color: NEE toward an
    emission-textured light sees no texture, as in the reference
    (pt_fused.py:975)."""
    idx = torch.clamp((u1 * n_lights).to(torch.int64), 0, max(n_lights - 1, 0))
    rows = light_table[idx]

    def sel3(col):
        return V3(rows[:, col], rows[:, col + 1], rows[:, col + 2])

    return (
        sel3(0), sel3(3), sel3(6),    # verts
        sel3(9), sel3(12), sel3(15),  # normals
        sel3(18),                      # le
        rows[:, 21],                   # area
    )


def _clip3(v: V3, lo, hi) -> V3:
    return V3(torch.clamp(v.x, lo, hi), torch.clamp(v.y, lo, hi), torch.clamp(v.z, lo, hi))


def _resolve_pending(cfg: FusedConfig, sv, rad: V3, resolve: Dict) -> V3:
    """Apply bounce d-1's pending NEE visibility + BSDF-light-ray MIS
    (pt.cu:767-925 tails)."""
    zero = torch.zeros_like(rad.x)
    z3 = V3(zero, zero, zero)
    for blk in cfg.nee_blocks:
        vis = ~resolve["occ_" + blk]
        c = resolve["c_" + blk]
        rad = rad + where3(vis, c, z3)

    ldir = resolve["l_d"]
    l_hit = resolve["l_hit"]
    le_miss = eval_sky_c(cfg, sv, ldir)
    pdf_light_miss = torch.abs(resolve["wi_l_y"]) / math.pi
    if not cfg.has_area:
        le = where3(l_hit, z3, le_miss)
        pdf_light = pdf_light_miss
    else:
        la = resolve["lattr"]
        lw1 = resolve["l_u"]
        lw2 = resolve["l_v"]
        lw0 = 1.0 - lw1 - lw2
        l_p = _interp3(la, COL["v0"], lw0, lw1, lw2)
        l_n = _interp3(la, COL["n0"], lw0, lw1, lw2)
        l_emissive = (la[COL["has_emission"]] > 0.0) & (dot(-ldir, l_n) > 0.0)
        hit_light = l_hit & l_emissive

        le_hit = emission_from_attrs(cfg, la)
        le = where3(l_hit, where3(hit_light, le_hit, z3), le_miss)

        to_p = l_p - resolve["l_o"]
        r2 = dot(to_p, to_p)
        n_l = max(cfg.n_lights, 1)
        pdf_area_hit = 1.0 / (n_l * torch.clamp(la[COL["area"]], min=1e-12))
        pdf_light_hit = (
            r2 / torch.clamp(torch.abs(dot(-ldir, l_n)), min=1e-12) * pdf_area_hit
        )
        pdf_light = torch.where(hit_light, pdf_light_hit, pdf_light_miss)
    pdf_l = resolve["pdf_l"]
    # guard 0/0 (pt.py keeps mis_w inside a pdf_l>0 where-branch)
    mis_w = torch.where(pdf_l > 0.0, pdf_l / torch.clamp(pdf_l + pdf_light, min=1e-20), 0.0)
    w = _clip3(resolve["tpf"] * vsplat(mis_w), 0.0, 1.0)
    return rad + w * le


def _nee_tmax(c: V3, tmax):
    """Kill a shadow/light ray whose pending contribution is exactly zero:
    the resolve multiplies c by the occlusion boolean, so the trace result
    is irrelevant (bit-identical images)."""
    nz = (c.x > 0.0) | (c.y > 0.0) | (c.z > 0.0)
    return torch.where(nz, tmax, -1.0)


def mega_body(cfg: FusedConfig, d: int, sv, usv, image_idx, n_spp,
              sample_idx, light_table, state: Dict, rhit: Dict,
              rattr: Dict, resolve: Dict):
    """Resolve bounce d-1 pending transport, shade bounce d, emit all of
    bounce d's rays + next RR (pt.cu:455-943 for one depth).

    Returns (new_state, rays {blk: (o V3, d V3, tmax)}, pending, aovs)."""
    seed_hash = usv[_USV["seed_hash"]]
    alive = state["alive"]
    thr = state["thr"]
    zero = torch.zeros_like(rhit["t"])
    z3 = V3(zero, zero, zero)
    rad = state["rad"] if state.get("rad") is not None else z3
    nv = state["nv"] if state.get("nv") is not None else zero

    if d > 0:
        rad = _resolve_pending(cfg, sv, rad, resolve)

    # ---- shade bounce d
    hit = rhit["hit"]
    direction = state["d"]

    if d == 0:
        # sky on first-hit miss (pt.cu:504-523)
        sky_le = eval_sky_c(cfg, sv, direction)
        miss_first = alive & ~hit
        rad = rad + where3(miss_first, thr * sky_le, z3)
    alive = alive & hit
    nv = nv + torch.where(alive, 1.0, 0.0)

    # surface info (pt.py fill_surface_info)
    w1 = rhit["u"]
    w2 = rhit["v"]
    w0 = 1.0 - w1 - w2
    x = _interp3(rattr, COL["v0"], w0, w1, w2)
    fv0 = _attr3(rattr, "v0")
    fv1 = _attr3(rattr, "v1")
    fv2 = _attr3(rattr, "v2")
    n_g = normalize(cross(fv1 - fv0, fv2 - fv0), eps=1e-20)
    n_s = normalize(_interp3(rattr, COL["n0"], w0, w1, w2), eps=1e-20)
    texcoord_u = (
        w0 * rattr[COL["uv0"]] + w1 * rattr[COL["uv1"]]
        + w2 * rattr[COL["uv2"]]
    )
    texcoord_v = (
        w0 * rattr[COL["uv0"] + 1] + w1 * rattr[COL["uv1"] + 1]
        + w2 * rattr[COL["uv2"] + 1]
    )
    is_entering = dot(-direction, n_g) > 0.0
    flip = torch.where(is_entering, 1.0, -1.0)
    n_s = V3(n_s.x * flip, n_s.y * flip, n_s.z * flip)
    n_g = V3(n_g.x * flip, n_g.y * flip, n_g.z * flip)
    tangent, bitangent = orthonormal_basis(n_s)

    # bump, then normal mapping (pt_fused.py:837-872), from the fetched
    # planes
    if "heightmap" in cfg.tex_kinds:
        use_h = rattr["tx_heightmap_has"] > 0.0
        t_b = normalize(tangent + vsplat(rattr["tx_heightmap_dfdu"]) * n_s)
        b_b = normalize(bitangent + vsplat(rattr["tx_heightmap_dfdv"]) * n_s)
        n_b = normalize(cross(t_b, b_b))
        p_tangent = where3(use_h, t_b, tangent)
        p_bitangent = where3(use_h, b_b, bitangent)
        p_n_s = where3(use_h, n_b, n_s)
    else:
        p_tangent, p_bitangent, p_n_s = tangent, bitangent, n_s
    if "normalmap" in cfg.tex_kinds:
        use_n = rattr["tx_normalmap_has"] > 0.0
        # a tangent-space map with +Z normal in a +Y local frame: the
        # decoded (x, y, z) goes in as (x, z, y), on the UN-perturbed frame
        n_m = normalize(local_to_world(
            V3(rattr["tx_normalmap_r"] * 2.0 - 1.0, rattr["tx_normalmap_b"] * 2.0 - 1.0,
               rattr["tx_normalmap_g"] * 2.0 - 1.0),
            tangent, n_s, bitangent))
        p_n_s = where3(use_n, n_m, p_n_s)
        t_m, b_m = orthonormal_basis(p_n_s)
        p_tangent = where3(use_n, t_m, p_tangent)
        p_bitangent = where3(use_n, b_m, p_bitangent)
    tangent, bitangent, n_s = p_tangent, p_bitangent, p_n_s

    sp = _shading_params_from_attr(rattr)
    _apply_tex_overrides(cfg, sp, rattr)

    aovs = None
    if d == 0:
        # first-hit AOVs + emissive-hit termination (pt.cu:745-760)
        capture = alive
        aovs = {
            "position": where3(capture, x, z3),
            "normal": where3(capture, n_s, z3),
            "depth": torch.where(capture, rhit["t"], 0.0),
            "texcoord_u": torch.where(capture, texcoord_u, 0.0),
            "texcoord_v": torch.where(capture, texcoord_v, 0.0),
            "albedo": where3(capture, sp["base_color"], z3),
        }
        emissive = rattr[COL["has_emission"]] > 0.0
        emit_now = capture & emissive
        le0 = emission_from_attrs(cfg, rattr)
        rad = rad + where3(emit_now, thr * le0, z3)
        alive = alive & ~emit_now

    # BSDF context
    wo = world_to_local(-direction, tangent, n_s, bitangent)
    ctx = cbsdf.setup(wo, sp, is_entering, cfg.lobes_on)
    shadow_origin = ray_origin_offset(x, n_g)
    shadow_tmax = torch.where(alive, RAY_TMAX, -1.0)

    rays = {}
    pending = {}

    # ---- NEE (pt.cu:767-890); draw order [dl], sky, [area]
    cmj_slot = 0
    if cfg.has_dl:
        # directional light: a sun disk 1e9 away (pt_fused.py:902-931)
        ux, uy = draw_cmj_2d(n_spp, image_idx, cfg.cmj_depth(d, cmj_slot), seed_hash)
        cmj_slot += 1
        dist = 1e9
        dxx, dyy = sample_concentric_disk(ux, uy)
        ddir_s = _sv3(sv, _SV["dl_dir"])
        ddir = V3(ddir_s.x + zero, ddir_s.y + zero, ddir_s.z + zero)
        disk_r = dist * torch.tan(torch.deg2rad(0.5 * sv[_SV["dl_angle"]]))
        t_dl, b_dl = orthonormal_basis(ddir)
        p_sun = V3(
            dist * ddir.x + disk_r * (t_dl.x * dxx + b_dl.x * dyy),
            dist * ddir.y + disk_r * (t_dl.y * dxx + b_dl.y * dyy),
            dist * ddir.z + disk_r * (t_dl.z * dxx + b_dl.z * dyy),
        )
        sdir_dl = normalize(p_sun - shadow_origin)
        wi = world_to_local(sdir_dl, tangent, n_s, bitangent)
        f = cbsdf.eval(ctx, wo, wi)
        pdf_bsdf = cbsdf.eval_pdf(ctx, wo, wi)
        mis_w = 1.0 / (1.0 + pdf_bsdf)
        wgt = _clip3(thr * vsplat(mis_w * torch.abs(wi.y)) * f, 0.0, 1.0)
        le_dl = _sv3(sv, _SV["dl_le"])
        c_dl = V3(wgt.x * le_dl.x, wgt.y * le_dl.y, wgt.z * le_dl.z)
        pending["c_dl"] = where3(alive, c_dl, z3)
        rays["dl"] = (shadow_origin, sdir_dl, _nee_tmax(pending["c_dl"], shadow_tmax))

    ux, uy = draw_cmj_2d(n_spp, image_idx, cfg.cmj_depth(d, cmj_slot), seed_hash)
    cmj_slot += 1
    wi_sky = sample_cosine_weighted_hemisphere(ux, uy)
    sdir_sky = local_to_world(wi_sky, tangent, n_s, bitangent)
    cos_sky = torch.abs(wi_sky.y)
    pdf_sky = cos_sky / math.pi
    f = cbsdf.eval(ctx, wo, wi_sky)
    pdf_bsdf = cbsdf.eval_pdf(ctx, wo, wi_sky)
    mis_w = pdf_sky / (pdf_sky + pdf_bsdf)
    scale = torch.where(pdf_sky > 0.0, mis_w * cos_sky / torch.clamp(pdf_sky, min=1e-12), 0.0)
    wgt = _clip3(thr * vsplat(scale) * f, 0.0, 1.0)
    sky_le_nee = eval_sky_c(cfg, sv, sdir_sky)
    pending["c_sky"] = where3(alive, wgt * sky_le_nee, z3)
    rays["sky"] = (shadow_origin, sdir_sky,
                   _nee_tmax(pending["c_sky"], shadow_tmax))

    sobol_slot = 1
    if cfg.has_area:
        u1 = draw_sobol_1d(sample_idx, cfg.sobol_dim(d, sobol_slot), seed_hash)
        sobol_slot += 1
        ux, uy = draw_cmj_2d(
            n_spp, image_idx, cfg.cmj_depth(d, cmj_slot), seed_hash
        )
        cmj_slot += 1
        fv0l, fv1l, fv2l, fn0l, fn1l, fn2l, le_l, area_l = _select_light(
            light_table, cfg.n_lights, u1
        )
        b0, b1 = sample_triangle(ux, uy)
        lb0 = 1.0 - b0 - b1
        p_l = V3(
            lb0 * fv0l.x + b0 * fv1l.x + b1 * fv2l.x,
            lb0 * fv0l.y + b0 * fv1l.y + b1 * fv2l.y,
            lb0 * fv0l.z + b0 * fv1l.z + b1 * fv2l.z,
        )
        n_lv = V3(
            lb0 * fn0l.x + b0 * fn1l.x + b1 * fn2l.x,
            lb0 * fn0l.y + b0 * fn1l.y + b1 * fn2l.y,
            lb0 * fn0l.z + b0 * fn1l.z + b1 * fn2l.z,
        )
        pdf_area = 1.0 / (cfg.n_lights * torch.clamp(area_l, min=1e-12))

        to_l = p_l - shadow_origin
        r = length(to_l)
        inv_r = 1.0 / torch.clamp(r, min=1e-12)
        sdir_area = V3(to_l.x * inv_r, to_l.y * inv_r, to_l.z * inv_r)

        front = dot(-sdir_area, n_lv) > 0.0
        wi = world_to_local(sdir_area, tangent, n_s, bitangent)
        f = cbsdf.eval(ctx, wo, wi)
        pdf = (
            r * r / torch.clamp(torch.abs(dot(-sdir_area, n_lv)), min=1e-12)
            * pdf_area
        )
        pdf_bsdf = cbsdf.eval_pdf(ctx, wo, wi)
        mis_w = pdf / (pdf + pdf_bsdf)
        wgt = _clip3(
            thr * vsplat(mis_w * torch.abs(wi.y) / torch.clamp(pdf, min=1e-12)) * f,
            0.0,
            1.0,
        )
        pending["c_area"] = where3(alive & front, wgt * le_l, z3)
        rays["area"] = (
            shadow_origin,
            sdir_area,
            _nee_tmax(pending["c_area"],
                      torch.where(alive, r - SHADOW_RAY_EPS, -1.0)),
        )

    # ---- BSDF-sampled light ray (pt.cu:892-925 head)
    u1 = draw_sobol_1d(sample_idx, cfg.sobol_dim(d, sobol_slot), seed_hash)
    sobol_slot += 1
    ux, uy = draw_cmj_2d(n_spp, image_idx, cfg.cmj_depth(d, cmj_slot), seed_hash)
    cmj_slot += 1
    wi_l, f_l, pdf_l = cbsdf.sample(ctx, wo, u1, ux, uy)
    ldir = local_to_world(wi_l, tangent, n_s, bitangent)
    transmitted = dot(ldir, n_g) < 0.0
    lorigin = ray_origin_offset(x, where3(transmitted, -n_g, n_g))

    tpf_scale = torch.where(
        pdf_l > 0.0, torch.abs(wi_l.y) / torch.clamp(pdf_l, min=1e-12), 0.0
    )
    pending["tpf"] = where3(alive, thr * vsplat(tpf_scale) * f_l, z3)
    rays["light"] = (lorigin, ldir,
                     _nee_tmax(pending["tpf"], torch.where(alive, RAY_TMAX, -1.0)))
    pending["pdf_l"] = pdf_l
    pending["wi_l_y"] = wi_l.y

    # ---- next bounce (pt.cu:927-943)
    u1 = draw_sobol_1d(sample_idx, cfg.sobol_dim(d, sobol_slot), seed_hash)
    ux, uy = draw_cmj_2d(n_spp, image_idx, cfg.cmj_depth(d, cmj_slot), seed_hash)
    wi_n, f_n, pdf_n = cbsdf.sample(ctx, wo, u1, ux, uy)
    wi_world = local_to_world(wi_n, tangent, n_s, bitangent)
    bounce_w = torch.where(
        pdf_n > 0.0, torch.abs(wi_n.y) / torch.clamp(pdf_n, min=1e-12), 0.0
    )
    new_thr = thr * f_n * vsplat(bounce_w)
    transmitted = dot(wi_world, n_g) < 0.0
    new_o = ray_origin_offset(x, where3(transmitted, -n_g, n_g))

    alive_next = alive & is_finite3(new_thr) & (pdf_n > 0.0)

    # dead lanes keep stale ray state (pt.py `keep` masking)
    new_o = where3(alive_next, new_o, state["o"])
    new_d = where3(alive_next, wi_world, direction)
    new_thr = where3(alive_next, new_thr, thr)

    # ---- RR for bounce d+1 (drawn here == start of pt.cu body d+1)
    if d + 1 < cfg.max_depth:
        u_rr = draw_sobol_1d(sample_idx, cfg.sobol_dim(d + 1, 0), seed_hash)
        rr_prob = torch.clamp(rgb_to_luminance(new_thr), 0.0, 1.0)
        alive_next = alive_next & (u_rr < rr_prob)
        inv_rr = 1.0 / torch.clamp(rr_prob, min=1e-12)
        new_thr = V3(new_thr.x * inv_rr, new_thr.y * inv_rr, new_thr.z * inv_rr)

    rays["rad"] = (new_o, new_d, torch.where(alive_next, RAY_TMAX, -1.0))

    new_state = {
        "o": new_o,
        "d": new_d,
        "thr": new_thr,
        "alive": alive_next,
        "rad": rad,
        "nv": nv,
    }
    return new_state, rays, pending, aovs


def final_resolve_body(cfg: FusedConfig, sv, state: Dict, resolve: Dict):
    """Resolve the LAST bounce's pending transport + NaN scrub
    (pt.cu:474-478)."""
    rad = _resolve_pending(cfg, sv, state["rad"], resolve)
    zero = torch.zeros_like(rad.x)
    return where3(is_finite3(rad), rad, V3(zero, zero, zero))




# ---------------------------------------------------------------------------
# attribute fetch + resolve assembly


def _blk(arr, i: int, n: int):
    """Block i (N lanes) of a trace result laid out block after block."""
    return arr[..., i * n:(i + 1) * n]


def _attrs(tables: Dict, prim, geom=None) -> Dict:
    """Geometry of the hits, then the material row by the rounded, clamped
    mat_id (pt_fused.py:1197-1234), as plain indexing. The geometry is the
    slot-fetch planes [26, N] when given (clustered scenes), else the
    fused_table row of the clamped prim."""
    if geom is not None:
        attrs = {c: geom[c] for c in range(GEOM_COLS_USED)}
        mid_f = geom[COL["mat_id"]]
    else:
        table = tables["fused_table"]
        g = table[torch.clamp(prim.to(torch.int64), 0, table.shape[0] - 1)]
        attrs = {c: g[:, c] for c in range(GEOM_COLS_USED)}
        mid_f = g[:, COL["mat_id"]]
    mat_table = tables["fused_mat_table"]
    mid = torch.clamp(torch.round(mid_f).to(torch.int64), 0, mat_table.shape[0] - 1)
    mat = mat_table[mid]
    for c in range(MAT_COLS):
        attrs[GEOM_COLS + c] = mat[:, c]
    return attrs


class Traced(NamedTuple):
    """The traces over a stage's input ray buffer: `occ` (bool) covers its
    first n_occ blocks (the any-hit trace; None when occlusion is not
    split), `hits` (closest-hit dict) the blocks after them, and `geom`
    (slot-fetch planes [26, M], clustered scenes) the same lanes as
    `hits`."""

    hits: Dict = None
    occ: torch.Tensor = None
    geom: torch.Tensor = None

    def n_occ(self, n: int) -> int:
        return 0 if self.occ is None else self.occ.shape[0] // n

    def occluded(self, b: int, n: int):
        """Occlusion of ray block b, from whichever trace carried it."""
        k = self.n_occ(n)
        if b < k:
            return _blk(self.occ, b, n)
        return _blk(self.hits["prim"], b - k, n) >= 0

    def closest(self, b: int, n: int, tables: Dict, cfg: FusedConfig):
        """(hit dict, attrs) of ray block b, which rode the closest trace;
        attrs carry the texture planes of cfg.tex_kinds."""
        j = b - self.n_occ(n)
        h = {k: _blk(self.hits[k], j, n) for k in ("t", "prim", "u", "v")}
        h["hit"] = h["prim"] >= 0
        geom = None if self.geom is None else _blk(self.geom, j, n)
        attrs = _attrs(tables, h["prim"], geom)
        fetch_texture_planes(tables.get("tex_runs"), cfg, attrs, h["u"], h["v"])
        return h, attrs


def _make_resolve(cfg, tables, blocks, n, rays, pending, tr: Traced):
    """Resolve inputs for the previous bounce (pt_fused.py:1297-1328)."""
    prev_rays = _unpack_rays(rays, blocks, n)
    prev_pending = _unpack_pending(pending, cfg)
    li = blocks.index("light")
    resolve = {
        "l_d": prev_rays["light"][1],
        "tpf": prev_pending["tpf"],
        "pdf_l": prev_pending["pdf_l"],
        "wi_l_y": prev_pending["wi_l_y"],
        "l_hit": tr.occluded(li, n),
    }
    if cfg.has_area:
        lhit, resolve["lattr"] = tr.closest(li, n, tables, cfg)
        resolve["l_u"] = lhit["u"]
        resolve["l_v"] = lhit["v"]
        resolve["l_o"] = prev_rays["light"][0]
    for b in cfg.nee_blocks:
        resolve["occ_" + b] = tr.occluded(blocks.index(b), n)
        resolve["c_" + b] = prev_pending["c_" + b]
    return resolve


# ---------------------------------------------------------------------------
# stage twins over packed planes (the functions csrc/shade.cu implements)


def _unpack_state(state):
    return {
        "o": from_stacked(state[ST_O:ST_O + 3]),
        "d": from_stacked(state[ST_D:ST_D + 3]),
        "thr": from_stacked(state[ST_THR:ST_THR + 3]),
        "rad": from_stacked(state[ST_RAD:ST_RAD + 3]),
        "nv": state[ST_NV],
        "alive": state[ST_ALIVE] != 0.0,
    }


def _pack_state(st) -> torch.Tensor:
    alive = st["alive"].to(torch.float32)
    return torch.stack([
        *st["o"], *st["d"], *st["thr"], *st["rad"], st["nv"], alive,
    ])


def _unpack_pending(pending, cfg):
    out = {
        "c_sky": from_stacked(pending[PD_SKY:PD_SKY + 3]),
        "tpf": from_stacked(pending[PD_TPF:PD_TPF + 3]),
        "pdf_l": pending[PD_PDF_L],
        "wi_l_y": pending[PD_WI_L_Y],
    }
    if cfg.has_area:
        out["c_area"] = from_stacked(pending[PD_AREA:PD_AREA + 3])
    if cfg.has_dl:
        out["c_dl"] = from_stacked(pending[PD_DL:PD_DL + 3])
    return out


def _pack_pending(p) -> torch.Tensor:
    zero = torch.zeros_like(p["pdf_l"])
    z3 = V3(zero, zero, zero)
    return torch.stack([*p["c_sky"], *p.get("c_area", z3), *p["tpf"], p["pdf_l"],
                        p["wi_l_y"], *p.get("c_dl", z3)])


def _unpack_rays(rays, blocks, n):
    out = {}
    for i, b in enumerate(blocks):
        r = rays[:, i * n:(i + 1) * n]
        out[b] = (from_stacked(r[0:3]), from_stacked(r[3:6]), r[6])
    return out


def _pack_rays(rays_d, blocks) -> torch.Tensor:
    return torch.cat([
        torch.stack([*rays_d[b][0], *rays_d[b][1], rays_d[b][2]])
        for b in blocks
    ], dim=1)


def _lane_index(cfg: FusedConfig, device):
    return torch.arange(cfg.width * cfg.height, dtype=torch.int64, device=device)


def raygen_twin(cfg: FusedConfig, sv, usv, n_spp):
    """Stage twin of the raygen kernel: (state, sample_idx, rays [7, N])."""
    lane = _lane_index(cfg, sv.device)
    px = (lane % cfg.width).to(torch.float32)
    py = (lane // cfg.width).to(torch.float32)
    st = raygen_body(cfg, sv, usv, px, py, lane, n_spp)
    zero = torch.zeros_like(st["tmax"])
    rays = torch.stack([*st["o"], *st["d"], st["tmax"]])
    state = _pack_state({**st, "rad": V3(zero, zero, zero), "nv": zero})
    return state, st["sample_idx"], rays


def mega_twin(cfg: FusedConfig, d: int, sv, usv, tables: Dict, n_spp,
              sample_idx, state, rays, pending, tr: Traced):
    """Stage twin of the mega kernel: take the hit attributes, assemble the
    resolve of bounce d-1, run mega_body, pack the outputs. rays: the
    previous ray buffer (one block at d = 0), tr: its traces.

    Returns (state, rays [7, B*N], pending, aov or None)."""
    n = state.shape[1]
    lane = _lane_index(cfg, state.device)
    blocks = ("rad",) if d == 0 else cfg.blocks
    rhit, rattr = tr.closest(blocks.index("rad"), n, tables, cfg)
    resolve = (_make_resolve(cfg, tables, blocks, n, rays, pending, tr)
               if d > 0 else {})
    st, rays_d, pend, aovs = mega_body(
        cfg, d, sv, usv, lane, n_spp, sample_idx, tables["light_table"],
        _unpack_state(state), rhit, rattr, resolve,
    )
    aov = None
    if aovs is not None:
        aov = torch.stack([
            *aovs["position"], *aovs["normal"], aovs["depth"],
            aovs["texcoord_u"], aovs["texcoord_v"], *aovs["albedo"],
        ])
    return _pack_state(st), _pack_rays(rays_d, cfg.blocks), _pack_pending(pend), aov


def final_twin(cfg: FusedConfig, sv, tables: Dict, state, rays, pending, tr: Traced):
    """Stage twin of the final-resolve kernel; tr covers the ray blocks
    before "rad". Returns radiance [3, N]."""
    n = state.shape[1]
    resolve = _make_resolve(cfg, tables, cfg.blocks, n, rays, pending, tr)
    return to_stacked(final_resolve_body(cfg, sv, _unpack_state(state), resolve))


# ---------------------------------------------------------------------------
# orchestrator


def _trace_view(dev: Dict, view, any_hit: bool, coherent: bool):
    if "clusters" in dev:
        from ..accel import clustered
        from ..experimental import resident

        c = dev["clusters"]
        if resident.routes(c, coherent):
            fn = resident.intersect_any_resident if any_hit else \
                resident.intersect_closest_resident
        else:
            fn = clustered.intersect_any_clustered if any_hit else \
                clustered.intersect_closest_clustered
        return fn(c, view)
    from ..accel.dense import intersect_closest

    assert not any_hit, "dense scenes trace every block with closest hit"
    return intersect_closest(dev["tri_soa"], view, view.shape[1])


def trace(dev: Dict, rays, b0: int, nb: int, n: int, any_hit: bool = False,
          coherent: bool = False, compact: bool = False):
    """Trace ray blocks [b0, b0 + nb) of the buffer `rays` (a column view):
    clustered scenes through accel/clustered.py (B4/B5), or, for an
    incoherent trace with FREDHOLM_TRAV_RESIDENT=1 on a scene with the
    resident tables, experimental/resident.py (B7, no hit slots); dense
    ones through accel/dense.py (closest hit only). coherent defaults to
    False as the reference's `_trace_c` (pt_fused.py:1103-1180); only the
    primary trace is coherent. With compact, live rays are packed to the
    front first and the results restored to lane order
    (experimental/compact.py), bit for bit."""
    view = rays[:, b0 * n:(b0 + nb) * n]
    if not compact:
        return _trace_view(dev, view, any_hit, coherent)
    from ..experimental import compact as cp

    dest = cp.partition_dest(view[6] > 0.0)
    res = _trace_view(dev, cp.compact_rays(dest, view), any_hit, coherent)
    return cp.uncompact_occ(dest, res) if any_hit else cp.uncompact_hits(dest, res)


def trace_stage(cfg: FusedConfig, dev: Dict, rays, n: int, n_blocks: int,
                n_occ: int, coherent: bool = False) -> Traced:
    """The traces of one stage input: any-hit over the first n_occ blocks,
    closest hit over the rest of the first n_blocks, and (clustered scenes)
    the slot fetch of the closest hits where the shading reads them: the
    "rad" block, and the light block of scenes with emissive faces (moved
    into world space by the hits' instances in instanced scenes). Hits
    without slots (B7, identity scenes only) leave the shading to read
    geometry by prim from fused_table."""
    from ..experimental import compact as cp
    from .slot_fetch import fetch_geom_by_slot

    compact = cp.enabled(cfg.compact, "clusters" not in dev)
    kw = dict(coherent=coherent, compact=compact)
    occ = trace(dev, rays, 0, n_occ, n, any_hit=True, **kw) if n_occ else None
    n_cl = n_blocks - n_occ
    hits = trace(dev, rays, n_occ, n_cl, n, **kw) if n_cl else None
    geom = None
    if hits is not None and "slot" in hits and "slot_rows" in dev:
        # instanced scenes: the planes move into world space in the fetch
        inst = hits["inst"] if "inst_table" in dev else None
        geom = fetch_geom_by_slot(dev["slot_rows"], hits["slot"], inst, dev.get("inst_table"))
    return Traced(hits, occ, geom)


def make_config(dev: Dict, params: Dict) -> FusedConfig:
    return FusedConfig(
        width=params["width"],
        height=params["height"],
        max_depth=params["max_depth"],
        n_lights=dev["n_lights"],
        lobes_on=tuple(params["lobes_on"]),
        sky_mode=params.get("sky_mode", SKY_CONSTANT),
        has_dl="directional_light" in params,
        compact=params.get("compact", "0"),
        tex_kinds=tuple(dev.get("tex_kinds", ())),
    )


def render_sample_fused(dev: Dict, params: Dict, n_spp):
    """One progressive sample of every pixel; returns the stacked [N, ...]
    AOV dict of the reference (radiance, position, normal, depth, texcoord,
    albedo, n_path_vertices, n_lane_slots).

    Each stage goes through its wrapper (accel/, fused/kernels.py,
    fused/slot_fetch.py): on CUDA tensors that is a hand kernel, on CPU
    tensors the twin. Clustered scenes split occlusion off (the reference's
    default for them, pt_fused.py:1458-1595). The primary trace is
    coherent; the bounce and final traces are not, and take the
    ray-resident traversal (B7) where `trace` says."""
    from . import kernels

    cfg = make_config(dev, params)
    n = cfg.width * cfg.height
    nb = len(cfg.blocks)
    n_occ = len(cfg.occ_blocks("clusters" in dev))
    device = dev["fused_table"].device
    sv, usv = pack_scalars(params, n, device)

    state, sample_idx, rays = kernels.raygen(cfg, sv, usv, n_spp)
    pending = None
    aov = None
    for d in range(cfg.max_depth):
        # the primary trace is coherent; the bounces' are not
        tr = (trace_stage(cfg, dev, rays, n, 1, 0, coherent=True) if d == 0
              else trace_stage(cfg, dev, rays, n, nb, n_occ))
        state, rays, pending, aov_d = kernels.mega(
            cfg, d, sv, usv, dev, n_spp, sample_idx, state, rays, pending, tr)
        if d == 0:
            aov = aov_d
    # final: the last bounce's NEE + light blocks (all but "rad")
    tr = trace_stage(cfg, dev, rays, n, nb - 1, n_occ)
    rad = kernels.final(cfg, sv, dev, state, rays, pending, tr)

    return {
        "radiance": rad.T,
        "position": aov[AOV_POS:AOV_POS + 3].T,
        "normal": aov[AOV_NRM:AOV_NRM + 3].T,
        "depth": aov[AOV_DEPTH],
        "texcoord": aov[AOV_TU:AOV_TV + 1].T,
        "albedo": aov[AOV_ALB:AOV_ALB + 3].T,
        "n_path_vertices": torch.sum(state[ST_NV]),
        "n_lane_slots": torch.tensor(float(n * cfg.max_depth),
                                     dtype=torch.float32, device=device),
    }
