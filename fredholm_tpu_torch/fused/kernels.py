"""Wrappers of the three shading kernels in csrc/shade.cu.

The kernels replace fredholm_tpu/fused/kernels.py `tiled_map` as used by
`_raygen_tiled`, `_mega_tiled` and `_final_tiled` (pt_fused.py:1331-1384):
one thread per lane over the packed planes of fused/pt_fused.py. The mega
and final kernels read each hit's geometry from the slot-fetch planes
(clustered scenes) or fetch the fused_table row themselves (dense
scenes), then the material row (the reference's `_gather_attrs`); they
take each NEE block's occlusion from whichever trace carried it (the
any-hit booleans or the closest hit's prim), and mega writes every
emitted ray block into its slice of one [7, B*N] buffer, so the next
trace reads it as it is.

The wrappers run the stage twins (fused/pt_fused.py) for CPU tensors
only; for CUDA tensors they launch the kernel or raise. The CUDA BSDF
has all seven lobes of cbsdf.ALL_LOBES; a config whose `lobes_on` holds
a name without a lobe bit (the thin film, which routes to the wavefront
integrator) raises NotImplementedError before any launch. Mega runs in
one of four variants (csrc/shade.cu): plain (constant sky, no sun,
diffuse_r only), rich (Hosek sky, sun, metal and specular), full (any of
coat, transmission, sheen and diffuse_t) and tex (any texture kind, with
every feature of the full one; the mega and final kernels then fetch the
texels from dev["tex_runs"]); LAUNCHES counts every mega launch under
"mega" and also under "mega_plain", "mega_rich", "mega_full" or
"mega_tex".
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from .. import _build
from ..bsdf import lut as lut_mod
from ..sampling.sobol import sobol_matrices
from . import cbsdf
from . import pt_fused as pf

CUDA_LOBES = cbsdf.ALL_LOBES
# the lobes only mega's full variant has (csrc/common.cuh LOBES_FULL_ONLY)
FULL_LOBES = ("coat", "transmission", "sheen", "diffuse_t")
CUDA_SKIES = (pf.SKY_CONSTANT, pf.SKY_HOSEK)


def _lobe_mask(cfg: pf.FusedConfig) -> int:
    """Bit k set for lobe cbsdf.ALL_LOBES[k] (csrc/common.cuh LOBE_*)."""
    missing = [lobe for lobe in cfg.lobes_on if lobe not in CUDA_LOBES]
    if missing:
        raise NotImplementedError(
            f"CUDA shading kernel has no BSDF lobes {missing}; it implements "
            f"{CUDA_LOBES}"
        )
    return sum(1 << k for k, lobe in enumerate(cbsdf.ALL_LOBES) if lobe in cfg.lobes_on)


def _tex_mask(cfg: pf.FusedConfig) -> int:
    """Bit k set for texture kind pf.TEX_KINDS[k] (csrc/common.cuh TEX_*)."""
    return sum(1 << k for k, kind in enumerate(pf.TEX_KINDS) if kind in cfg.tex_kinds)


def mega_variant(cfg: pf.FusedConfig) -> str:
    """The mega variant csrc/shade.cu `fh_mega` launches for cfg
    (`tex_mask`, `needs_full`, `needs_rich`): "tex", "full", "rich" or
    "plain"."""
    if cfg.tex_kinds:
        return "tex"
    if any(lobe in FULL_LOBES for lobe in cfg.lobes_on):
        return "full"
    if any(lobe != "diffuse_r" for lobe in cfg.lobes_on) \
            or cfg.sky_mode != pf.SKY_CONSTANT or cfg.has_dl:
        return "rich"
    return "plain"


@functools.lru_cache(maxsize=4)
def _sobol_device(device: torch.device) -> torch.Tensor:
    """The [128, 32] direction numbers as int32 bits on `device`."""
    return torch.as_tensor(sobol_matrices().view("int32"), device=device)


def _lut_device(device: torch.device) -> torch.Tensor:
    """The [16, 16, 2] GGX reflection albedo table on `device` (the
    specular and coat albedos)."""
    return lut_mod.device_table("reflection", device)


def _sheen_lut_device(device: torch.device) -> torch.Tensor:
    """The [16, 16] sheen albedo table on `device`."""
    return lut_mod.device_table("sheen", device)


def _args(cfg: pf.FusedConfig, sv, usv, n_spp, **ptrs) -> _build.ShadeArgs:
    """ShadeArgs for one launch; usv/n_spp may be None for the final
    stage, which draws no samples."""
    if cfg.sky_mode not in CUDA_SKIES:
        raise NotImplementedError(f"sky mode {cfg.sky_mode} has no CUDA kernel")
    n = cfg.width * cfg.height
    checks = [("sv", sv, torch.float32, (pf.SV_SIZE,))]
    if usv is not None:
        checks += [("usv", usv, torch.int64, (pf.USV_SIZE,)),
                   ("n_spp", n_spp, torch.int64, (n,))]
    for name, t, dt, shape in checks:
        if t.device.type != "cuda" or not t.is_contiguous() \
                or t.dtype != dt or t.shape != shape:
            raise ValueError(f"{name} must be a contiguous CUDA {dt} {shape}")
    a = _build.ShadeArgs()
    a.sv = sv.data_ptr()
    if usv is not None:
        a.usv, a.n_spp = usv.data_ptr(), n_spp.data_ptr()
    a.sobol = _sobol_device(sv.device).data_ptr()
    a.lut = _lut_device(sv.device).data_ptr()
    a.sheen_lut = _sheen_lut_device(sv.device).data_ptr()
    a.n, a.width, a.height = n, cfg.width, cfg.height
    a.max_depth, a.n_lights = cfg.max_depth, cfg.n_lights
    a.lobe_mask = _lobe_mask(cfg)
    a.sky_mode, a.has_dl = cfg.sky_mode, int(cfg.has_dl)
    a.tex_mask = _tex_mask(cfg)
    for k, v in ptrs.items():
        setattr(a, k, v)
    return a


def _planes(t: torch.Tensor, rows: int, n: int, dtype, name: str):
    if t.dtype != dtype or t.shape != (rows, n) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} [{rows}, {n}], "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr()


def _traced_ptrs(tr: pf.Traced, n: int, n_blocks: int) -> Dict:
    """Pointers of a stage's traces over n_blocks ray blocks: occlusion
    booleans over the first n_occ blocks, closest hits (and their
    slot-fetch planes) over the rest."""
    n_occ = tr.n_occ(n)
    m = (n_blocks - n_occ) * n
    out = {"hit_block0": n_occ, "hits_m": m}
    if tr.occ is not None:
        if tr.occ.dtype != torch.bool or tr.occ.shape != (n_occ * n,) \
                or not tr.occ.is_contiguous():
            raise ValueError(f"occ must be a contiguous bool [{n_occ * n}]")
        out["occ"] = tr.occ.data_ptr()
    if m == 0:
        if tr.hits is not None:
            raise ValueError("closest hits given for no closest block")
        return out
    for k, dt in (("t", torch.float32), ("prim", torch.int32),
                  ("u", torch.float32), ("v", torch.float32)):
        h = tr.hits[k]
        if h.dtype != dt or h.shape != (m,) or not h.is_contiguous():
            raise ValueError(f"hits[{k}] must be contiguous {dt} [{m}]")
        out["hit_" + k] = h.data_ptr()
    if tr.geom is not None:
        out["geom"] = _planes(tr.geom, pf.GEOM_COLS_USED, m, torch.float32, "geom")
    return out


def _tables_ptrs(tables: Dict):
    ft, mt, lt, tr = (tables[k] for k in ("fused_table", "fused_mat_table", "light_table",
                                          "tex_runs"))
    for name, t, cols, dt in (("fused_table", ft, pf.GEOM_COLS, torch.float32),
                              ("fused_mat_table", mt, pf.MAT_COLS, torch.float32),
                              ("light_table", lt, 24, torch.float32),
                              ("tex_runs", tr, 16, torch.int32)):
        if t.dtype != dt or t.dim() != 2 or t.shape[1] != cols \
                or not t.is_contiguous() or t.device.type != "cuda":
            raise ValueError(f"{name} must be a contiguous CUDA {dt} [*, {cols}]")
    return dict(fused_table=ft.data_ptr(), mat_table=mt.data_ptr(),
                light_table=lt.data_ptr(), n_faces=ft.shape[0],
                n_mats=mt.shape[0], tex_runs=tr.data_ptr(), n_tex_runs=tr.shape[0])


def _rays_ptrs(rays: torch.Tensor, n_blocks: int, n: int):
    if rays.dtype != torch.float32 or rays.shape != (pf.RAY_ROWS, n_blocks * n) \
            or not rays.is_contiguous():
        raise ValueError(f"rays must be contiguous float32 [7, {n_blocks * n}]")
    return dict(rays_in=rays.data_ptr(), rays_in_stride=rays.stride(0))


def _launch(name: str, fn, args: _build.ShadeArgs, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(fn(args, stream), name)
    _build.LAUNCHES[name] += 1


def raygen(cfg: pf.FusedConfig, sv, usv, n_spp):
    """Camera rays + depth-0 RR for every pixel.

    Returns (state [14, N], sample_idx [N] int64, rays [7, N])."""
    if sv.device.type == "cpu":
        _build.LAUNCHES["raygen_twin"] += 1
        return pf.raygen_twin(cfg, sv, usv, n_spp)
    n = cfg.width * cfg.height
    dev = sv.device
    state = torch.empty((pf.ST_ROWS, n), dtype=torch.float32, device=dev)
    sample_idx = torch.empty((n,), dtype=torch.int64, device=dev)
    rays = torch.empty((pf.RAY_ROWS, n), dtype=torch.float32, device=dev)
    a = _args(cfg, sv, usv, n_spp, state_out=state.data_ptr(),
              sample_idx=sample_idx.data_ptr(), rays_out=rays.data_ptr())
    _launch("raygen", _build.lib().fh_raygen, a, dev)
    return state, sample_idx, rays


def mega(cfg: pf.FusedConfig, d: int, sv, usv, tables: Dict, n_spp,
         sample_idx, state, rays, pending, tr: pf.Traced):
    """Resolve bounce d-1, shade bounce d, emit bounce d's rays and RR.

    rays/tr: the previous ray buffer (one block at d = 0) and its traces.
    Returns (state, rays [7, B*N], pending [14, N], aov [12, N] at d = 0
    else None)."""
    if sv.device.type == "cpu":
        _build.LAUNCHES["mega_twin"] += 1
        return pf.mega_twin(cfg, d, sv, usv, tables, n_spp, sample_idx,
                            state, rays, pending, tr)
    n = cfg.width * cfg.height
    dev = sv.device
    nb_in = 1 if d == 0 else len(cfg.blocks)
    if sample_idx.dtype != torch.int64 or sample_idx.shape != (n,):
        raise ValueError("sample_idx must be int64 [N]")
    ptrs = dict(
        state_in=_planes(state, pf.ST_ROWS, n, torch.float32, "state"),
        sample_idx=sample_idx.data_ptr(), d=d, **_rays_ptrs(rays, nb_in, n),
        **_traced_ptrs(tr, n, nb_in), **_tables_ptrs(tables),
    )
    if d > 0:
        ptrs["pending_in"] = _planes(pending, pf.PD_ROWS, n, torch.float32, "pending")
    state_out = torch.empty((pf.ST_ROWS, n), dtype=torch.float32, device=dev)
    rays_out = torch.empty((pf.RAY_ROWS, len(cfg.blocks) * n),
                           dtype=torch.float32, device=dev)
    pending_out = torch.empty((pf.PD_ROWS, n), dtype=torch.float32, device=dev)
    aov = (torch.empty((pf.AOV_ROWS, n), dtype=torch.float32, device=dev)
           if d == 0 else None)
    a = _args(cfg, sv, usv, n_spp, state_out=state_out.data_ptr(),
              rays_out=rays_out.data_ptr(), pending_out=pending_out.data_ptr(),
              aov_out=aov.data_ptr() if aov is not None else None, **ptrs)
    _launch("mega", _build.lib().fh_mega, a, dev)
    _build.LAUNCHES["mega_" + mega_variant(cfg)] += 1
    return state_out, rays_out, pending_out, aov


def final(cfg: pf.FusedConfig, sv, tables: Dict, state, rays, pending, tr: pf.Traced):
    """Resolve the last bounce and scrub non-finite radiance: [3, N].
    tr covers the ray blocks before "rad"."""
    if sv.device.type == "cpu":
        _build.LAUNCHES["final_twin"] += 1
        return pf.final_twin(cfg, sv, tables, state, rays, pending, tr)
    n = cfg.width * cfg.height
    dev = sv.device
    nb = len(cfg.blocks)
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    ptrs = dict(
        state_in=_planes(state, pf.ST_ROWS, n, torch.float32, "state"),
        pending_in=_planes(pending, pf.PD_ROWS, n, torch.float32, "pending"),
        rad_out=rad.data_ptr(), **_rays_ptrs(rays, nb, n),
        **_traced_ptrs(tr, n, nb - 1), **_tables_ptrs(tables),
    )
    a = _args(cfg, sv, None, None, **ptrs)
    _launch("final", _build.lib().fh_final, a, dev)
    return rad
