"""Wrappers of the three shading kernels in csrc/shade.cu.

The kernels replace fredholm_tpu/fused/kernels.py `tiled_map` as used by
`_raygen_tiled`, `_mega_tiled` and `_final_tiled` (pt_fused.py:1331-1384):
one thread per lane over the packed planes of fused/pt_fused.py. The mega
kernel also fetches the hit's rows of fused_table / fused_mat_table itself
(the reference's `_gather_attrs`) and writes every emitted ray block into
its slice of one [7, B*N] buffer, so the next trace reads it as it is.

The wrappers run the stage twins (fused/pt_fused.py) for CPU tensors only;
for CUDA tensors they launch the kernel or raise. The CUDA BSDF implements
the weight/pmf scaffold of cbsdf.setup and the `diffuse_r` lobe; a config
whose `lobes_on` holds any other lobe raises NotImplementedError before
any launch.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from .. import _build
from ..sampling.sobol import sobol_matrices
from . import pt_fused as pf

CUDA_LOBES = ("diffuse_r",)


def _lobe_mask(cfg: pf.FusedConfig) -> int:
    missing = [lobe for lobe in cfg.lobes_on if lobe not in CUDA_LOBES]
    if missing:
        raise NotImplementedError(
            f"CUDA shading kernel lacks BSDF lobes {missing}; it implements "
            f"{CUDA_LOBES} only"
        )
    return 64 if "diffuse_r" in cfg.lobes_on else 0


@functools.lru_cache(maxsize=4)
def _sobol_device(device: torch.device) -> torch.Tensor:
    """The [128, 32] direction numbers as int32 bits on `device`."""
    return torch.as_tensor(sobol_matrices().view("int32"), device=device)


def _args(cfg: pf.FusedConfig, sv, usv, n_spp, **ptrs) -> _build.ShadeArgs:
    """ShadeArgs for one launch; usv/n_spp may be None for the final
    stage, which draws no samples."""
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
    a.n, a.width, a.height = n, cfg.width, cfg.height
    a.max_depth, a.n_lights = cfg.max_depth, cfg.n_lights
    a.lobe_mask = _lobe_mask(cfg)
    for k, v in ptrs.items():
        setattr(a, k, v)
    return a


def _planes(t: torch.Tensor, rows: int, n: int, dtype, name: str):
    if t.dtype != dtype or t.shape != (rows, n) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} [{rows}, {n}], "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr()


def _hits_ptrs(hits: Dict, m: int):
    for k, dt in (("t", torch.float32), ("prim", torch.int32),
                  ("u", torch.float32), ("v", torch.float32)):
        h = hits[k]
        if h.dtype != dt or h.shape != (m,) or not h.is_contiguous():
            raise ValueError(f"hits[{k}] must be contiguous {dt} [{m}]")
    return dict(hit_t=hits["t"].data_ptr(), hit_prim=hits["prim"].data_ptr(),
                hit_u=hits["u"].data_ptr(), hit_v=hits["v"].data_ptr())


def _tables_ptrs(tables: Dict):
    ft, mt, lt = (tables[k] for k in ("fused_table", "fused_mat_table", "light_table"))
    for name, t, cols in (("fused_table", ft, pf.GEOM_COLS),
                          ("fused_mat_table", mt, pf.MAT_COLS),
                          ("light_table", lt, 24)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != cols \
                or not t.is_contiguous() or t.device.type != "cuda":
            raise ValueError(f"{name} must be a contiguous CUDA float32 [*, {cols}]")
    return dict(fused_table=ft.data_ptr(), mat_table=mt.data_ptr(),
                light_table=lt.data_ptr(), n_faces=ft.shape[0],
                n_mats=mt.shape[0])


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
         sample_idx, state, rays, hits: Dict, pending):
    """Resolve bounce d-1, shade bounce d, emit bounce d's rays and RR.

    rays/hits: the previous ray buffer and its closest hits (one block at
    d = 0). Returns (state, rays [7, B*N], pending [11, N], aov [12, N] at
    d = 0 else None)."""
    if sv.device.type == "cpu":
        _build.LAUNCHES["mega_twin"] += 1
        return pf.mega_twin(cfg, d, sv, usv, tables, n_spp, sample_idx,
                            state, rays, hits, pending)
    n = cfg.width * cfg.height
    dev = sv.device
    nb_in = 1 if d == 0 else len(cfg.blocks)
    if rays.dtype != torch.float32 or rays.shape != (pf.RAY_ROWS, nb_in * n) \
            or not rays.is_contiguous():
        raise ValueError(f"rays must be contiguous float32 [7, {nb_in * n}]")
    if sample_idx.dtype != torch.int64 or sample_idx.shape != (n,):
        raise ValueError("sample_idx must be int64 [N]")
    ptrs = dict(
        state_in=_planes(state, pf.ST_ROWS, n, torch.float32, "state"),
        rays_in=rays.data_ptr(), rays_in_stride=rays.stride(0),
        sample_idx=sample_idx.data_ptr(), d=d,
        **_hits_ptrs(hits, nb_in * n), **_tables_ptrs(tables),
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
    return state_out, rays_out, pending_out, aov


def final(cfg: pf.FusedConfig, sv, tables: Dict, state, rays, hits: Dict,
          pending):
    """Resolve the last bounce and scrub non-finite radiance: [3, N]."""
    if sv.device.type == "cpu":
        _build.LAUNCHES["final_twin"] += 1
        return pf.final_twin(cfg, sv, tables, state, rays, hits, pending)
    n = cfg.width * cfg.height
    dev = sv.device
    nb = len(cfg.blocks)
    if rays.dtype != torch.float32 or rays.shape != (pf.RAY_ROWS, nb * n) \
            or not rays.is_contiguous():
        raise ValueError(f"rays must be contiguous float32 [7, {nb * n}]")
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    ptrs = dict(
        state_in=_planes(state, pf.ST_ROWS, n, torch.float32, "state"),
        pending_in=_planes(pending, pf.PD_ROWS, n, torch.float32, "pending"),
        rays_in=rays.data_ptr(), rays_in_stride=rays.stride(0),
        rad_out=rad.data_ptr(),
        **_hits_ptrs(hits, (nb - 1) * n), **_tables_ptrs(tables),
    )
    a = _args(cfg, sv, None, None, **ptrs)
    _launch("final", _build.lib().fh_final, a, dev)
    return rad
