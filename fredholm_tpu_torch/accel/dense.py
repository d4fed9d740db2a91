"""Dense traces: every ray against every triangle (scenes <= 1024 faces).

Wrappers of the CUDA kernels csrc/dense_closest.cu (B1, the port of
fredholm_tpu/accel/pallas_dense.py `_closest_kernel`) and csrc/dense_any.cu
(B3, `_any_kernel`) and their plain PyTorch twins. Contract, identical to
the reference kernels:

- Moller-Trumbore with |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, t > 0;
- closest hit: strict t < best_t starting from tmax, so on equal t the
  lowest prim wins; a miss, or a dead lane (tmax <= 0), gives prim -1,
  t = tmax, u = v = 0;
- any hit: occluded where some triangle has a valid hit with t < tmax;
  a dead lane gives False.

Rays come as one [7, stride] float32 buffer (rows ox, oy, oz, dx, dy, dz,
tmax); the first `m` columns are traced. The wrappers run the twins only
for CPU tensors; for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import _build

# triangles per twin chunk: bounds the [rays, chunk] temporaries
_TWIN_CHUNK = 64
# the dense kernels' shared-memory table (csrc/common.cuh kDenseMaxTris);
# larger scenes trace clustered (fredholm_tpu/renderer.py dense_threshold)
MAX_FACES = 1024


def moller_trumbore(tri, o, d):
    """Moller-Trumbore of lanes [L] against triangles tri [9, T] (or
    [9, L, T]) in the kernels' evaluation order (pallas_dense `_mt_one`);
    o, d: (x, y, z) triples of [L] tensors. Returns (t, u, v, valid), each
    [L, T]."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return t, u, v, valid


def _chunks(tri: torch.Tensor, rays: torch.Tensor, m: int):
    """(start, t, u, v, valid) of the first m rays against each chunk of
    _TWIN_CHUNK triangles, in triangle order."""
    o = tuple(rays[k, :m] for k in range(3))
    d = tuple(rays[k, :m] for k in range(3, 6))
    for s in range(0, tri.shape[1], _TWIN_CHUNK):
        yield (s, *moller_trumbore(tri[:, s:s + _TWIN_CHUNK], o, d))


def intersect_closest_twin(tri: torch.Tensor, rays: torch.Tensor, m: int) -> Dict:
    """Plain PyTorch closest hit; same contract as the kernel."""
    _build.LAUNCHES["dense_closest_twin"] += 1
    best_t = rays[6, :m].clone()
    prim = torch.full((m,), -1, dtype=torch.int32, device=rays.device)
    bu = torch.zeros_like(best_t)
    bv = torch.zeros_like(best_t)
    for s, t, u, v, valid in _chunks(tri, rays, m):
        t = torch.where(valid & (t < best_t[:, None]), t, torch.inf)
        # first minimum == the sequential sweep's strict-< tie rule
        bt, j = torch.min(t, dim=1)
        improved = bt < best_t
        best_t = torch.where(improved, bt, best_t)
        prim = torch.where(improved, (j + s).to(torch.int32), prim)
        bu = torch.where(improved, torch.gather(u, 1, j[:, None])[:, 0], bu)
        bv = torch.where(improved, torch.gather(v, 1, j[:, None])[:, 0], bv)
    return {"t": best_t, "prim": prim, "u": bu, "v": bv}


def intersect_any_twin(tri: torch.Tensor, rays: torch.Tensor, m: int,
                       stats: Optional[Dict] = None) -> torch.Tensor:
    """Plain PyTorch any hit: occluded bool [m]; same contract as the
    kernel. stats (a dict with a "tri" counter), when given, receives the
    triangle tests the kernel takes for these rays: every live lane tests
    triangles in index order up to and including its first occluder; and
    under "lanes" each lane's count, int64 [m] (0 on a dead lane)."""
    _build.LAUNCHES["dense_any_twin"] += 1
    tmax = rays[6, :m]
    occ = torch.zeros(m, dtype=torch.bool, device=rays.device)
    tests = torch.zeros(m, dtype=torch.int64, device=rays.device)
    for s, t, _, _, valid in _chunks(tri, rays, m):
        hit = valid & (t < tmax[:, None])
        first = torch.argmax(hit.to(torch.int8), dim=1)
        tests += torch.where(occ, 0, torch.where(hit.any(dim=1), first + 1, hit.shape[1]))
        occ |= hit.any(dim=1)
    if stats is not None:
        stats["lanes"] = torch.where(tmax > 0.0, tests, 0)
        stats["tri"] += int(stats["lanes"].sum())
    return occ


def _check(tri: torch.Tensor, rays: torch.Tensor, m: int) -> None:
    if tri.dtype != torch.float32 or tri.dim() != 2 or tri.shape[0] != 9:
        raise ValueError(f"tri must be [9, F] float32, got {tuple(tri.shape)} {tri.dtype}")
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7:
        raise ValueError(f"rays must be [7, M] float32, got {tuple(rays.shape)}")
    if not (tri.is_contiguous() and rays.stride(1) == 1):
        raise ValueError("tri must be contiguous and ray rows unit-stride")
    if not 0 < m <= rays.shape[1]:
        raise ValueError(f"m={m} outside (0, {rays.shape[1]}]")
    if tri.device != rays.device:
        raise ValueError("tri and rays on different devices")


def intersect_closest(tri: torch.Tensor, rays: torch.Tensor, m: int) -> Dict:
    """Closest hit of the first m rays of `rays` against `tri` [9, F].

    Returns {t f32, prim i32, u f32, v f32}, each [m]."""
    _check(tri, rays, m)
    if rays.device.type == "cpu":
        return intersect_closest_twin(tri, rays, m)
    if rays.device.type != "cuda":
        raise NotImplementedError(f"no dense kernel for device {rays.device}")
    f = tri.shape[1]
    if f > MAX_FACES:
        raise NotImplementedError(f"dense kernel takes <= {MAX_FACES} faces, got {f}")
    out = {
        "t": torch.empty(m, dtype=torch.float32, device=rays.device),
        "prim": torch.empty(m, dtype=torch.int32, device=rays.device),
        "u": torch.empty(m, dtype=torch.float32, device=rays.device),
        "v": torch.empty(m, dtype=torch.float32, device=rays.device),
    }
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    err = _build.lib().fh_dense_closest(
        rays.data_ptr(), rays.stride(0), m, tri.data_ptr(), f,
        out["t"].data_ptr(), out["prim"].data_ptr(), out["u"].data_ptr(),
        out["v"].data_ptr(), stream,
    )
    _build.check(err, "dense_closest")
    _build.LAUNCHES["dense_closest"] += 1
    return out


def intersect_any(tri: torch.Tensor, rays: torch.Tensor, m: int) -> torch.Tensor:
    """Occlusion of the first m rays of `rays` by `tri` [9, F]: bool [m]."""
    _check(tri, rays, m)
    if rays.device.type == "cpu":
        return intersect_any_twin(tri, rays, m)
    if rays.device.type != "cuda":
        raise NotImplementedError(f"no dense kernel for device {rays.device}")
    f = tri.shape[1]
    if f > MAX_FACES:
        raise NotImplementedError(f"dense kernel takes <= {MAX_FACES} faces, got {f}")
    occ = torch.empty(m, dtype=torch.bool, device=rays.device)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    err = _build.lib().fh_dense_any(rays.data_ptr(), rays.stride(0), m, tri.data_ptr(), f,
                                    occ.data_ptr(), stream)
    _build.check(err, "dense_any")
    _build.LAUNCHES["dense_any"] += 1
    return occ
