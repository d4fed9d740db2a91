"""Hit-attribute fetch keyed by traversal slot (clustered scenes).

Port of fredholm_tpu/fused/slot_fetch.py. The scene build lays the
per-face geometry attributes out in slot order (slot = cid * 128 +
in-cluster index): on the host as the reference's plane-major table
`build_slot_attrs` [32, K*128] float32, uploaded slot-major as
`slot_rows` [K*128, 32] (a slot's 26 used words and 6 pad words make one
128-byte row, which a hit reads in 4 sectors; csrc/slot_fetch.cu). The
fetch reads the 26 used words of each hit slot's row into planes:

  out[a, i] = rows[slot[i], a] if 0 <= slot[i] < S else 0,  a < 26

Words follow pt_fused's geometry columns (v0, v1, v2, n0, n1, n2, uv0-2,
area, mat_id), so the planes take the place of the fused_table row
gather; the material stage is unchanged. `fetch_geom_by_slot` launches
csrc/slot_fetch.cu on CUDA tensors (or raises) and runs the twin on CPU
tensors.

Instanced scenes keep object-space geometry in the table; given the hits'
instance ids and the scene's inst_table [I, 24] (scene/device.py
`instance_table`), the fetch also moves each lane's attributes into world
space (fredholm_tpu/fused/pt_fused.py:1237 `_xform_attrs_cols`, which the
reference runs after its fetch): `k_slot_fetch_inst`, twin
`fetch_inst_twin`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from .. import _build

A_USED = 26
SLOT_ROWS = 32


def build_slot_attrs(np_dev: Dict, blocks_row9) -> np.ndarray:
    """[32, n_slots] float32 attribute table in slot order (host numpy;
    slot_fetch.py:50-73). blocks_row9: the slot -> face id map (-1 pads)."""
    prim = np.asarray(blocks_row9)
    n_slots = prim.shape[0]
    filled = prim >= 0
    p = np.where(filled, prim, 0).astype(np.int64)
    fv = np.asarray(np_dev["face_verts"])[p]
    fn = np.asarray(np_dev["face_normals"])[p]
    fuv = np.asarray(np_dev["face_uvs"])[p]
    mid = np.asarray(np_dev["face_mat"])[p]
    e1 = fv[:, 1] - fv[:, 0]
    e2 = fv[:, 2] - fv[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    out = np.zeros((SLOT_ROWS, n_slots), np.float32)
    out[0:9] = np.where(filled, fv.reshape(n_slots, 9).T, 0.0)
    out[9:18] = np.where(filled, fn.reshape(n_slots, 9).T, 0.0)
    out[18:24] = np.where(filled, fuv.reshape(n_slots, 6).T, 0.0)
    out[24] = np.where(filled, area, 0.0)
    out[25] = np.where(filled, mid.astype(np.float32), 0.0)
    return out


def slot_rows(slot_attrs: np.ndarray) -> np.ndarray:
    """The device table: the host table [32, S] slot-major, [S, 32]
    float32, a slot's words in one 128-byte row."""
    return np.ascontiguousarray(np.asarray(slot_attrs, np.float32).T)


def _gather(rows: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """[26, N] planes of the hit slots' rows, zero where slot misses."""
    s = slot.to(torch.int64)
    hit = (s >= 0) & (s < rows.shape[0])
    g = rows[torch.clamp(s, 0, rows.shape[0] - 1), :A_USED]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    return torch.where(hit[:, None], g, zero).T.contiguous()


def fetch_twin(rows: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch fetch: [26, N] float32."""
    _build.LAUNCHES["slot_fetch_twin"] += 1
    return _gather(rows, slot)


def xform_twin(geom: torch.Tensor, inst: torch.Tensor, inst_table: torch.Tensor) -> torch.Tensor:
    """Object-space planes [26, N] -> world space by each lane's instance
    row (pt_fused.py:1237-1269, in its order of operations): vertices by
    the affine rows, normals by the normal matrix then times 1 / sqrt(
    max(|n|^2, 1e-24)), the area from the moved vertices. Every lane, a
    miss (inst 0, zero planes) included."""
    rows = inst_table[torch.clamp(inst.to(torch.int64), 0, inst_table.shape[0] - 1)]
    r = [rows[:, k] for k in range(21)]
    g = list(geom.unbind(0))
    for b in (0, 3, 6):
        x, y, z = g[b], g[b + 1], g[b + 2]
        for k in range(3):
            g[b + k] = r[4 * k] * x + r[4 * k + 1] * y + r[4 * k + 2] * z + r[4 * k + 3]
    for b in (9, 12, 15):
        x, y, z = g[b], g[b + 1], g[b + 2]
        nx, ny, nz = (r[12 + 3 * k] * x + r[13 + 3 * k] * y + r[14 + 3 * k] * z
                      for k in range(3))
        s = 1.0 / torch.sqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-24))
        g[b], g[b + 1], g[b + 2] = nx * s, ny * s, nz * s
    e1 = [g[3 + k] - g[k] for k in range(3)]
    e2 = [g[6 + k] - g[k] for k in range(3)]
    cx = e1[1] * e2[2] - e1[2] * e2[1]
    cy = e1[2] * e2[0] - e1[0] * e2[2]
    cz = e1[0] * e2[1] - e1[1] * e2[0]
    g[24] = 0.5 * torch.sqrt(cx * cx + cy * cy + cz * cz)
    return torch.stack(g)


def fetch_inst_twin(rows: torch.Tensor, slot: torch.Tensor, inst: torch.Tensor,
                    inst_table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch instanced fetch: [26, N] float32, world space."""
    _build.LAUNCHES["slot_fetch_inst_twin"] += 1
    return xform_twin(_gather(rows, slot), inst, inst_table)


def fetch_geom_by_slot(rows: torch.Tensor, slot: torch.Tensor, inst: torch.Tensor = None,
                       inst_table: torch.Tensor = None) -> torch.Tensor:
    """Geometry-attribute planes [26, N] for hit slots [N] (-1 = miss) of
    the row table `rows` (dev["slot_rows"]); in world space by the hits'
    instances [N] where inst_table is given."""
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != SLOT_ROWS \
            or not rows.is_contiguous() or rows.data_ptr() % 16:
        # the kernels read a row with 16-byte loads
        raise ValueError(f"rows must be a contiguous float32 [S, {SLOT_ROWS}] table on a "
                         "16-byte boundary")
    if slot.dtype != torch.int32 or slot.dim() != 1 or not slot.is_contiguous():
        raise ValueError("slot must be a contiguous int32 [N]")
    if slot.device != rows.device:
        raise ValueError("slot and rows on different devices")
    if inst_table is not None:
        if inst_table.dtype != torch.float32 or inst_table.dim() != 2 \
                or inst_table.shape[1] != 24 or inst_table.shape[0] < 1 \
                or not inst_table.is_contiguous() or inst_table.data_ptr() % 16:
            raise ValueError("inst_table must be a contiguous float32 [I >= 1, 24] on a "
                             "16-byte boundary")
        if inst is None or inst.dtype != torch.int32 or inst.shape != slot.shape \
                or not inst.is_contiguous():
            raise ValueError("inst must be a contiguous int32 tensor shaped as slot")
        if inst.device != slot.device or inst_table.device != slot.device:
            raise ValueError("inst, inst_table and slot on different devices")
    if slot.device.type == "cpu":
        if inst_table is not None:
            return fetch_inst_twin(rows, slot, inst, inst_table)
        return fetch_twin(rows, slot)
    if slot.device.type != "cuda":
        raise NotImplementedError(f"no slot-fetch kernel for device {slot.device}")
    n = slot.shape[0]
    out = torch.empty((A_USED, n), dtype=torch.float32, device=slot.device)
    stream = torch.cuda.current_stream(slot.device).cuda_stream
    if inst_table is not None:
        # declared where it is called: `_build.load` also loads builds that lack it
        fetch_inst = _build.lib().fh_slot_fetch_inst
        vp, i = ctypes.c_void_p, ctypes.c_int
        fetch_inst.argtypes = [vp, vp, i, vp, ctypes.c_longlong, vp, i, vp, vp]
        fetch_inst.restype = i
        err = fetch_inst(
            slot.data_ptr(), inst.data_ptr(), n, rows.data_ptr(), rows.shape[0],
            inst_table.data_ptr(), inst_table.shape[0], out.data_ptr(), stream)
        _build.check(err, "slot_fetch_inst")
        _build.LAUNCHES["slot_fetch_inst"] += 1
        return out
    err = _build.lib().fh_slot_fetch(slot.data_ptr(), n, rows.data_ptr(), rows.shape[0],
                                     out.data_ptr(), stream)
    _build.check(err, "slot_fetch")
    _build.LAUNCHES["slot_fetch"] += 1
    return out
