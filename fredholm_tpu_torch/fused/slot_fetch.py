"""Hit-attribute fetch keyed by traversal slot (clustered scenes).

Port of fredholm_tpu/fused/slot_fetch.py. The scene upload lays the
per-face geometry attributes out in slot order ([32, K*128] float32, the
blocks layout; slot = cid * 128 + in-cluster index), and the fetch reads
the 26 used rows for each hit slot:

  out[a, i] = slot_attrs[a, slot[i]] if 0 <= slot[i] < S else 0,  a < 26

Rows follow pt_fused's geometry columns (v0, v1, v2, n0, n1, n2, uv0-2,
area, mat_id), so the planes take the place of the fused_table row
gather; the material stage is unchanged. `fetch_geom_by_slot` launches
csrc/slot_fetch.cu on CUDA tensors (or raises) and runs the twin on CPU
tensors.
"""

from __future__ import annotations

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


def fetch_twin(slot_attrs: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch fetch: [26, N] float32."""
    _build.LAUNCHES["slot_fetch_twin"] += 1
    s = slot.to(torch.int64)
    hit = (s >= 0) & (s < slot_attrs.shape[1])
    rows = slot_attrs[:A_USED, torch.clamp(s, 0, slot_attrs.shape[1] - 1)]
    return torch.where(hit[None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


def fetch_geom_by_slot(slot_attrs: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Geometry-attribute planes [26, N] for hit slots [N] (-1 = miss)."""
    if slot_attrs.dtype != torch.float32 or slot_attrs.dim() != 2 \
            or slot_attrs.shape[0] != SLOT_ROWS or not slot_attrs.is_contiguous():
        raise ValueError(f"slot_attrs must be contiguous float32 [{SLOT_ROWS}, S]")
    if slot.dtype != torch.int32 or slot.dim() != 1 or not slot.is_contiguous():
        raise ValueError("slot must be a contiguous int32 [N]")
    if slot.device != slot_attrs.device:
        raise ValueError("slot and slot_attrs on different devices")
    if slot.device.type == "cpu":
        return fetch_twin(slot_attrs, slot)
    if slot.device.type != "cuda":
        raise NotImplementedError(f"no slot-fetch kernel for device {slot.device}")
    n = slot.shape[0]
    out = torch.empty((A_USED, n), dtype=torch.float32, device=slot.device)
    stream = torch.cuda.current_stream(slot.device).cuda_stream
    err = _build.lib().fh_slot_fetch(slot.data_ptr(), n, slot_attrs.data_ptr(),
                                     slot_attrs.shape[1], out.data_ptr(), stream)
    _build.check(err, "slot_fetch")
    _build.LAUNCHES["slot_fetch"] += 1
    return out
