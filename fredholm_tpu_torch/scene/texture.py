"""Texture storage and the bilinear fetch.

Port of fredholm_tpu/scene/texture.py. Each texture is packed into
overlapping 8-wide x 2-tall texel runs (x-stride 4, wrap addressing baked
in), texels as uint32 RGBA8, so any bilinear footprint (x0..x0+1,
y0..y0+1) lies inside one run row: a fetch reads one row. An all-white
1x1 texture always sits last, the fallback every material without a
texture of a kind points at. The host arrays are byte-equal to the
reference's (tests/test_torch_textures.py).

Per texture the header row is (run_offset, width, height, runs_per_row,
srgb) as float32; the fused material table bakes each material's row per
texture kind into its `tx_*` columns (scene/device.py), so the fetch
takes its header from the hit's material row.

`sample_texture_hdr` is the plain twin of csrc/common.cuh `tex_fetch`,
which the textured mega kernel (csrc/shade.cu `k_mega_tex`) calls. On
the device the runs are an int32 tensor holding the uint32 bits.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .types import TextureImage

RUN_W = 8   # texels per run in x
RUN_H = 2   # texel rows per run
X_STRIDE = 4  # run x-stride => any (x0, x0+1) pair is inside one run


def _pack_rgba_u32(data: np.ndarray) -> np.ndarray:
    """[H, W, 4] uint8 -> [H, W] uint32 (r | g<<8 | b<<16 | a<<24)."""
    d = data.astype(np.uint32)
    return d[..., 0] | (d[..., 1] << 8) | (d[..., 2] << 16) | (d[..., 3] << 24)


def _texture_runs(data: np.ndarray) -> np.ndarray:
    """[H, W] uint32 texels -> [H * ceil(W/4), 16] uint32 run rows with
    wrap addressing baked in (column dx + 8*dy covers texel
    ((4*bx + dx) % W, (y + dy) % H))."""
    h, w = data.shape
    rw = (w + X_STRIDE - 1) // X_STRIDE
    out = np.zeros((h * rw, RUN_W * RUN_H), np.uint32)
    ys = np.arange(h)[:, None]
    bx = np.arange(rw)[None, :]
    for dy in range(RUN_H):
        for dx in range(RUN_W):
            out[:, dx + RUN_W * dy] = data[(ys + dy) % h, (X_STRIDE * bx + dx) % w].reshape(-1)
    return out


def texture_headers_np(textures: List[TextureImage]) -> np.ndarray:
    """[K+1, 5] float32 (run_offset, width, height, runs_per_row, srgb),
    the fallback white texture last."""
    rows = []
    off = 0
    for tex in textures:
        h, w = tex.data.shape[:2]
        rw = (w + X_STRIDE - 1) // X_STRIDE
        rows.append((off, w, h, rw, float(bool(tex.is_srgb))))
        off += rw * h
    rows.append((off, 1, 1, 1, 0.0))
    return np.asarray(rows, np.float32).reshape(-1, 5)


def pack_textures(textures: List[TextureImage]) -> Dict[str, np.ndarray]:
    """Host textures -> {"runs": [R, 16] uint32, "header": [K+1, 5]
    float32}, the white fallback texture last (texture.py:86-122). A
    3-channel texture gets alpha 255."""
    blocks = []
    for tex in list(textures) + [
            TextureImage(data=np.full((1, 1, 4), 255, np.uint8), is_srgb=False)]:
        data = tex.data
        if data.shape[-1] == 3:
            data = np.concatenate([data, np.full(data.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        blocks.append(_texture_runs(_pack_rgba_u32(data.astype(np.uint8))))
    header = texture_headers_np(textures)
    # run offsets travel as float32 in the material table: keep them exact
    assert header[-1, 0] < (1 << 24), "texture atlas exceeds 2^24 run rows"
    return {"runs": np.concatenate(blocks, axis=0), "header": header}


def _srgb_to_linear(c):
    # inverse of the display transform (cwl texture sRGB decode)
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


def sample_texture_hdr(runs: torch.Tensor, u, v, header_cols):
    """Bilinear, wrap-addressed fetch (texture.py:131-186) at (u, v) [N]
    given the header planes (off, w, h, rw, srgb) [N] float32; runs:
    [R, 16] int32 (uint32 bits). Returns [4, N] float32, rgb linearized
    where srgb. The width and height are floored at 1 before the wrap, a
    no-op on every real header (the reference takes the modulo as is)."""
    off, w, h, rw, srgb = header_cols
    uu = u * w - 0.5
    vv = v * h - 0.5
    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fx = uu - x0
    fy = vv - y0
    wi = torch.clamp(w.to(torch.int32), min=1)
    hi = torch.clamp(h.to(torch.int32), min=1)
    xw = torch.remainder(x0.to(torch.int32), wi)  # floor-mod, as jnp.mod
    yw = torch.remainder(y0.to(torch.int32), hi)
    ri = off.to(torch.int32) + yw * rw.to(torch.int32) + xw // X_STRIDE
    row = runs[torch.clamp(ri, 0, runs.shape[0] - 1).to(torch.int64)].to(torch.int64) & 0xFFFFFFFF
    lx = (xw % X_STRIDE).to(torch.int64)

    def texel(col0):
        t = torch.gather(row, 1, (lx + col0)[:, None])[:, 0]
        ch = [((t >> s) & 0xFF).to(torch.float32) / 255.0 for s in (0, 8, 16, 24)]
        is_srgb = srgb > 0.0
        return [torch.where(is_srgb, _srgb_to_linear(c), c) for c in ch[:3]] + ch[3:]

    t00, t10, t01, t11 = texel(0), texel(1), texel(RUN_W), texel(RUN_W + 1)
    return torch.stack([
        (1 - fx) * (1 - fy) * a + fx * (1 - fy) * b + (1 - fx) * fy * c + fx * fy * d
        for a, b, c, d in zip(t00, t10, t01, t11)
    ])
