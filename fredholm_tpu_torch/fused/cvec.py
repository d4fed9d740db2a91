"""Component-form vector math (V3 = three same-shaped tensors).

Port of fredholm_tpu/fused/cvec.py. Every operation keeps the reference's
evaluation order, so float32 results agree to the last few ulp; the CUDA
kernels (csrc/common.cuh) spell out the same order. jnp.maximum/clip
become torch.clamp, which propagates NaN the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    """Vector/color as three same-shaped component tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # NamedTuple inherits tuple's + and *; override with elementwise math.
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def vsplat(s) -> V3:
    """Scalar tensor -> V3 with the value in every component."""
    return V3(s, s, s)


def from_stacked(a) -> V3:
    """[3, ...] -> V3 (rows are components)."""
    return V3(a[0], a[1], a[2])


def to_stacked(v: V3) -> torch.Tensor:
    """V3 -> [3, ...]."""
    return torch.stack([v.x, v.y, v.z])


def where3(mask, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: V3):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a: V3, eps: float = 0.0) -> V3:
    n2 = torch.clamp(dot(a, a), min=eps)
    inv = torch.rsqrt(n2)
    return V3(a.x * inv, a.y * inv, a.z * inv)


def reflect(w: V3, n: V3) -> V3:
    """Mirror w about n (both unit); bxdf.cu:81-84."""
    d = dot(w, n)
    return normalize(
        V3(-w.x + 2.0 * d * n.x, -w.y + 2.0 * d * n.y, -w.z + 2.0 * d * n.z)
    )


def refract(w: V3, n: V3, ior_i, ior_t):
    """Snell refraction; returns (wt, ok); bxdf.cu:86-94."""
    eta = ior_i / ior_t
    wn = dot(w, n)
    th = V3(
        -eta * (w.x - wn * n.x),
        -eta * (w.y - wn * n.y),
        -eta * (w.z - wn * n.z),
    )
    th2 = dot(th, th)
    ok = th2 <= 1.0
    tp = -torch.sqrt(torch.clamp(1.0 - th2, min=0.0))
    return V3(th.x + tp * n.x, th.y + tp * n.y, th.z + tp * n.z), ok


def orthonormal_basis(n: V3):
    """Duff et al. 2017 branchless ONB (math.cu:7-17)."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    tangent = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bitangent = V3(b, sign + n.y * n.y * a, -n.y)
    return tangent, bitangent


def world_to_local(v: V3, t: V3, n: V3, b: V3) -> V3:
    """World direction -> local (+Y = n) frame (math.cu:19-25)."""
    return V3(dot(v, t), dot(v, n), dot(v, b))


def local_to_world(v: V3, t: V3, n: V3, b: V3) -> V3:
    return V3(
        v.x * t.x + v.y * n.x + v.z * b.x,
        v.x * t.y + v.y * n.y + v.z * b.y,
        v.x * t.z + v.y * n.z + v.z * b.z,
    )


def rgb_to_luminance(c: V3):
    # math.cu:90-93
    return 0.2126729 * c.x + 0.7151522 * c.y + 0.0721750 * c.z


def is_finite3(v: V3):
    return torch.isfinite(v.x) & torch.isfinite(v.y) & torch.isfinite(v.z)


def _offset_component(p, n):
    origin = 1.0 / 32.0
    float_scale = 1.0 / 65536.0
    int_scale = 256.0
    of_i = (int_scale * n).to(torch.int32)
    p_i32 = p.to(torch.float32).view(torch.int32)
    shifted = torch.where(p < 0.0, p_i32 - of_i, p_i32 + of_i)
    p_shift = shifted.view(torch.float32)
    return torch.where(torch.abs(p) < origin, p + float_scale * n, p_shift)


def ray_origin_offset(p: V3, n: V3) -> V3:
    """Robust ray-origin offset (Ray Tracing Gems ch.6; pt.cu:401-416)."""
    return V3(
        _offset_component(p.x, n.x),
        _offset_component(p.y, n.y),
        _offset_component(p.z, n.z),
    )
