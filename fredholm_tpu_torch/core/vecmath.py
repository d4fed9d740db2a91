"""Vector math over stacked tensors (trailing dimension 3).

Port of fredholm_tpu/core/vecmath.py, the layout of the wavefront
integrator (integrator/pt.py): a vector batch is one [..., 3] tensor. The
column-form twin of the fused pipeline is fused/cvec.py.

Sums over the vector dimension are written out left to right, the order
XLA:CPU reduces a 3-wide row in (0 + x0 is exact, then + x1, then + x2),
so results agree with the reference to the ulp apart from its FMA
contraction. Local shading frames have +Y as the normal (math.cu:19-35).
"""

from __future__ import annotations

import math

import torch


def vec3(x, y, z):
    """Stack three same-shaped tensors into a [..., 3] vector tensor."""
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def splat(s):
    """Broadcast a [...] tensor to a [..., 3] vector."""
    return s[..., None].expand(s.shape + (3,))


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return vec3(ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a, eps: float = 0.0):
    n2 = torch.clamp(dot(a, a), min=eps)
    return a * torch.rsqrt(n2)[..., None]


def lerp(a, b, t):
    return a + (b - a) * t


def reflect(w, n):
    """Mirror w about n (both unit); bxdf.cu:81-84."""
    return normalize(-w + 2.0 * dot(w, n)[..., None] * n)


def refract(w, n, ior_i, ior_t):
    """Snell refraction of w about n. Returns (wt, ok); ok is False under
    total internal reflection (bxdf.cu:86-94)."""
    eta = ior_i / ior_t
    th = -eta[..., None] * (w - dot(w, n)[..., None] * n)
    th2 = dot(th, th)
    ok = th2 <= 1.0
    tp = -torch.sqrt(torch.clamp(1.0 - th2, min=0.0))[..., None] * n
    return th + tp, ok


def orthonormal_basis(n):
    """Duff et al. 2017 branchless ONB (math.cu:7-17); returns (tangent,
    bitangent) of unit normals n [..., 3]."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    tangent = vec3(1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    bitangent = vec3(b, sign + ny * ny * a, -ny)
    return tangent, bitangent


def world_to_local(v, t, n, b):
    """World direction -> local frame with +Y = n (math.cu:19-25)."""
    return vec3(dot(v, t), dot(v, n), dot(v, b))


def local_to_world(v, t, n, b):
    """Local (+Y up) direction -> world (math.cu:27-35)."""
    return v[..., 0:1] * t + v[..., 1:2] * n + v[..., 2:3] * b


def rgb_to_luminance(rgb):
    """math.cu:90-93 (Bruce Lindbloom sRGB-D65 Y row)."""
    return rgb[..., 0] * 0.2126729 + rgb[..., 1] * 0.7151522 + rgb[..., 2] * 0.0721750


def _mat3_vec(m, v):
    """Rows of m [3, 3] dotted with v [..., 3] (vecmath.py `_mat3_vec`)."""
    return vec3(*(m[i][0] * v[..., 0] + m[i][1] * v[..., 1] + m[i][2] * v[..., 2]
                  for i in range(3)))


_XYZ_TO_RGB = (
    (2.3706743, -0.9000405, -0.4706338),
    (-0.5138850, 1.4253036, 0.0885814),
    (0.0052982, -0.0146949, 1.0093968),
)


def xyz_to_rgb(xyz):
    return _mat3_vec(_XYZ_TO_RGB, xyz)


def cartesian_to_spherical(w):
    """(theta, phi): theta from the +Y pole, phi in [0, 2 pi)
    (math.cu:111-118)."""
    theta = torch.acos(torch.clamp(w[..., 1], -1.0, 1.0))
    phi = torch.atan2(w[..., 2], w[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return theta, phi


def transform_position(m, p):
    """Affine [3, 4] rows applied to positions (shared.h:28-33)."""
    return vec3(*(m[i, 0] * p[..., 0] + m[i, 1] * p[..., 1] + m[i, 2] * p[..., 2] + m[i, 3]
                  for i in range(3)))


def transform_direction(m, v):
    return vec3(*(m[i, 0] * v[..., 0] + m[i, 1] * v[..., 1] + m[i, 2] * v[..., 2]
                  for i in range(3)))


def is_finite3(v):
    return torch.isfinite(v).all(dim=-1)


def ray_origin_offset(p, n):
    """Robust ray-origin offset along the geometric normal (Ray Tracing
    Gems ch. 6; pt.cu:401-416): an integer ulp offset for large
    coordinates, a float offset near the origin."""
    of_i = (256.0 * n).to(torch.int32)
    p_i32 = p.contiguous().view(torch.int32)
    p_shift = torch.where(p < 0.0, p_i32 - of_i, p_i32 + of_i).view(torch.float32)
    return torch.where(torch.abs(p) < 1.0 / 32.0, p + (1.0 / 65536.0) * n, p_shift)
