"""Host camera state (port of fredholm_tpu/camera.py, host half).

The FPS-style camera (camera.h:22-136) keeps a camera-to-world transform
and the look-around angles. Ray generation runs in the raygen stage of
the fused pipeline (fused/pt_fused.py and its kernel in csrc/shade.cu) or,
for the wavefront integrator, in `pixel_uv` and `sample_ray_thinlens`
below (fredholm_tpu/camera.py:146-194, stacked [N, 3] layout).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .core.vecmath import normalize, transform_direction, transform_position, vec3
from .sampling.mappings import sample_concentric_disk


def _look_at(origin: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Inverse of glm::lookAt — a camera-to-world 4x4 (camera.h:66-67)."""
    f = target - origin
    f = f / max(np.linalg.norm(f), 1e-12)
    r = np.cross(f, up)
    r = r / max(np.linalg.norm(r), 1e-12)
    u = np.cross(r, f)
    m = np.eye(4, dtype=np.float32)
    # camera-to-world columns: right, up, backward (OpenGL convention)
    m[:3, 0] = r
    m[:3, 1] = u
    m[:3, 2] = -f
    m[:3, 3] = origin
    return m


@dataclasses.dataclass
class Camera:
    """Camera-to-world transform plus thin-lens parameters."""

    origin: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    fov: float = 0.5 * math.pi
    f_number: float = 100.0
    focus: float = 10000.0
    look_around_speed: float = 0.1
    phi: float = 270.0
    theta: float = 90.0

    def __post_init__(self):
        self.origin = np.asarray(self.origin, np.float32)
        self.forward = np.asarray([0.0, 0.0, -1.0], np.float32)
        self.right = np.cross(self.forward, [0.0, 1.0, 0.0]).astype(np.float32)
        self.right /= max(np.linalg.norm(self.right), 1e-12)
        self.up = np.cross(self.right, self.forward).astype(np.float32)
        self.up /= max(np.linalg.norm(self.up), 1e-12)
        self._update_transform()

    def _update_transform(self):
        self.transform = _look_at(
            self.origin, self.origin + 0.01 * self.forward, self.up
        )

    def set_transform(self, m: np.ndarray):
        """Directly set a camera-to-world 4x4."""
        self.transform = np.asarray(m, np.float32)
        self.origin = self.transform[:3, 3].copy()

    def look_around(self, d_phi: float, d_theta: float):
        """Turn by mouse deltas scaled by look_around_speed, in degrees
        (camera.h:112-136)."""
        self.phi += self.look_around_speed * d_phi
        if self.phi < 0.0:
            self.phi = 360.0
        if self.phi > 360.0:
            self.phi = 0.0
        self.theta += self.look_around_speed * d_theta
        if self.theta < 0.0:
            self.theta = 180.0
        if self.theta > 180.0:
            self.theta = 0.0
        pr = math.radians(self.phi)
        tr = math.radians(self.theta)
        self.forward = np.asarray(
            [math.cos(pr) * math.sin(tr), math.cos(tr), math.sin(pr) * math.sin(tr)],
            np.float32,
        )
        self.right = np.cross(self.forward, [0.0, 1.0, 0.0]).astype(np.float32)
        self.right /= max(np.linalg.norm(self.right), 1e-12)
        self.up = np.cross(self.right, self.forward).astype(np.float32)
        self.up /= max(np.linalg.norm(self.up), 1e-12)
        self._update_transform()

    def device_params(self, device) -> dict:
        """CameraParams (shared.h:59-64) as float32 tensors on `device`."""
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return {
            "transform": f32(self.transform[:3, :]),  # [3, 4] rows
            "fov": f32(self.fov),
            "F": f32(self.f_number),
            "focus": f32(self.focus),
        }


# ---------------------------------------------------------------------------
# ray generation (wavefront integrator)


def pixel_uv(px, py, jitter, width: int, height: int):
    """Film-plane uv from pixel indices + subpixel jitter [N, 2]
    (pt.cu:438-442): uv in [-aspect, aspect] x [-1, 1], x flipped."""
    u = (2.0 * (px.to(torch.float32) + jitter[..., 0]) - width) / height
    v = (2.0 * (py.to(torch.float32) + jitter[..., 1]) - height) / height
    return torch.stack([-u, v], dim=-1)


def sample_ray_thinlens(params, uv, u_lens):
    """camera.cu:24-53. params: `Camera.device_params`; uv [N, 2] film
    point; u_lens [N, 2] aperture sample. Returns (origin, direction, pdf)."""
    f = 1.0 / torch.tan(0.5 * params["fov"])
    b = params["focus"]
    a = 1.0 / (1.0 + f - 1.0 / b)
    lens_radius = 2.0 * f / params["F"]

    zeros = torch.zeros_like(uv[..., 0])
    p_sensor = vec3(uv[..., 0], uv[..., 1], zeros)
    p_lens_center = vec3(zeros, zeros, zeros + f)

    p_disk = lens_radius * sample_concentric_disk(u_lens)
    p_lens = p_lens_center + vec3(p_disk[..., 0], p_disk[..., 1], zeros)

    sensor_to_lens_center = normalize(p_lens_center - p_sensor)
    p_object = p_sensor + ((a + b) / sensor_to_lens_center[..., 2])[..., None] \
        * sensor_to_lens_center

    origin = transform_position(params["transform"], p_lens)
    d = normalize(p_object - p_lens)
    d = d * torch.tensor([1.0, 1.0, -1.0], dtype=d.dtype, device=d.device)
    direction = transform_direction(params["transform"], d)
    pdf = 1.0 / (d[..., 2] * d[..., 2])
    return origin, direction, pdf
