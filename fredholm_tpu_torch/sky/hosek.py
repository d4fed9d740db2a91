"""Hosek-Wilkie analytic sky: the host "cook" (numpy).

Port of fredholm_tpu/sky/hosek.py (arhosek.h:144-322): from (turbidity,
albedo, solar elevation) a 9-coefficient configuration and a radiance
scale per RGB channel, by quintic bezier interpolation over elevation and
linear blending over albedo and turbidity. The coefficient dataset is the
reference's assets/hosek_rgb.npz, read by path. The radiance is evaluated
per direction by `sky_radiance` (the wavefront integrator, stacked
layout) or in the fused shading stage (fused/pt_fused.eval_sky_c and its
kernel in csrc/common.cuh).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from ..assets import asset_path


@functools.lru_cache(maxsize=1)
def _tables():
    data = np.load(asset_path("hosek_rgb.npz"))
    return (data["config"].reshape(3, 2, 10, 6, 9),
            data["radiance"].reshape(3, 2, 10, 6))


def _bezier_weights(solar_elevation: float) -> np.ndarray:
    """Quintic bezier weights over the 6 elevation control points
    (arhosek.h:151-165); elevation is warped by the cube root."""
    t = (solar_elevation / (np.pi / 2.0)) ** (1.0 / 3.0)
    s = 1.0 - t
    return np.asarray(
        [s**5, 5.0 * s**4 * t, 10.0 * s**3 * t**2, 10.0 * s**2 * t**3,
         5.0 * s * t**4, t**5],
        dtype=np.float64,
    )


def cook_state(turbidity: float, albedo: float, solar_elevation: float) -> Dict:
    """ArHosekSkyModelState analog (arhosek.h:131-140, :305-322).

    Returns {"configs": [3, 9] float32, "radiances": [3] float32}."""
    cfg_table, rad_table = _tables()
    turbidity = float(np.clip(turbidity, 1.0, 10.0))
    albedo = float(np.clip(albedo, 0.0, 1.0))
    elevation = float(np.clip(solar_elevation, 0.0, np.pi / 2.0))

    int_t = int(turbidity)
    rem = turbidity - int_t
    w = _bezier_weights(elevation)
    ti0 = int_t - 1
    configs = np.zeros((3, 9), np.float64)
    radiances = np.zeros((3,), np.float64)
    for a, wa in ((0, 1.0 - albedo), (1, albedo)):
        # low-turbidity control row
        configs += wa * (1.0 - rem) * np.einsum("e,ceo->co", w, cfg_table[:, a, ti0])
        radiances += wa * (1.0 - rem) * (rad_table[:, a, ti0] @ w)
        if int_t < 10:
            configs += wa * rem * np.einsum("e,ceo->co", w, cfg_table[:, a, ti0 + 1])
            radiances += wa * rem * (rad_table[:, a, ti0 + 1] @ w)
    return {"configs": configs.astype(np.float32), "radiances": radiances.astype(np.float32)}


def sky_radiance(state: Dict, theta, gamma):
    """Radiance [N, 3] for view zenith angles theta [N] and angles to the
    sun gamma [N] (arhosek.cu:103-127; sky/hosek.py:98-122). state holds
    `configs` [3, 9] and `radiances` [3] as tensors on the device. Theta is
    clamped at the horizon, where the reference clamps it."""
    c = state["configs"]
    theta = torch.clamp(theta, max=0.5 * np.pi - 1e-3)
    cos_g = torch.cos(gamma)[..., None]
    cos_t = torch.cos(theta)[..., None]
    exp_m = torch.exp(c[:, 4] * gamma[..., None])
    ray_m = cos_g * cos_g
    mie_m = (1.0 + cos_g * cos_g) / torch.pow(
        torch.clamp(1.0 + c[:, 8] * c[:, 8] - 2.0 * c[:, 8] * cos_g, min=1e-8), 1.5)
    zenith = torch.sqrt(torch.clamp(cos_t, min=0.0))
    radiance = (1.0 + c[:, 0] * torch.exp(c[:, 1] / (cos_t + 0.01))) * (
        c[:, 2] + c[:, 3] * exp_m + c[:, 5] * ray_m + c[:, 6] * mie_m + c[:, 7] * zenith)
    return torch.clamp(radiance * state["radiances"], min=0.0)


def sun_elevation_from_direction(sun_dir: np.ndarray) -> float:
    """renderer.h:596-607: elevation = pi/2 - zenith angle of the sun dir."""
    y = float(np.clip(sun_dir[1], -1.0, 1.0))
    return 0.5 * np.pi - np.arccos(y)
