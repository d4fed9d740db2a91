"""Hosek-Wilkie analytic sky: the host "cook" (numpy).

Port of fredholm_tpu/sky/hosek.py (arhosek.h:144-322): from (turbidity,
albedo, solar elevation) a 9-coefficient configuration and a radiance
scale per RGB channel, by quintic bezier interpolation over elevation and
linear blending over albedo and turbidity. The coefficient dataset is the
reference's assets/hosek_rgb.npz, read by path. The radiance itself is
evaluated per direction in the shading stage (fused/pt_fused.eval_sky_c
and its kernel in csrc/common.cuh).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np

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


def sun_elevation_from_direction(sun_dir: np.ndarray) -> float:
    """renderer.h:596-607: elevation = pi/2 - zenith angle of the sun dir."""
    y = float(np.clip(sun_dir[1], -1.0, 1.0))
    return 0.5 * np.pi - np.arccos(y)
