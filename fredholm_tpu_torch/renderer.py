"""Host-side render orchestration (port of fredholm_tpu/renderer.py, the
API the ported slices need).

Owns the device scene, the camera, the sky (constant or Hosek-Wilkie),
the directional light, the per-pixel sample counts and the six AOV
layers, and drives the progressive integrator on `device`: the CUDA card
unless the caller asks for the CPU. On a CUDA device every kernel stage
runs a hand-written kernel; on the CPU the same stages run their plain
PyTorch twins. Scenes of at most 1024 faces trace densely; larger ones
through the cluster hierarchy (up to 4096 superclusters, as the
reference), as do instanced scenes (InstancedScene: one shared BLAS per
submesh, placements moved by `set_instance_transforms`) of any size.

Two integrators, routed as the reference's `_config` routes them
(renderer.py:523-531): the fused pipeline (fused/pt_fused.py) by default,
the wavefront integrator (integrator/pt.py `render_sample`) where
`use_fused` is False, `sampler_mode` is "bluenoise", a material has a
thin film, or the scene has more than 16 area lights. Textured scenes
render through the fused pipeline only: routed to the wavefront, they
raise NotImplementedError, as do instanced scenes and scenes with alpha
cutout.

Left out on purpose (TPU scheduling devices that only re-order work):
row bands, spp chunking, pixel swizzle and the (w*h) % 128 gate.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .camera import Camera
from .experimental import compact
from .fused.pt_fused import MAX_KERNEL_LIGHTS, SKY_CONSTANT, SKY_HOSEK
from .integrator.pt import make_layers, render_progressive
from .sampling.sampler import MODE_DEFAULT
from .scene.device import (build_device_scene, build_instanced_device_scene,
                           update_instance_transforms)
from .scene.types import InstancedScene, Scene
from .sky import hosek as hosek_mod


def _scene_lobes(scene: Scene) -> tuple:
    """BSDF lobes any material can activate (renderer.py:166-197)."""
    mats = scene.materials or []
    lobes = []
    if any(m.coat > 0 or m.coat_texture_id >= 0 for m in mats):
        lobes.append("coat")
    if any(m.metalness > 0 or m.metalness_texture_id >= 0
           or m.metallic_roughness_texture_id >= 0 for m in mats):
        lobes.append("metal")
    if any(m.specular > 0 and max(m.specular_color) > 0 for m in mats):
        lobes.append("specular")
    if any(m.transmission > 0 for m in mats):
        lobes.append("transmission")
    if any(m.sheen > 0 for m in mats):
        lobes.append("sheen")
    if any(m.subsurface > 0 and m.thin_walled > 0 for m in mats):
        lobes.append("diffuse_t")
    if any(m.diffuse > 0 for m in mats):
        lobes.append("diffuse_r")
    if any(getattr(m, "thin_film_thickness", 0.0) > 0 for m in mats):
        lobes.append("thin_film")
    return tuple(lobes)


def _scene_has_alpha(scene: Scene) -> bool:
    """True when a material can cut out through an alpha texture or a
    base-color texture with alpha < 128 (renderer.py:137-149)."""
    mats = scene.materials or []
    if any(m.alpha_texture_id >= 0 for m in mats):
        return True
    for m in mats:
        tid = m.base_color_texture_id
        if 0 <= tid < len(scene.textures):
            data = scene.textures[tid].data
            if data.shape[-1] == 4 and (data[..., 3] < 128).any():
                return True
    return False


def _check_envelope(scene: Scene) -> None:
    """Raise NotImplementedError naming what the port does not have yet."""
    if _scene_has_alpha(scene):
        raise NotImplementedError(
            "alpha cutout (an alpha texture, or a base-color texture with alpha < 128) is "
            "not ported yet: it changes the trace (pt.py:159-208)")


class Renderer:
    """Progressive path tracer with six AOV layers on one device."""

    def __init__(self, width: int = 512, height: int = 512, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Renderer(device='cuda') needs a CUDA device; pass "
                "device='cpu' to run the plain PyTorch twins")
        if self.device.type not in ("cpu", "cuda"):
            raise NotImplementedError(f"no port for device {self.device}")
        self.width = width
        self.height = height
        self.scene: Optional[Scene] = None
        self._dev: Optional[Dict] = None
        self._lobes: tuple = ()
        self.camera = Camera(origin=np.asarray([0.0, 1.0, 5.0], np.float32))
        self.bg_color = np.zeros(3, np.float32)  # the constant sky
        self.sky_mode = SKY_CONSTANT
        self.sky_intensity = 1.0
        self.hosek_state: Optional[Dict] = None
        self.sun_direction = np.asarray([0.0, 1.0, 0.0], np.float32)
        self.directional_light: Optional[Dict] = None
        self.seed = 42
        # the fused pipeline on its envelope; False forces the wavefront
        # integrator (renderer.py:228-231)
        self.use_fused = True
        # "sobol_cmj" (the reference's draws) or "bluenoise" (screen-space
        # blue-noise dithered Owen-Sobol, wavefront only)
        self.sampler_mode = MODE_DEFAULT
        self.init_render_states()

    # -- scene / sky --------------------------------------------------------

    def set_scene(self, scene: Union[Scene, InstancedScene]):
        """A flattened Scene, or an InstancedScene (renderer.py:288-297),
        which always traces through the cluster hierarchy and takes its
        materials, textures and camera from its base scene."""
        _check_envelope(scene)
        if isinstance(scene, InstancedScene):
            self._dev = build_instanced_device_scene(scene, self.device)
        else:
            self._dev = build_device_scene(scene, self.device)
        self._lobes = _scene_lobes(scene)
        self.scene = scene
        # a loaded scene's camera (renderer.py:314-318)
        if scene.has_camera_transform and scene.camera_transform is not None:
            self.camera.set_transform(scene.camera_transform)
        self.init_render_states()

    def set_instance_transforms(self, transforms):
        """Move an InstancedScene's placements, one 4x4 each, in order
        (renderer.py:321-330): the TLAS's instance entries, the shading
        transforms and the lights are rebuilt, the geometry stays on the
        device; the accumulation restarts."""
        if self._dev is None or "inst_table" not in self._dev:
            raise RuntimeError("set_instance_transforms needs an InstancedScene")
        self._dev = update_instance_transforms(self._dev, transforms)
        self.scene = self._dev["_host"]["scene"]
        self.init_render_states()

    def set_directional_light(self, le, direction, angle: float = 0.0):
        """A sun of radiance `le` toward `direction`, `angle` degrees wide;
        it also becomes the Hosek sky's sun (renderer.py:376-382)."""
        d = np.asarray(direction, np.float32)
        d = d / max(np.linalg.norm(d), 1e-12)
        self.directional_light = {
            "le": np.asarray(le, np.float32), "dir": d, "angle": np.float32(angle)}
        self.sun_direction = d

    def clear_directional_light(self):
        self.directional_light = None

    def set_sky_intensity(self, intensity: float):
        self.sky_intensity = float(intensity)

    def set_bg_color(self, color):
        self.bg_color = np.asarray(color, np.float32)
        self.sky_mode = SKY_CONSTANT

    def load_arhosek_sky(self, turbidity: float, albedo: float):
        """Couple the Hosek dome to the current sun direction
        (renderer.h:588-607)."""
        elevation = hosek_mod.sun_elevation_from_direction(self.sun_direction)
        self.hosek_state = hosek_mod.cook_state(turbidity, albedo, elevation)
        self.sky_mode = SKY_HOSEK

    def clear_arhosek_sky(self):
        self.hosek_state = None
        if self.sky_mode == SKY_HOSEK:
            self.sky_mode = SKY_CONSTANT

    # -- render state -------------------------------------------------------

    def init_render_states(self):
        """Zero the accumulators (renderer.h:650-655)."""
        n = self.width * self.height
        self.layers = make_layers(n, self.device)
        self.sample_count = torch.zeros((n,), dtype=torch.int64, device=self.device)

    def _use_fused(self) -> bool:
        """The fused pipeline's envelope (renderer.py:523-531, without the
        (w*h) % 128 gate and IBL)."""
        return (self.use_fused and self.sampler_mode == MODE_DEFAULT
                and "thin_film" not in self._lobes
                and self._dev["n_lights"] <= MAX_KERNEL_LIGHTS)

    def _params(self, max_depth: int) -> Dict:
        params = {
            "width": self.width,
            "height": self.height,
            "max_depth": max_depth,
            "lobes_on": self._lobes,
            "camera": self.camera.device_params("cpu"),
            "seed": self.seed,
            "bg_color": self.bg_color,
            "sky_mode": self.sky_mode,
            "sky_intensity": self.sky_intensity,
            "sun_direction": self.sun_direction,
            "use_fused": self._use_fused(),
            "sampler_mode": self.sampler_mode,
            # wavefront compaction around the fused traces (renderer.py:533)
            "compact": compact.mode(),
        }
        if self.sky_mode == SKY_HOSEK:
            params["hosek"] = self.hosek_state
        if self.directional_light is not None:
            params["directional_light"] = self.directional_light
        return params

    def render(self, n_samples: int = 1, max_depth: int = 10) -> Dict:
        """Accumulate n_samples progressive spp; returns the AOV layers
        (Renderer::render, renderer.h:657-734)."""
        if self._dev is None:
            raise RuntimeError("no scene loaded")
        self.layers, self.sample_count = render_progressive(
            self._dev, self._params(max_depth), self.layers,
            self.sample_count, n_samples,
        )
        return self.layers

    # -- output ------------------------------------------------------------

    def get_layer(self, name: str) -> np.ndarray:
        """AOV as a [H, W, C] numpy image (top-down rows)."""
        buf = self.layers[name].detach().cpu().numpy()
        if buf.ndim == 1:
            buf = buf[:, None]
        return buf.reshape(self.height, self.width, -1)
