"""Scene and material data model (host numpy).

Port of fredholm_tpu/scene/types.py: Material (shared.h:100-142 defaults),
its dict-of-arrays packing, and the host Scene container (scene.h:103-179).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# Material field table: (name, default, is_vec3)
MATERIAL_SCALARS = [
    ("diffuse", 1.0),
    ("diffuse_roughness", 0.0),
    ("specular", 1.0),
    ("specular_roughness", 0.2),
    ("metalness", 0.0),
    ("coat", 0.0),
    ("coat_roughness", 0.1),
    ("transmission", 0.0),
    ("sheen", 0.0),
    ("sheen_roughness", 0.3),
    ("subsurface", 0.0),
    ("thin_walled", 0.0),
    ("emission", 0.0),
    # thin-film interference on the specular lobe (bxdf.cu:434-454; the
    # reference implements fresnel_airy but never passes these — here they
    # are real material inputs)
    ("thin_film_thickness", 0.0),
    ("thin_film_ior", 1.5),
]
MATERIAL_VECTORS = [
    ("base_color", (1.0, 1.0, 1.0)),
    ("specular_color", (1.0, 1.0, 1.0)),
    ("coat_color", (1.0, 1.0, 1.0)),
    ("transmission_color", (1.0, 1.0, 1.0)),
    ("sheen_color", (1.0, 1.0, 1.0)),
    ("subsurface_color", (1.0, 1.0, 1.0)),
    ("emission_color", (0.0, 0.0, 0.0)),
]
MATERIAL_TEXTURES = [
    "base_color_texture_id",
    "specular_color_texture_id",
    "specular_roughness_texture_id",
    "metalness_texture_id",
    "metallic_roughness_texture_id",
    "coat_texture_id",
    "coat_roughness_texture_id",
    "emission_texture_id",
    "heightmap_texture_id",
    "normalmap_texture_id",
    "alpha_texture_id",
]


@dataclasses.dataclass
class Material:
    """One material with Arnold-Standard-Surface-style parameters
    (shared.h:100-142 defaults)."""

    diffuse: float = 1.0
    base_color: tuple = (1.0, 1.0, 1.0)
    base_color_texture_id: int = -1
    diffuse_roughness: float = 0.0

    specular: float = 1.0
    specular_color: tuple = (1.0, 1.0, 1.0)
    specular_color_texture_id: int = -1
    specular_roughness: float = 0.2
    specular_roughness_texture_id: int = -1

    metalness: float = 0.0
    metalness_texture_id: int = -1
    metallic_roughness_texture_id: int = -1

    coat: float = 0.0
    coat_texture_id: int = -1
    coat_color: tuple = (1.0, 1.0, 1.0)
    coat_roughness: float = 0.1
    coat_roughness_texture_id: int = -1

    transmission: float = 0.0
    transmission_color: tuple = (1.0, 1.0, 1.0)

    sheen: float = 0.0
    sheen_color: tuple = (1.0, 1.0, 1.0)
    sheen_roughness: float = 0.3

    subsurface: float = 0.0
    subsurface_color: tuple = (1.0, 1.0, 1.0)

    thin_walled: float = 0.0

    # thin-film interference layer on the specular lobe; thickness in nm,
    # 0 disables (bxdf.cu:434-454 latent path, wired for real here)
    thin_film_thickness: float = 0.0
    thin_film_ior: float = 1.5

    emission: float = 0.0
    emission_color: tuple = (0.0, 0.0, 0.0)
    emission_texture_id: int = -1

    heightmap_texture_id: int = -1
    normalmap_texture_id: int = -1
    alpha_texture_id: int = -1

    def has_emission(self) -> bool:
        # pt.cu:125-129
        return (
            self.emission_color[0] > 0
            or self.emission_color[1] > 0
            or self.emission_color[2] > 0
            or self.emission_texture_id != -1
        )


def materials_to_soa(materials: List[Material]) -> Dict[str, np.ndarray]:
    """Pack a material list into dict-of-arrays (at least one entry)."""
    mats = materials if materials else [Material()]
    soa: Dict[str, np.ndarray] = {}
    for name, _default in MATERIAL_SCALARS:
        soa[name] = np.asarray(
            [getattr(m, name) for m in mats], dtype=np.float32
        )
    for name, _default in MATERIAL_VECTORS:
        soa[name] = np.asarray(
            [getattr(m, name) for m in mats], dtype=np.float32
        )
    for name in MATERIAL_TEXTURES:
        soa[name] = np.asarray(
            [getattr(m, name) for m in mats], dtype=np.int32
        )
    return soa


@dataclasses.dataclass
class TextureImage:
    """Host texture with color-space tag (scene.h:59-77)."""

    data: np.ndarray  # [H, W, 4] uint8
    is_srgb: bool = True


@dataclasses.dataclass
class DirectionalLight:
    le: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, 1.0, 0.0)  # pointing TOWARD the light
    angle: float = 0.0  # angular diameter in degrees (shared.h:155-159)


@dataclasses.dataclass
class Scene:
    """Host-side scene container (scene.h:103-179 analog).

    Vertex data is shared across submeshes; faces carry per-face material and
    instance ids. Instances reference per-instance 4x4 transforms.
    """

    vertices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.float32)
    )
    indices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.int32)
    )
    normals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.float32)
    )
    texcoords: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.float32)
    )
    material_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32)
    )
    instance_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32)
    )
    materials: List[Material] = dataclasses.field(default_factory=list)
    textures: List[TextureImage] = dataclasses.field(default_factory=list)

    # per-instance object-to-world 4x4
    transforms: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)[None]
    )

    # submesh bookkeeping (scene.h:121-125)
    submesh_offsets: List[int] = dataclasses.field(default_factory=list)
    submesh_n_faces: List[int] = dataclasses.field(default_factory=list)

    # optional camera transform from glTF (scene.h:104-106)
    has_camera_transform: bool = False
    camera_transform: Optional[np.ndarray] = None

    # animation channels, filled by the glTF loader
    nodes: list = dataclasses.field(default_factory=list)
    animations: list = dataclasses.field(default_factory=list)

    def is_valid(self) -> bool:
        return len(self.vertices) > 0 and len(self.indices) > 0

    def n_faces(self) -> int:
        return int(self.indices.shape[0])

    def emissive_faces(self) -> np.ndarray:
        """Faces whose material emits: the area-light list
        (renderer.h:388-402)."""
        if not self.materials:
            return np.zeros((0,), np.int64)
        emissive_mat = np.asarray(
            [m.has_emission() for m in self.materials], dtype=bool
        )
        ids = np.clip(self.material_ids, 0, len(self.materials) - 1)
        return np.nonzero(emissive_mat[ids])[0]


@dataclasses.dataclass
class MeshInstance:
    """One placement of a base-scene submesh (OptixInstance analog,
    renderer.h:498-552): `submesh` indexes Scene.submesh_offsets,
    `transform` is the object-to-world 4x4."""

    submesh: int
    transform: np.ndarray


@dataclasses.dataclass
class InstancedScene:
    """Two-level scene: unique object-space geometry in `base`, placed by
    `instances` (the IAS analog, renderer.h:434-552).

    Device memory is O(unique geometry): each referenced submesh becomes
    ONE BLAS shared by all its instances; rays are transformed into object
    space per instance at trace time, and hit attributes are transformed
    back to world space at shade time. Contrast with baking a Scene's
    per-face instance_ids, which flattens every copy into world-space
    faces.
    """

    base: Scene
    instances: List[MeshInstance] = dataclasses.field(default_factory=list)

    def is_valid(self) -> bool:
        return (
            self.base.is_valid()
            and len(self.instances) > 0
            and all(
                0 <= i.submesh < len(self.base.submesh_offsets)
                for i in self.instances
            )
        )

    @property
    def materials(self):
        return self.base.materials

    @property
    def textures(self):
        return self.base.textures

    @property
    def has_camera_transform(self):
        return self.base.has_camera_transform

    @property
    def camera_transform(self):
        return self.base.camera_transform
