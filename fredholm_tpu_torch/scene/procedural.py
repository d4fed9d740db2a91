"""Procedural test and benchmark scenes.

Port of fredholm_tpu/scene/procedural.py (`cornell_box`, `uv_sphere`,
`sphere_array_test`, `furnace_sphere`, `sphere_grid_test`, `terrain` and
their helpers) with byte-identical host arrays (tests/test_torch_render.py,
test_torch_clustered.py and test_torch_lobes.py check), plus
`hosek_sweep_scene`, a copy of the scene bench.py metric 2 renders
(`bench.py:60-104` `_sweep_scene`), and the texture test scenes
(`checker_texture`, `texture_test`, `normalmap_test`,
`emission_texture_test`; procedural.py:391-511, byte-identical,
tests/test_torch_textures.py checks).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .types import Material, Scene, TextureImage


def _merge_mesh(
    scenes_vertices, scenes_normals, scenes_texcoords, scenes_indices,
    scenes_mids,
):
    v_off = 0
    verts, norms, uvs, idxs, mids = [], [], [], [], []
    for v, n, t, i, m in zip(
        scenes_vertices, scenes_normals, scenes_texcoords, scenes_indices,
        scenes_mids,
    ):
        verts.append(v)
        norms.append(n)
        uvs.append(t)
        idxs.append(i + v_off)
        mids.append(m)
        v_off += len(v)
    return (
        np.concatenate(verts).astype(np.float32),
        np.concatenate(norms).astype(np.float32),
        np.concatenate(uvs).astype(np.float32),
        np.concatenate(idxs).astype(np.int32),
        np.concatenate(mids).astype(np.int32),
    )


def _quad(p0, p1, p2, p3):
    """Two triangles for a quad with a consistent normal; returns
    (verts[4,3], normals[4,3], uvs[4,2], faces[2,3])."""
    p0, p1, p2, p3 = [np.asarray(p, np.float32) for p in (p0, p1, p2, p3)]
    n = np.cross(p1 - p0, p3 - p0)
    n = n / max(np.linalg.norm(n), 1e-12)
    verts = np.stack([p0, p1, p2, p3])
    normals = np.tile(n, (4, 1))
    uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, normals, uvs, faces


def uv_sphere(center, radius, n_theta=16, n_phi=32):
    """UV sphere mesh; returns (verts, normals, uvs, faces)."""
    center = np.asarray(center, np.float32)
    thetas = np.linspace(0.0, np.pi, n_theta + 1)
    phis = np.linspace(0.0, 2.0 * np.pi, n_phi + 1)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    normals = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    verts = center + radius * normals
    uvs = np.stack([pp / (2 * np.pi), tt / np.pi], -1).reshape(-1, 2)

    faces = []
    w = n_phi + 1
    for i in range(n_theta):
        for j in range(n_phi):
            a, b = i * w + j, i * w + j + 1
            c, d = (i + 1) * w + j, (i + 1) * w + j + 1
            if i > 0:
                faces.append([a, b, c])
            if i < n_theta - 1:
                faces.append([b, d, c])
    return (
        verts.astype(np.float32),
        normals,
        uvs.astype(np.float32),
        np.asarray(faces, np.int32),
    )


def _scene(parts, materials, textures=()) -> Scene:
    """One identity-transform Scene from (verts, normals, uvs, faces,
    material ids) parts."""
    verts, norms, uvs, idxs, mids = _merge_mesh(*(list(c) for c in zip(*parts)))
    n_faces = len(idxs)
    return Scene(
        vertices=verts,
        normals=norms,
        texcoords=uvs,
        indices=idxs,
        material_ids=mids,
        instance_ids=np.zeros((n_faces,), np.int32),
        materials=materials,
        textures=list(textures),
        transforms=np.eye(4, dtype=np.float32)[None],
        submesh_offsets=[0],
        submesh_n_faces=[n_faces],
    )


def sphere_array_test(
    param_name: str,
    values,
    base: Optional[Material] = None,
    radius: float = 0.45,
    spacing: float = 1.1,
    with_floor: bool = True,
) -> Scene:
    """Material-test scene: a row of spheres sweeping one material
    parameter (procedural.py:169-219)."""
    base = base or Material()
    materials: List[Material] = []
    parts = []
    n = len(values)
    for i, val in enumerate(values):
        m = dataclasses.replace(base)
        setattr(m, param_name, val)
        materials.append(m)
        cx = (i - (n - 1) / 2.0) * spacing
        v, nn, t, f = uv_sphere([cx, radius, 0.0], radius)
        parts.append((v, nn, t, f, np.full((len(f),), i, np.int32)))
    if with_floor:
        materials.append(Material(base_color=(0.5, 0.5, 0.5), specular=0.0))
        s = n * spacing
        v, nn, t, f = _quad([-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s])
        parts.append((v, nn, t, f, np.full((len(f),), n, np.int32)))
    return _scene(parts, materials)


def furnace_sphere(material: Material) -> Scene:
    """White-furnace scene (procedural.py:222-239): one unit sphere of
    32 x 64 segments and no floor, lit only by a constant sky; a lossless
    material vanishes against the background."""
    v, nn, t, f = uv_sphere([0.0, 0.0, 0.0], 1.0, n_theta=32, n_phi=64)
    return _scene([(v, nn, t, f, np.zeros((len(f),), np.int32))], [material])


def sphere_grid_test(
    param_x: str,
    values_x,
    param_y: str,
    values_y,
    base: Optional[Material] = None,
    radius: float = 0.4,
    spacing: float = 1.0,
) -> Scene:
    """2D material sweep (procedural.py:306-348): a grid of spheres, param_x
    along the columns and param_y along the rows, no floor."""
    base = base or Material()
    materials: List[Material] = []
    parts = []
    nx = len(values_x)
    for j, vy in enumerate(values_y):
        for i, vx in enumerate(values_x):
            m = dataclasses.replace(base)
            setattr(m, param_x, vx)
            setattr(m, param_y, vy)
            materials.append(m)
            cx = (i - (nx - 1) / 2.0) * spacing
            cy = radius + j * spacing
            v, nn, t, f = uv_sphere([cx, cy, 0.0], radius)
            parts.append((v, nn, t, f, np.full((len(f),), j * nx + i, np.int32)))
    return _scene(parts, materials)


def terrain(n: int = 724, size: float = 20.0, amp: float = 1.8,
            material: Optional[Material] = None) -> Scene:
    """Displaced terrain of 2 n^2 triangles (procedural.py:242-304):
    deterministic sum-of-sines heights with analytic normals."""
    xs = np.linspace(-size / 2, size / 2, n + 1, dtype=np.float32)
    zs = np.linspace(-size / 2, size / 2, n + 1, dtype=np.float32)
    x, z = np.meshgrid(xs, zs, indexing="ij")
    y = amp * (
        np.sin(0.7 * x) * np.cos(0.5 * z)
        + 0.45 * np.sin(2.3 * x + 1.0) * np.sin(1.9 * z + 0.5)
        + 0.18 * np.cos(6.1 * x + 2.0) * np.cos(5.7 * z + 1.2)
    ).astype(np.float32)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    dy_dx = amp * (
        0.7 * np.cos(0.7 * x) * np.cos(0.5 * z)
        + 0.45 * 2.3 * np.cos(2.3 * x + 1.0) * np.sin(1.9 * z + 0.5)
        - 0.18 * 6.1 * np.sin(6.1 * x + 2.0) * np.cos(5.7 * z + 1.2)
    )
    dy_dz = amp * (
        -0.5 * np.sin(0.7 * x) * np.sin(0.5 * z)
        + 0.45 * 1.9 * np.sin(2.3 * x + 1.0) * np.cos(1.9 * z + 0.5)
        - 0.18 * 5.7 * np.cos(6.1 * x + 2.0) * np.sin(5.7 * z + 1.2)
    )
    norms = np.stack([-dy_dx, np.ones_like(y), -dy_dz], axis=-1).reshape(-1, 3)
    norms = (norms / np.linalg.norm(norms, axis=-1, keepdims=True)).astype(np.float32)
    uvs = np.stack(
        [(x + size / 2) / size, (z + size / 2) / size], axis=-1
    ).reshape(-1, 2).astype(np.float32)
    # two triangles per grid cell
    i0 = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]).ravel()
    a, b, c, d = i0, i0 + 1, i0 + n + 1, i0 + n + 2
    idxs = np.concatenate([np.stack([a, b, d], -1), np.stack([a, d, c], -1)]).astype(np.int32)
    n_faces = len(idxs)
    mat = material or Material(base_color=(0.55, 0.5, 0.42), specular=0.25,
                               specular_roughness=0.5)
    return Scene(
        vertices=verts,
        normals=norms,
        texcoords=uvs,
        indices=idxs,
        material_ids=np.zeros((n_faces,), np.int32),
        instance_ids=np.zeros((n_faces,), np.int32),
        materials=[mat],
        transforms=np.eye(4, dtype=np.float32)[None],
        submesh_offsets=[0],
        submesh_n_faces=[n_faces],
    )


def hosek_sweep_scene() -> Scene:
    """The metalness sweep bench.py metric 2 renders under a Hosek sky
    (bench.py:60-104): 12 spheres of 64 x 64 segments with metalness
    0..1 over a floor, 96,770 triangles."""
    base = Material(base_color=(0.9, 0.6, 0.3), specular_roughness=0.25)
    values = list(np.linspace(0.0, 1.0, 12))
    materials = []
    parts = []
    n = len(values)
    spacing = 1.1
    for i, val in enumerate(values):
        m = dataclasses.replace(base)
        m.metalness = val
        materials.append(m)
        cx = (i - (n - 1) / 2.0) * spacing
        v, nn, t, f = uv_sphere([cx, 0.45, 0.0], 0.45, n_theta=64, n_phi=64)
        parts.append((v, nn, t, f, np.full((len(f),), i, np.int32)))
    materials.append(Material(base_color=(0.5, 0.5, 0.5), specular=0.0))
    s = n * spacing
    v, nn, t, f = _quad([-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s])
    parts.append((v, nn, t, f, np.full((len(f),), n, np.int32)))
    return _scene(parts, materials)


def cornell_box(light_le=(10.0, 10.0, 10.0)) -> Scene:
    """Classic Cornell box in [0,1]^3-ish coordinates, matching the standard
    CornellBox-Original layout the reference's scene list uses
    (controller.h:31)."""
    white = Material(base_color=(0.8, 0.8, 0.8), specular=0.0)
    red = Material(base_color=(0.8, 0.05, 0.05), specular=0.0)
    green = Material(base_color=(0.05, 0.8, 0.05), specular=0.0)
    light = Material(
        base_color=(0.8, 0.8, 0.8),
        specular=0.0,
        emission=1.0,
        emission_color=tuple(light_le),
    )
    materials = [white, red, green, light]

    parts = []  # (verts, normals, uvs, faces, material_id)

    def add_quad(p0, p1, p2, p3, mid):
        v, n, t, f = _quad(p0, p1, p2, p3)
        parts.append((v, n, t, f, np.full((len(f),), mid, np.int32)))

    s = 1.0
    # floor (y=0, normal +y)
    add_quad([-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s], 0)
    # ceiling (y=2, normal -y)
    add_quad([-s, 2, -s], [s, 2, -s], [s, 2, s], [-s, 2, s], 0)
    # back wall (z=-1, normal +z)
    add_quad([-s, 0, -s], [s, 0, -s], [s, 2, -s], [-s, 2, -s], 0)
    # left wall (x=-1, red, normal +x)
    add_quad([-s, 0, s], [-s, 0, -s], [-s, 2, -s], [-s, 2, s], 1)
    # right wall (x=1, green, normal -x)
    add_quad([s, 0, -s], [s, 0, s], [s, 2, s], [s, 2, -s], 2)
    # area light near ceiling (normal -y)
    l = 0.4
    add_quad([-l, 1.98, -l], [l, 1.98, -l], [l, 1.98, l], [-l, 1.98, l], 3)

    # two boxes
    def add_box(center, size, ry, mid):
        cx, cy, cz = center
        sx, sy, sz = size
        c, sn = np.cos(ry), np.sin(ry)

        def rot(p):
            x, y, z = p
            return [cx + c * x + sn * z, cy + y, cz - sn * x + c * z]

        x0, x1 = -sx / 2, sx / 2
        y0, y1 = 0.0, sy
        z0, z1 = -sz / 2, sz / 2
        add_quad(rot([x0, y1, z0]), rot([x0, y1, z1]), rot([x1, y1, z1]), rot([x1, y1, z0]), mid)
        add_quad(rot([x0, y0, z1]), rot([x0, y0, z0]), rot([x1, y0, z0]), rot([x1, y0, z1]), mid)
        add_quad(rot([x0, y0, z1]), rot([x1, y0, z1]), rot([x1, y1, z1]), rot([x0, y1, z1]), mid)
        add_quad(rot([x1, y0, z0]), rot([x0, y0, z0]), rot([x0, y1, z0]), rot([x1, y1, z0]), mid)
        add_quad(rot([x1, y0, z1]), rot([x1, y0, z0]), rot([x1, y1, z0]), rot([x1, y1, z1]), mid)
        add_quad(rot([x0, y0, z0]), rot([x0, y0, z1]), rot([x0, y1, z1]), rot([x0, y1, z0]), mid)

    add_box([-0.35, 0.0, -0.35], [0.6, 1.2, 0.6], np.deg2rad(20), 0)
    add_box([0.4, 0.0, 0.35], [0.6, 0.6, 0.6], np.deg2rad(-17), 0)

    verts, norms, uvs, idxs, mids = _merge_mesh(
        [p[0] for p in parts],
        [p[1] for p in parts],
        [p[2] for p in parts],
        [p[3] for p in parts],
        [p[4] for p in parts],
    )
    n_faces = len(idxs)
    return Scene(
        vertices=verts,
        normals=norms,
        texcoords=uvs,
        indices=idxs,
        material_ids=mids,
        instance_ids=np.zeros((n_faces,), np.int32),
        materials=materials,
        transforms=np.eye(4, dtype=np.float32)[None],
        submesh_offsets=[0],
        submesh_n_faces=[n_faces],
    )


# -- texture-driven test scenes (controller.h:61-66 analogs) ----------------


def checker_texture(res: int = 64, n: int = 8, c0=(240, 240, 240), c1=(30, 30, 160),
                    is_srgb: bool = True) -> TextureImage:
    """Procedural checkerboard TextureImage (procedural.py:394-407)."""
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    mask = ((xx * n // res) + (yy * n // res)) % 2 == 0
    img = np.empty((res, res, 4), np.uint8)
    img[..., :3] = np.where(mask[..., None], np.uint8(1), np.uint8(0)) * (
        np.asarray(c0, np.uint8) - np.asarray(c1, np.uint8)
    ) + np.asarray(c1, np.uint8)
    img[..., 3] = 255
    return TextureImage(data=img, is_srgb=is_srgb)


def _floor_sphere_scene(materials: List[Material], textures, sphere_material_id: int = 0,
                        floor_material_id: int = 1) -> Scene:
    """One sphere on a UV-mapped floor (procedural.py:410-433)."""
    parts = []
    v, nn, t, f = uv_sphere([0.0, 0.55, 0.0], 0.55, n_theta=24, n_phi=48)
    parts.append((v, nn, t, f, np.full((len(f),), sphere_material_id, np.int32)))
    s = 3.0
    v, nn, t, f = _quad([-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s])
    parts.append((v, nn, t, f, np.full((len(f),), floor_material_id, np.int32)))
    return _scene(parts, materials, textures)


def texture_test() -> Scene:
    """Base-color-texture scene (procedural.py:436-444): checkered sphere
    and floor."""
    tex = checker_texture()
    return _floor_sphere_scene(
        [Material(base_color_texture_id=0, specular=0.3),
         Material(base_color_texture_id=0, specular=0.0)],
        [tex],
    )


def normalmap_test() -> Scene:
    """Normal-map scene (procedural.py:447-473): a sine-wave tangent-space
    normal map on the sphere."""
    res = 64
    yy, xx = np.meshgrid(
        np.linspace(0, 1, res, endpoint=False),
        np.linspace(0, 1, res, endpoint=False), indexing="ij",
    )
    nx = 0.55 * np.sin(2 * np.pi * 6 * xx)
    ny = 0.55 * np.sin(2 * np.pi * 6 * yy)
    nz = np.sqrt(np.clip(1.0 - nx * nx - ny * ny, 0.0, 1.0))
    img = np.empty((res, res, 4), np.uint8)
    img[..., 0] = np.uint8(np.clip((nx * 0.5 + 0.5) * 255, 0, 255))
    img[..., 1] = np.uint8(np.clip((ny * 0.5 + 0.5) * 255, 0, 255))
    img[..., 2] = np.uint8(np.clip((nz * 0.5 + 0.5) * 255, 0, 255))
    img[..., 3] = 255
    nm = TextureImage(data=img, is_srgb=False)
    return _floor_sphere_scene(
        [Material(specular=0.6, specular_roughness=0.15, normalmap_texture_id=0),
         Material(specular=0.0, base_color=(0.6, 0.6, 0.6))],
        [nm],
    )


def emission_texture_test() -> Scene:
    """Emission-texture scene (procedural.py:476-511): an emissive checker
    panel lighting a diffuse sphere in a black environment."""
    tex = checker_texture(c0=(255, 255, 255), c1=(0, 0, 0), is_srgb=False)
    parts = []
    v, nn, t, f = uv_sphere([0.0, 0.55, 0.0], 0.55, n_theta=24, n_phi=48)
    parts.append((v, nn, t, f, np.zeros((len(f),), np.int32)))
    s = 2.0
    v, nn, t, f = _quad([-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s])
    parts.append((v, nn, t, f, np.ones((len(f),), np.int32)))
    # emissive panel hanging above, facing down
    v, nn, t, f = _quad([-1, 2.2, 1], [-1, 2.2, -1], [1, 2.2, -1], [1, 2.2, 1])
    parts.append((v, nn, t, f, np.full((len(f),), 2, np.int32)))
    return _scene(parts, [
        Material(specular=0.2, base_color=(0.8, 0.8, 0.8)),
        Material(specular=0.0, base_color=(0.5, 0.5, 0.5)),
        Material(diffuse=0.0, specular=0.0, emission=6.0,
                 emission_color=(1.0, 0.9, 0.7), emission_texture_id=0),
    ], [tex])
