"""Procedural test scenes (slice 1: the Cornell box).

Port of fredholm_tpu/scene/procedural.py `cornell_box` and its helpers,
byte-identical host arrays (tests/test_torch_render.py checks).
"""

from __future__ import annotations

import numpy as np

from .types import Material, Scene


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
