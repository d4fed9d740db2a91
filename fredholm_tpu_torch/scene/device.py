"""Host scene -> device tensors.

Port of fredholm_tpu/scene/device.py:84-189 (without the skip-link BVH,
textures and instanced scenes) plus the fused table builders of
fredholm_tpu/fused/pt_fused.py:139-234. Tables are assembled in numpy,
byte-identical to the reference's numpy path, then uploaded once:

  fused_table      [F, GEOM_COLS] f32  per-face geometry (+ mat_id)
  fused_mat_table  [M, MAT_COLS]  f32  per-material shading params
  light_table      [max(L,1), 24] f32  emissive faces for NEE
  tri_soa          [9, F]         f32  rows v0xyz, e1xyz, e2xyz
                                       (dense scenes, F <= 1024)
  clusters         dict                the clustered traversal tables
                                       (accel/clustered.py; F > 1024)
  slot_attrs       [32, K*128]    f32  geometry in slot order
                                       (fused/slot_fetch.py; F > 1024)

and, for the wavefront integrator (integrator/pt.py) on every scene, the
reference's per-face and per-light SoA (device.py:143-162):

  face_verts / face_normals [F, 3, 3], face_uvs [F, 3, 2] f32, face_mat
  [F] i32; materials {name: [M] or [M, 3]}; light_verts / light_normals
  [L, 3, 3], light_uvs [L, 3, 2] f32, light_mat [L] i32 (L >= 1)

Clustered scenes are one BLAS under one identity instance. The reference
builds slot_attrs only above 2048 faces (a TPU gather cost); its own
test shows the slot fetch and the row gather bit-identical, so the port
builds it for every clustered scene.

`dev_from_reference` carries the reference package's own dense-scene
tables across, so tests can run both packages on literally the same
inputs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..accel.bvh import build_bvh
from ..accel.cluster import TLAS, build_tlas, extract_hierarchy
from ..accel.clustered import prepare_clustered
from ..accel.dense import MAX_FACES as DENSE_MAX_FACES
from ..fused.slot_fetch import build_slot_attrs
from .types import Scene, materials_to_soa

# the wavefront integrator's tables (module docstring)
_WAVEFRONT_KEYS = (
    "face_verts", "face_normals", "face_uvs", "face_mat", "materials",
    "light_verts", "light_normals", "light_uvs", "light_mat",
)

# ---------------------------------------------------------------------------
# fused face-attribute table column layout (pt_fused.py:93-136)

_GEOM_COL_NAMES: List[Tuple[str, int]] = [
    ("v0", 3), ("v1", 3), ("v2", 3),
    ("n0", 3), ("n1", 3), ("n2", 3),
    ("uv0", 2), ("uv1", 2), ("uv2", 2),
    ("area", 1), ("mat_id", 1),
]
TEX_KINDS = (
    "base_color", "specular_color", "specular_roughness", "metalness",
    "metallic_roughness", "coat", "coat_roughness", "emission",
    "normalmap", "heightmap",
)
_MAT_COL_NAMES: List[Tuple[str, int]] = [
    ("emission_color", 3), ("has_emission", 1),
    ("base_color", 3), ("diffuse", 1), ("diffuse_roughness", 1),
    ("specular", 1), ("specular_color", 3), ("specular_roughness", 1),
    ("metalness", 1), ("coat", 1), ("coat_roughness", 1), ("coat_color", 3),
    ("transmission", 1), ("transmission_color", 3),
    ("sheen", 1), ("sheen_color", 3), ("sheen_roughness", 1),
    ("subsurface", 1), ("subsurface_color", 3), ("thin_walled", 1),
] + [("tx_" + kind, 6) for kind in TEX_KINDS]


def _col_layout():
    col, off = {}, 0
    for name, w in _GEOM_COL_NAMES:
        col[name] = off
        off += w
    used, geom = off, 32
    assert used <= geom
    off = geom
    for name, w in _MAT_COL_NAMES:
        col[name] = off
        off += w
    return col, used, geom, off


COL, GEOM_COLS_USED, GEOM_COLS, N_COLS = _col_layout()
MAT_COLS = N_COLS - GEOM_COLS


def world_face_data(scene: Scene) -> Dict[str, np.ndarray]:
    """Per-face world-space SoA: verts [F,3,3], normals [F,3,3], uvs
    [F,3,2] (device.py:34-54)."""
    v = scene.vertices[scene.indices]
    n = scene.normals[scene.indices]
    uv = scene.texcoords[scene.indices]

    o2w = np.asarray(scene.transforms, np.float32)
    inst = scene.instance_ids
    m = o2w[inst]
    vw = np.einsum("fij,fkj->fki", m[:, :3, :3], v) + m[:, None, :3, 3]
    m_inv = np.linalg.inv(o2w)[inst]
    # normal transform: (M^-1)^T
    nw = np.einsum("fji,fkj->fki", m_inv[:, :3, :3], n)
    norm = np.linalg.norm(nw, axis=-1, keepdims=True)
    nw = nw / np.maximum(norm, 1e-12)
    return {
        "verts": vw.astype(np.float32),
        "normals": nw.astype(np.float32),
        "uvs": uv.astype(np.float32),
    }


def _light_soa(lv, ln, luv, lmat) -> Dict[str, np.ndarray]:
    """World-space emissive-face SoA for NEE sampling; always >= 1 row."""
    n = max(len(lv), 1)
    out = {
        "light_verts": np.zeros((n, 3, 3), np.float32),
        "light_normals": np.zeros((n, 3, 3), np.float32),
        "light_uvs": np.zeros((n, 3, 2), np.float32),
        "light_mat": np.zeros((n,), np.int32),
    }
    if len(lv):
        out["light_verts"][:] = lv
        out["light_normals"][:] = ln
        out["light_uvs"][:] = luv
        out["light_mat"][:] = lmat
    return out


def build_fused_table(np_dev: Dict) -> np.ndarray:
    """[F, GEOM_COLS] float32 per-face geometry table (+ mat_id)."""
    fv = np.asarray(np_dev["face_verts"])
    fn = np.asarray(np_dev["face_normals"])
    fuv = np.asarray(np_dev["face_uvs"])
    mat_ids = np.asarray(np_dev["face_mat"])
    f = fv.shape[0]

    e1 = fv[:, 1] - fv[:, 0]
    e2 = fv[:, 2] - fv[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    out = np.zeros((f, GEOM_COLS), np.float32)

    def put(name, vals):
        vals = np.asarray(vals, np.float32).reshape(f, -1)
        out[:, COL[name]:COL[name] + vals.shape[1]] = vals

    put("v0", fv[:, 0]); put("v1", fv[:, 1]); put("v2", fv[:, 2])
    put("n0", fn[:, 0]); put("n1", fn[:, 1]); put("n2", fn[:, 2])
    put("uv0", fuv[:, 0]); put("uv1", fuv[:, 1]); put("uv2", fuv[:, 2])
    put("area", area)
    put("mat_id", mat_ids)
    return out


def build_fused_mat_table(np_dev: Dict) -> np.ndarray:
    """[M, MAT_COLS] float32 per-material shading params + emission."""
    m = {k: np.asarray(v) for k, v in np_dev["materials"].items()}
    n_m = m["base_color"].shape[0]
    ec = m["emission_color"]
    has_em = (
        (ec > 0.0).any(-1) | (m["emission_texture_id"] >= 0)
    ).astype(np.float32)

    out = np.zeros((n_m, MAT_COLS), np.float32)

    def put(name, vals):
        vals = np.asarray(vals, np.float32).reshape(n_m, -1)
        c = COL[name] - GEOM_COLS
        out[:, c:c + vals.shape[1]] = vals

    put("emission_color", ec)
    put("has_emission", has_em)
    for name in (
        "base_color", "diffuse", "diffuse_roughness", "specular",
        "specular_color", "specular_roughness", "metalness", "coat",
        "coat_roughness", "coat_color", "transmission", "transmission_color",
        "sheen", "sheen_color", "sheen_roughness", "subsurface",
        "subsurface_color", "thin_walled",
    ):
        put(name, m[name])
    # per-kind texture headers: (tid, off, w, h, rw, srgb); materials
    # without the texture point at the fallback white row
    hdr = np_dev["tex_header"]
    for kind in TEX_KINDS:
        tid = np.asarray(m[kind + "_texture_id"]).astype(np.int32)
        k = np.where((tid >= 0) & (tid < hdr.shape[0]), tid, hdr.shape[0] - 1)
        put(
            "tx_" + kind,
            np.concatenate([tid[:, None].astype(np.float32), hdr[k]], axis=1),
        )
    return out


def build_light_table(np_dev: Dict) -> np.ndarray:
    """[max(L,1), 24] float32: per emissive face verts(9) normals(9) le(3)
    area(1) for the in-kernel area-light select (pt.cu:282-322 analog)."""
    fv = np.asarray(np_dev["light_verts"])
    fn = np.asarray(np_dev["light_normals"])
    mat_ids = np.asarray(np_dev["light_mat"])
    ec = np.asarray(np_dev["materials"]["emission_color"])
    le = ec[np.clip(mat_ids, 0, len(ec) - 1)]
    e1 = fv[:, 1] - fv[:, 0]
    e2 = fv[:, 2] - fv[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    out = np.zeros((fv.shape[0], 24), np.float32)
    out[:, 0:9] = fv.reshape(-1, 9)
    out[:, 9:18] = fn.reshape(-1, 9)
    out[:, 18:21] = le
    out[:, 21] = area
    return out


def tri_soa_np(verts: np.ndarray) -> np.ndarray:
    """[9, F] float32 rows v0xyz, e1xyz, e2xyz from world verts [F,3,3]."""
    v0 = verts[:, 0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    return np.ascontiguousarray(
        np.concatenate([v0.T, e1.T, e2.T]).astype(np.float32)
    )


def _to_device(v, device):
    if isinstance(v, dict):
        return {k: _to_device(x, device) for k, x in v.items()}
    # torch.tensor copies: the inputs may be read-only views
    return torch.tensor(np.asarray(v), device=device)


def _upload(tables: Dict, n_lights: int, n_faces: int, device) -> Dict:
    dev = {k: _to_device(v, device) for k, v in tables.items()}
    dev["n_lights"] = int(n_lights)
    dev["n_faces"] = int(n_faces)
    return dev


def build_clustered_tlas(verts: np.ndarray) -> TLAS:
    """World triangles [F, 3, 3] -> numpy SAH BVH -> cluster hierarchy ->
    a TLAS of one identity instance (device.py:93-114)."""
    v0 = verts[:, 0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    bvh = build_bvh(verts.min(axis=1), verts.max(axis=1))
    return build_tlas([extract_hierarchy(bvh, v0, e1, e2)], [(0, np.eye(4))])


def build_host_tables(scene: Scene) -> Dict:
    """numpy tables: {fused_table, fused_mat_table, light_table}, the
    wavefront's face, material and light SoA, tri_soa (dense scenes) or
    tlas and slot_attrs (clustered scenes), and n_lights / n_faces."""
    if not scene.is_valid():
        raise ValueError("invalid scene")
    n_faces = int(scene.n_faces())
    if scene.textures:
        raise NotImplementedError("textured scenes are not ported yet")
    fd = world_face_data(scene)
    mats = materials_to_soa(scene.materials)
    n_mats = len(scene.materials) if scene.materials else 1
    mat_ids = np.clip(scene.material_ids, 0, n_mats - 1).astype(np.int32)
    lights = scene.emissive_faces().astype(np.int32)
    lsoa = _light_soa(
        fd["verts"][lights], fd["normals"][lights], fd["uvs"][lights],
        mat_ids[lights],
    )
    np_dev = {
        "face_verts": fd["verts"],
        "face_normals": fd["normals"],
        "face_uvs": fd["uvs"],
        "face_mat": mat_ids,
        "materials": mats,
        # no textures: only the fallback white header row
        "tex_header": np.asarray([[0.0, 1.0, 1.0, 1.0, 0.0]], np.float32),
        **lsoa,
    }
    out = {
        "fused_table": build_fused_table(np_dev),
        "fused_mat_table": build_fused_mat_table(np_dev),
        "light_table": build_light_table(np_dev),
        **{k: np_dev[k] for k in _WAVEFRONT_KEYS},
        "n_lights": int(lights.shape[0]),
        "n_faces": n_faces,
    }
    if n_faces <= DENSE_MAX_FACES:
        out["tri_soa"] = tri_soa_np(fd["verts"])
    else:
        tlas = build_clustered_tlas(fd["verts"])
        out["tlas"] = tlas
        out["slot_attrs"] = build_slot_attrs(np_dev, tlas.blocks[9])
    return out


def build_device_scene(scene: Scene, device) -> Dict:
    """Scene -> dict of tensors on `device` (see module docstring)."""
    host = build_host_tables(scene)
    n_lights, n_faces = host.pop("n_lights"), host.pop("n_faces")
    tlas = host.pop("tlas", None)
    dev = _upload(host, n_lights, n_faces, device)
    if tlas is not None:
        dev["clusters"] = prepare_clustered(tlas, device)
    return dev


_TRI_KEYS = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")


def dev_from_reference(np_dev: Dict, device) -> Dict:
    """The reference's `build_device_scene` output of a dense scene (arrays
    as numpy) -> the port's dev dict, on the same table bytes."""
    tri = np.concatenate(
        [np.asarray(np_dev["tri_soa"][k], np.float32).reshape(1, -1)
         for k in _TRI_KEYS]
    )
    tables = {
        "fused_table": np.asarray(np_dev["fused_table"], np.float32),
        "fused_mat_table": np.asarray(np_dev["fused_mat_table"], np.float32),
        "light_table": np.asarray(np_dev["light_table"], np.float32),
        "tri_soa": tri,
        **{k: np_dev[k] for k in _WAVEFRONT_KEYS},
    }
    return _upload(tables, np_dev["n_lights"], np_dev["n_faces"], device)
