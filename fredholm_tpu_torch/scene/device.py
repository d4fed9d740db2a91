"""Host scene -> device tensors.

Port of fredholm_tpu/scene/device.py:84-189 and :263-481 (without the
skip-link BVH and the refit) plus the fused table builders of
fredholm_tpu/fused/pt_fused.py:139-234. Tables are assembled in numpy,
byte-identical to the reference's numpy path, then uploaded once:

  fused_table      [F, GEOM_COLS] f32  per-face geometry (+ mat_id)
  fused_mat_table  [M, MAT_COLS]  f32  per-material shading params
  light_table      [max(L,1), 24] f32  emissive faces for NEE
  tri_soa          [9, F]         f32  rows v0xyz, e1xyz, e2xyz
                                       (dense scenes, F <= 1024)
  clusters         dict                the clustered traversal tables
                                       (accel/clustered.py; F > 1024)
  slot_rows        [K*128, 32]    f32  geometry in slot order, a slot's
                                       26 words (+6 pad) in one 128 B
                                       row: the host's slot_attrs [32,
                                       K*128] (fused/slot_fetch.py
                                       `build_slot_attrs`, the reference's
                                       layout) slot-major (`slot_rows`);
                                       F > 1024
  tex_runs         [R, 16]        i32  texel runs, uint32 bits, of every
                                       texture and the white fallback
                                       (scene/texture.py)

and `tex_kinds`, the TEX_KINDS any material references (a tuple: the
fused pipeline fetches exactly these),

and, for the wavefront integrator (integrator/pt.py) on every scene, the
reference's per-face and per-light SoA (device.py:143-162):

  face_verts / face_normals [F, 3, 3], face_uvs [F, 3, 2] f32, face_mat
  [F] i32; materials {name: [M] or [M, 3]}; light_verts / light_normals
  [L, 3, 3], light_uvs [L, 3, 2] f32, light_mat [L] i32 (L >= 1)

Clustered scenes are one BLAS under one identity instance. The reference
builds slot_attrs only above 2048 faces (a TPU gather cost); its own
test shows the slot fetch and the row gather bit-identical, so the port
builds the slot table for every clustered scene.

Instanced scenes (`build_instanced_device_scene`, an InstancedScene) are
always clustered: one BLAS per referenced submesh, shared by all of its
placements, under a TLAS of the placements. fused_table, slot_rows and
the face SoA stay in OBJECT space, indexed by the base scene's face id;
the lights are world space, one row for every placed copy of an emissive
face; and

  inst_table       [I, 24]        f32  a placement's object-to-world
                                       affine rows (cols 0-11) and normal
                                       matrix (12-20), which the slot
                                       fetch applies to each hit

`update_instance_transforms` moves the placements: the TLAS's instance
entries, inst_table and the lights are rebuilt, the geometry stays.

`dev_from_reference` carries the reference package's own tables of a
dense or an instanced scene across, so tests can run both packages on
literally the same inputs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..accel.bvh import build_bvh
from ..accel.cluster import SC_GROUP, TLAS, build_tlas, extract_hierarchy, update_tlas_instances
from ..accel.clustered import move_instances, prepare_clustered
from ..accel.dense import MAX_FACES as DENSE_MAX_FACES
from ..fused.slot_fetch import build_slot_attrs, slot_rows
from .texture import pack_textures
from .types import InstancedScene, MeshInstance, Scene, materials_to_soa

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


def tex_kinds(materials: Dict[str, np.ndarray]) -> tuple:
    """The texture kinds any material references, in TEX_KINDS order, from
    the materials' SoA (the reference's renderer.py:152-163
    `_scene_tex_kinds`)."""
    return tuple(k for k in TEX_KINDS if (np.asarray(materials[k + "_texture_id"]) >= 0).any())


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
    """numpy tables: {fused_table, fused_mat_table, light_table,
    tex_runs}, the wavefront's face, material and light SoA, tri_soa
    (dense scenes) or tlas and slot_attrs (clustered scenes), and
    n_lights / n_faces / tex_kinds."""
    if not scene.is_valid():
        raise ValueError("invalid scene")
    n_faces = int(scene.n_faces())
    tex = pack_textures(scene.textures)
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
        "tex_header": tex["header"],
        **lsoa,
    }
    out = {
        "fused_table": build_fused_table(np_dev),
        "fused_mat_table": build_fused_mat_table(np_dev),
        "light_table": build_light_table(np_dev),
        "tex_runs": tex["runs"].view(np.int32),
        **{k: np_dev[k] for k in _WAVEFRONT_KEYS},
        "n_lights": int(lights.shape[0]),
        "n_faces": n_faces,
        "tex_kinds": tex_kinds(mats),
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
    kinds = host.pop("tex_kinds")
    tlas = host.pop("tlas", None)
    if tlas is not None:
        host["slot_rows"] = slot_rows(host.pop("slot_attrs"))
    dev = _upload(host, n_lights, n_faces, device)
    dev["tex_kinds"] = kinds
    if tlas is not None:
        dev["clusters"] = prepare_clustered(tlas, device)
    return dev


_TRI_KEYS = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")


def dev_from_reference(np_dev: Dict, device) -> Dict:
    """The reference's `build_device_scene` output of a dense scene, or its
    `build_instanced_device_scene` output of an instanced one (arrays as
    numpy) -> the port's dev dict, on the same table bytes. An instanced
    dict carries no host state: it renders, but does not move."""
    # the reference's texture atlas where given (its "textures" entry),
    # else the fallback texture alone
    runs = np_dev["textures"]["runs"] if "textures" in np_dev else pack_textures([])["runs"]
    tables = {
        "fused_table": np.asarray(np_dev["fused_table"], np.float32),
        "fused_mat_table": np.asarray(np_dev["fused_mat_table"], np.float32),
        "light_table": np.asarray(np_dev["light_table"], np.float32),
        "tex_runs": np.asarray(runs, np.uint32).view(np.int32),
        **{k: np_dev[k] for k in _WAVEFRONT_KEYS},
    }
    tlas = None
    if "inst_table" in np_dev:
        tlas = _tlas_from_reference(np_dev["clusters"], bool(np_dev["_inst_identity"]))
        tables["inst_table"] = np.asarray(np_dev["inst_table"], np.float32)
        tables["slot_rows"] = slot_rows(np_dev["slot_attrs"] if "slot_attrs" in np_dev
                                        else build_slot_attrs(np_dev, tlas.blocks[9]))
    else:
        tables["tri_soa"] = np.concatenate(
            [np.asarray(np_dev["tri_soa"][k], np.float32).reshape(1, -1) for k in _TRI_KEYS])
    dev = _upload(tables, np_dev["n_lights"], np_dev["n_faces"], device)
    dev["tex_kinds"] = tex_kinds(np_dev["materials"])
    if tlas is not None:
        dev["clusters"] = prepare_clustered(tlas, device)
    return dev


def _tlas_from_reference(c: Dict, identity: bool) -> TLAS:
    """The TLAS behind the reference's prepared clustered tables
    (pallas_clustered.py `prepare_clustered`; its cl_meta may carry tail
    padding)."""
    n_sc = np.asarray(c["sc_mcount"]).shape[0]
    return TLAS(**{k: np.asarray(c[k]) for k in (
        "sc_aabb", "sc_mcount", "sc_order", "sc_key", "blocks", "inst_aabb", "inst_minv",
        "inst_sc", "reg_aabb")},
        cl_meta=np.ascontiguousarray(np.asarray(c["cl_meta"])[:, :n_sc * SC_GROUP]),
        inst_identity=identity)


# ---------------------------------------------------------------------------
# instanced scenes: one BLAS per referenced submesh, shared by its placements


def instance_table(instances) -> np.ndarray:
    """[I, 24] float32 shade-time transforms (device.py:266-279): cols 0-11
    the object-to-world affine rows, 12-20 the normal matrix (the inverse
    transpose of the rotation part), the rest zero. instances: (blas index,
    4x4) pairs."""
    out = np.zeros((len(instances), 24), np.float32)
    for i, (_, m4) in enumerate(instances):
        m4 = np.asarray(m4, np.float64)
        out[i, 0:12] = m4[:3, :].reshape(-1).astype(np.float32)
        out[i, 12:21] = np.linalg.inv(m4[:3, :3]).T.reshape(-1).astype(np.float32)
    return out


def _instance_lights(iscene: InstancedScene, fd: Dict, mat_ids: np.ndarray):
    """(world-space light SoA, light count): every placed copy of an
    emissive face, in placement order (device.py:334-365)."""
    base = iscene.base
    emissive = base.emissive_faces()
    lv, ln, luv, lm = [], [], [], []
    for mi in iscene.instances:
        off = int(base.submesh_offsets[mi.submesh])
        cnt = int(base.submesh_n_faces[mi.submesh])
        le_f = emissive[(emissive >= off) & (emissive < off + cnt)]
        if len(le_f) == 0:
            continue
        m4 = np.asarray(mi.transform, np.float32)
        r, t = m4[:3, :3], m4[:3, 3]
        nrm = np.linalg.inv(m4[:3, :3]).T.astype(np.float32)
        wv = np.einsum("ij,fkj->fki", r, fd["verts"][le_f]) + t
        wn = np.einsum("ij,fkj->fki", nrm, fd["normals"][le_f])
        wn = wn / np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-12)
        lv.append(wv.astype(np.float32))
        ln.append(wn.astype(np.float32))
        luv.append(fd["uvs"][le_f])
        lm.append(mat_ids[le_f])

    def cat(xs, shape, dtype):
        return np.concatenate(xs) if xs else np.zeros(shape, dtype)

    lsoa = _light_soa(cat(lv, (0, 3, 3), np.float32), cat(ln, (0, 3, 3), np.float32),
                      cat(luv, (0, 3, 2), np.float32), cat(lm, (0,), np.int32))
    return lsoa, sum(len(a) for a in lv)


def build_instanced_host_tables(iscene: InstancedScene) -> Dict:
    """numpy tables of an instanced scene (device.py:282-406): those of
    `build_host_tables` for a clustered scene (object-space geometry, the
    tlas, slot_attrs) plus inst_table, and under "_host" what a move needs
    (the BLAS list, the submesh -> BLAS map, the object-space faces, the
    materials)."""
    if not iscene.is_valid():
        raise ValueError("invalid instanced scene")
    base = iscene.base
    fd = world_face_data(base)  # base transforms are normally identity
    vw = fd["verts"]
    v0, e1, e2 = vw[:, 0], vw[:, 1] - vw[:, 0], vw[:, 2] - vw[:, 0]
    mats = materials_to_soa(base.materials)
    n_mats = len(base.materials) if base.materials else 1
    mat_ids = np.clip(base.material_ids, 0, n_mats - 1).astype(np.int32)

    blas_list, blas_of_submesh = [], {}
    for s in sorted({mi.submesh for mi in iscene.instances}):
        off, cnt = int(base.submesh_offsets[s]), int(base.submesh_n_faces[s])
        sl = slice(off, off + cnt)
        lo = np.minimum(np.minimum(v0[sl], v0[sl] + e1[sl]), v0[sl] + e2[sl])
        hi = np.maximum(np.maximum(v0[sl], v0[sl] + e1[sl]), v0[sl] + e2[sl])
        blas_of_submesh[s] = len(blas_list)
        blas_list.append(extract_hierarchy(build_bvh(lo, hi), v0[sl], e1[sl], e2[sl],
                                           prim_ids=np.arange(off, off + cnt, dtype=np.int64)))
    instances = [(blas_of_submesh[mi.submesh], np.asarray(mi.transform, np.float32))
                 for mi in iscene.instances]
    tlas = build_tlas(blas_list, instances)
    lsoa, n_lights = _instance_lights(iscene, fd, mat_ids)
    tex = pack_textures(base.textures)
    np_dev = {
        "face_verts": fd["verts"],
        "face_normals": fd["normals"],
        "face_uvs": fd["uvs"],
        "face_mat": mat_ids,
        "materials": mats,
        "tex_header": tex["header"],
        **lsoa,
    }
    return {
        "fused_table": build_fused_table(np_dev),
        "fused_mat_table": build_fused_mat_table(np_dev),
        "light_table": build_light_table(np_dev),
        "tex_runs": tex["runs"].view(np.int32),
        **{k: np_dev[k] for k in _WAVEFRONT_KEYS},
        "inst_table": instance_table(instances),
        "slot_attrs": build_slot_attrs(np_dev, tlas.blocks[9]),
        "tlas": tlas,
        "n_lights": n_lights,
        "n_faces": int(base.n_faces()),
        "tex_kinds": tex_kinds(mats),
        "_host": {"scene": iscene, "blas_list": blas_list, "blas_of_submesh": blas_of_submesh,
                  "fd": fd, "mat_ids": mat_ids, "materials": mats, "tlas": tlas},
    }


def build_instanced_device_scene(iscene: InstancedScene, device) -> Dict:
    """InstancedScene -> dict of tensors on `device` (module docstring),
    with the host state a move needs under "_host"."""
    host = build_instanced_host_tables(iscene)
    n_lights, n_faces = host.pop("n_lights"), host.pop("n_faces")
    kinds, tlas, keep = host.pop("tex_kinds"), host.pop("tlas"), host.pop("_host")
    host["slot_rows"] = slot_rows(host.pop("slot_attrs"))
    dev = _upload(host, n_lights, n_faces, device)
    dev["tex_kinds"] = kinds
    dev["clusters"] = prepare_clustered(tlas, device)
    dev["_host"] = keep
    return dev


def update_instance_transforms(dev: Dict, transforms) -> Dict:
    """Move the placements of an instanced dev dict (device.py:409-481),
    one 4x4 each, in order: the TLAS's instance entries and root box,
    inst_table and the lights are rebuilt on the host and uploaded; the
    geometry tables are dev's own tensors. Returns a new dict."""
    host = dev["_host"]
    iscene = host["scene"]
    if len(transforms) != len(iscene.instances):
        raise ValueError(f"{len(transforms)} transforms for {len(iscene.instances)} instances")
    moved = InstancedScene(base=iscene.base, instances=[
        MeshInstance(mi.submesh, np.asarray(m, np.float32))
        for mi, m in zip(iscene.instances, transforms)])
    instances = [(host["blas_of_submesh"][mi.submesh], mi.transform) for mi in moved.instances]
    tlas = update_tlas_instances(host["tlas"], host["blas_list"], instances)
    lsoa, n_lights = _instance_lights(moved, host["fd"], host["mat_ids"])
    device = dev["fused_table"].device
    new = dict(dev)
    new["clusters"] = move_instances(dev["clusters"], tlas)
    new["inst_table"] = _to_device(instance_table(instances), device)
    new["light_table"] = _to_device(build_light_table({"materials": host["materials"], **lsoa}),
                                    device)
    new.update({k: _to_device(v, device) for k, v in lsoa.items()})
    new["n_lights"] = int(n_lights)
    new["_host"] = {**host, "scene": moved, "tlas": tlas}
    return new
