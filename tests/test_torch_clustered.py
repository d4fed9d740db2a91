"""The port's clustered path against the reference's numpy path.

- Host tables: the port's BVH, cluster hierarchy, TLAS, prepared traversal
  tables and slot attribute table are byte-equal to the reference's built
  with `build_bvh(..., prefer_native=False, thread=False)` (the builder
  the port copies; the reference's native builder gives another, equally
  valid tree), on the bench's hosek-sweep scene and a small terrain.
- The clustered closest-hit / any-hit twins against the reference's Pallas
  kernels in interpret mode (tests/test_bvh.py:188-275 inputs, plus dead
  lanes): hit masks and occlusion equal; on lanes with the same prim, t
  within rtol 1e-5 and the barycentrics u, v (values in [0, 1]) within
  1e-5 absolute (XLA:CPU contracts the interpreted kernel's products into
  FMAs; measured 1.6e-6 on u). A different prim is allowed only at a near-tie (relative
  t within 1e-6): the reference keeps the first triangle its per-tile
  front-to-back order visits, the port the lowest (inst, slot).
- The kernels' 16-byte records and the uploaded visit orders and keys hold
  the reference's table entries byte for byte.
- The twin's walk (front to back in each ray's own visit order, the
  key-bound exit, the (t, inst, slot) rule) equals a plain table-order walk
  bit for bit in every visit order, with the exit on and off, and on
  constructed exact ties; its test counts equal a ray-at-a-time replay of
  the kernels' one-lane walk.
- The slot-fetch twin, on the device's row table (the host's plane-major
  table slot-major, bit for bit), against the reference's fetch of the
  plane-major one (interpret mode), bit-equal; the wrapper refuses a
  plane-major table and a misaligned row view.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from fredholm_tpu.accel import pallas_clustered as pc
from fredholm_tpu.accel.bvh import build_bvh as j_build_bvh
from fredholm_tpu.accel.cluster import build_tlas as j_build_tlas
from fredholm_tpu.accel.cluster import extract_hierarchy as j_extract
from fredholm_tpu.fused.slot_fetch import build_slot_attrs as j_slot_attrs
from fredholm_tpu.fused.slot_fetch import fetch_geom_by_slot as j_fetch
from fredholm_tpu.scene.device import world_face_data as j_wfd
from fredholm_tpu.scene.procedural import terrain as j_terrain
from fredholm_tpu.scene.types import materials_to_soa as j_mats
from fredholm_tpu_torch import _build
from fredholm_tpu_torch.accel import bvh as tbvh
from fredholm_tpu_torch.accel import cluster as tcluster
from fredholm_tpu_torch.accel import clustered as tcl
from fredholm_tpu_torch.fused import slot_fetch as tsf
from fredholm_tpu_torch.scene import device as tdev
from fredholm_tpu_torch.scene.procedural import hosek_sweep_scene, terrain

from test_bvh import _sphere_blas
from test_torch_cache import (  # noqa: F401 (autouse)
    cached, cached_all, release_compiled_programs)

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

BVH_FIELDS = ("bounds_min", "bounds_max", "left", "right", "leaf_start",
              "leaf_count", "axis", "prim_order")
TLAS_FIELDS = ("sc_aabb", "sc_mcount", "sc_order", "sc_key", "cl_meta", "blocks",
               "inst_aabb", "inst_minv", "inst_sc", "reg_aabb")


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _reference_numpy_path(j_scene):
    """The reference's tables on its numpy BVH builder."""
    vw = j_wfd(j_scene)["verts"]
    v0, e1, e2 = vw[:, 0], vw[:, 1] - vw[:, 0], vw[:, 2] - vw[:, 0]
    bvh = j_build_bvh(vw.min(axis=1), vw.max(axis=1), prefer_native=False, thread=False)
    tlas = j_build_tlas([j_extract(bvh, v0, e1, e2)], [(0, np.eye(4))])
    n_mats = len(j_scene.materials)
    np_dev = {
        "face_verts": vw,
        "face_normals": j_wfd(j_scene)["normals"],
        "face_uvs": j_wfd(j_scene)["uvs"],
        "face_mat": np.clip(j_scene.material_ids, 0, n_mats - 1).astype(np.int32),
        "materials": j_mats(j_scene.materials),
    }
    return bvh, tlas, j_slot_attrs(np_dev, np.asarray(tlas.blocks[9]))


def _tables_out(bvh, tlas, slots):
    return {**{"bvh_" + f: getattr(bvh, f) for f in BVH_FIELDS},
            **{"tlas_" + f: getattr(tlas, f) for f in TLAS_FIELDS + ("inst_identity",)},
            "slots": slots}


def _tables_in(z, bvh_cls, tlas_cls):
    bvh = bvh_cls(**{f: z["bvh_" + f] for f in BVH_FIELDS})
    tlas = tlas_cls(**{f: z["tlas_" + f] for f in TLAS_FIELDS},
                    inst_identity=bool(z["tlas_inst_identity"]))
    return bvh, tlas, z["slots"]


def _scene_key(scene):
    return [getattr(scene, k) for k in ("vertices", "normals", "texcoords", "indices",
                                        "material_ids")] + [vars(m) for m in scene.materials]


@pytest.fixture(scope="module", params=["hosek_sweep", "terrain48"])
def both_tables(request, tmp_path_factory):
    if request.param == "hosek_sweep":
        scene, j_scene = hosek_sweep_scene(), bench._sweep_scene()
    else:
        scene, j_scene = terrain(n=48, size=6.0), j_terrain(n=48, size=6.0)

    def port():
        # the BVH the upload builds, kept as it is built (the numpy builder
        # takes seconds on the sweep, so it runs once a session)
        built = []
        real = tdev.build_bvh
        tdev.build_bvh = lambda lo, hi: built.append(real(lo, hi)) or built[-1]
        try:
            host = tdev.build_host_tables(scene)
        finally:
            tdev.build_bvh = real
        assert len(built) == 1
        return _tables_out(built[0], host["tlas"], host["slot_attrs"])

    port_z, ref_z = cached_all(tmp_path_factory, [
        ("numpy_tables_port", _scene_key(scene), port),
        ("numpy_tables_reference", _scene_key(j_scene),
         lambda: _tables_out(*_reference_numpy_path(j_scene)))])
    bvh, tlas, slots = _tables_in(port_z, tbvh.BVH, tcluster.TLAS)
    j_tables = _tables_in(ref_z, types.SimpleNamespace, types.SimpleNamespace)
    return scene, j_scene, bvh, {"tlas": tlas, "slot_attrs": slots}, j_tables


def test_hosek_sweep_scene_is_the_bench_scene():
    a, b = hosek_sweep_scene(), bench._sweep_scene()
    assert a.n_faces() == b.n_faces() == 96770
    for k in ("vertices", "normals", "texcoords", "indices", "material_ids",
              "instance_ids", "transforms"):
        assert _same(getattr(a, k), getattr(b, k)), k
    assert [vars(m) for m in a.materials] == [vars(m) for m in b.materials]


def test_terrain_scene_is_byte_equal():
    a, b = terrain(n=48, size=6.0), j_terrain(n=48, size=6.0)
    for k in ("vertices", "normals", "texcoords", "indices", "material_ids"):
        assert _same(getattr(a, k), getattr(b, k)), k
    assert [vars(m) for m in a.materials] == [vars(m) for m in b.materials]


@pytest.mark.parametrize("field", BVH_FIELDS)
def test_bvh_byte_equal_to_numpy_builder(both_tables, field):
    _, _, port_bvh, _, (j_bvh, _, _) = both_tables
    assert _same(getattr(port_bvh, field), getattr(j_bvh, field)), field


def test_cluster_tables_byte_equal(both_tables):
    _, _, _, host, (_, j_tlas, j_slots) = both_tables
    tlas = host["tlas"]
    for k in TLAS_FIELDS:
        assert _same(getattr(tlas, k), getattr(j_tlas, k)), k
    assert tlas.inst_identity and j_tlas.inst_identity
    assert _same(host["slot_attrs"], j_slots)


def test_prepared_tables_byte_equal(both_tables):
    _, _, _, host, (_, j_tlas, _) = both_tables
    got = tcl.prepare_clustered(host["tlas"], "cpu")
    want = pc.prepare_clustered(j_tlas)
    for k in tcl._TABLE_KEYS:
        assert _same(got[k].numpy(), want[k]), k
    assert got["identity"] is True and got["n_instances"] == 1


def test_card_records_hold_the_tables(both_tables):
    """The kernels' 16-byte records and the uploaded visit orders and keys
    hold the reference's table entries byte for byte."""
    _, _, _, host, (_, j_tlas, _) = both_tables
    c = tcl.prepare_clustered(host["tlas"], "cpu")
    rec = {k: c[k].numpy() for k in tcl._RECORD_KEYS}
    f32 = np.float32

    def word(a, col, dtype):
        return np.ascontiguousarray(a[:, col]).view(dtype)

    assert _same(c["sc_order"].numpy(), j_tlas.sc_order)
    assert _same(c["sc_key"].numpy(), j_tlas.sc_key)
    assert _same(np.ascontiguousarray(rec["inst_rec"][:, 0:3].T), j_tlas.inst_aabb[0:3])
    assert _same(np.ascontiguousarray(rec["inst_rec"][:, 4:7].T), j_tlas.inst_aabb[3:6])
    assert _same(word(rec["inst_rec"], 3, np.int32), j_tlas.inst_sc[0])
    assert _same(word(rec["inst_rec"], 7, np.int32), j_tlas.inst_sc[1])
    assert _same(np.ascontiguousarray(rec["inst_xf"].T), j_tlas.inst_minv)
    sc = rec["sc_rec"]
    assert _same(np.ascontiguousarray(sc[:, 0:3].T), j_tlas.sc_aabb[0:3])
    assert _same(np.ascontiguousarray(sc[:, 4:7].T), j_tlas.sc_aabb[3:6])
    mcount = word(sc, 3, np.int32)
    assert _same(mcount, j_tlas.sc_mcount)
    first = word(sc, 7, np.int32)
    cl = rec["cl_rec"]
    for s in range(mcount.shape[0]):
        want = j_tlas.cl_meta[:, s * 128:s * 128 + mcount[s]]
        got = cl[first[s]:first[s] + mcount[s]]
        assert _same(np.ascontiguousarray(got[:, 0:3].T), want[0:3])
        assert _same(np.ascontiguousarray(got[:, 4:7].T), want[3:6])
        assert _same(got[:, 3], want[6]) and _same(got[:, 7], want[7])
    assert _same(cl[:, 7], np.arange(cl.shape[0], dtype=f32))  # members in cluster-id order
    blocks = j_tlas.blocks
    gcols = (np.arange(cl.shape[0])[:, None] * 128 + np.arange(8)).ravel()
    grp = rec["grp_rec"]
    assert _same(np.ascontiguousarray(grp[:, 0:3].T), blocks[10:13, gcols])
    assert _same(np.ascontiguousarray(grp[:, 4:7].T), blocks[13:16, gcols])
    tri = rec["tri_rec"]
    for lo, row in ((0, 0), (4, 3), (8, 6)):
        assert _same(np.ascontiguousarray(tri[:, lo:lo + 3].T), blocks[row:row + 3])
    assert _same(tri[:, 3], blocks[9])
    assert not tri[:, [7, 11]].any() and not grp[:, [3, 7]].any()


def test_device_scene_is_clustered():
    """The device's slot table is the host's [32, S] slot-major, bit for
    bit: one 128-byte row a slot."""
    scene = terrain(n=48, size=6.0)
    dev = tdev.build_device_scene(scene, "cpu")
    assert "tri_soa" not in dev and "clusters" in dev and "slot_attrs" not in dev
    host = tdev.build_host_tables(scene)["slot_attrs"]
    rows = dev["slot_rows"]
    assert rows.shape == (dev["clusters"]["blocks"].shape[1], 32) and rows.is_contiguous()
    assert rows.numpy().tobytes() == np.ascontiguousarray(host.T).tobytes()


# ---------------------------------------------------------------------------
# B4 / B5 twins against the Pallas kernels (interpret mode)


def _rays(o, d, tmax):
    rays = np.concatenate([o.T, d.T, tmax[None]]).astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(rays))


def _sphere_case(instanced: bool):
    """(port tables, reference tables, rays [7, M], identity)."""
    if instanced:
        h, _, _, _ = _sphere_blas(n_theta=16, n_phi=32)
        m_a = np.eye(4, dtype=np.float32)
        m_a[:3, 3] = [-1.6, 0.0, 0.0]
        m_b = np.diag([0.5, 0.5, 0.5, 1.0]).astype(np.float32)
        m_b[:3, 3] = [1.6, 0.3, 0.0]
        tlas = j_build_tlas([h], [(0, m_a), (0, m_b)])
        rng = np.random.default_rng(3)
        o = rng.normal(size=(192, 3)).astype(np.float32)
        o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
        d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    else:
        h, _, _, _ = _sphere_blas()
        tlas = j_build_tlas([h], [(0, np.eye(4))])
        rng = np.random.default_rng(11)
        o1 = rng.normal(size=(256, 3)).astype(np.float32)
        o1 = 3.0 * o1 / np.linalg.norm(o1, axis=-1, keepdims=True)
        d1 = -o1 / np.linalg.norm(o1, axis=-1, keepdims=True)
        # rays from inside and around the sphere in random directions
        # (tests/test_slot_fetch.py:30-35)
        o2 = rng.normal(size=(768, 3)).astype(np.float32)
        o2 = 1.6 * o2 / np.linalg.norm(o2, axis=-1, keepdims=True)
        d2 = rng.normal(size=(768, 3)).astype(np.float32)
        d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
        o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    tmax = np.full(o.shape[0], 1e9, np.float32)
    tmax[rng.uniform(size=o.shape[0]) < 0.1] = -1.0  # dead lanes
    tmax[rng.uniform(size=o.shape[0]) < 0.03] = 0.0
    short = rng.uniform(size=o.shape[0]) < 0.1  # shadow-style finite tmax
    tmax[short] = rng.uniform(0.5, 3.0, short.sum()).astype(np.float32)
    return tcl.prepare_clustered(tlas, "cpu"), pc.prepare_clustered(tlas), _rays(o, d, tmax), tlas


@pytest.fixture(scope="module", params=["identity", "instanced"])
def traversal_case(request, tmp_path_factory):
    instanced = request.param == "instanced"
    c, j_c, rays, tlas = _sphere_case(instanced)
    assert c["identity"] == (not instanced)

    def reference():
        o = jnp.asarray(rays[0:3].T.numpy())
        d = jnp.asarray(rays[3:6].T.numpy())
        t = jnp.asarray(rays[6].numpy())
        want = pc.intersect_closest_clustered(j_c, o, d, t, identity=not instanced)
        occ = pc.intersect_any_clustered(j_c, o, d, t, identity=not instanced)
        return {**{k: np.asarray(v) for k, v in want.items()}, "occ": np.asarray(occ)}

    want = cached(tmp_path_factory, "clustered_traversal",
                  (instanced, rays.numpy(), {k: np.asarray(v) for k, v in j_c.items()}),
                  reference)
    want_occ = want.pop("occ")
    return c, rays, tlas, want, want_occ


def test_closest_twin_matches_pallas(traversal_case):
    c, rays, tlas, want, _ = traversal_case
    _build.LAUNCHES.clear()
    got = {k: v.numpy() for k, v in tcl.intersect_closest_clustered(c, rays).items()}
    assert _build.LAUNCHES["clustered_closest_twin"] == 1
    hit = got["prim"] >= 0
    np.testing.assert_array_equal(hit, want["hit"])
    dead = rays[6].numpy() <= 0.0
    assert hit.any() and (~hit & ~dead).any() and not hit[dead].any()
    same = hit & (got["prim"] == want["prim"])
    tie = hit & ~same
    rel_t = np.abs(got["t"] - want["t"]) / np.maximum(np.abs(want["t"]), 1.0)
    assert (rel_t[tie] <= 1e-6).all(), "a different prim away from a tie"
    assert tie.sum() <= 2, f"{tie.sum()} near-tie lanes"
    np.testing.assert_allclose(got["t"][same], want["t"][same], rtol=1e-5, atol=0.0)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=0.0, atol=1e-5, err_msg=k)
    # miss contract: t = tmax, u = v = 0, slot = -1, inst = 0
    np.testing.assert_array_equal(got["t"][~hit], rays[6].numpy()[~hit])
    assert (got["u"][~hit] == 0).all() and (got["v"][~hit] == 0).all()
    assert (got["slot"][~hit] == -1).all() and (got["inst"][~hit] == 0).all()
    # the slot names the hit triangle through blocks row 9
    row9 = np.asarray(tlas.blocks[9])
    np.testing.assert_array_equal(row9[got["slot"][hit]].astype(np.int32), got["prim"][hit])
    np.testing.assert_array_equal(got["slot"][same], want["slot"][same])
    np.testing.assert_array_equal(got["inst"][same], want["inst"][same])
    if not c["identity"]:
        assert set(np.unique(got["inst"][hit])) == {0, 1}


def test_any_twin_matches_pallas(traversal_case):
    c, rays, _, want, want_occ = traversal_case
    _build.LAUNCHES.clear()
    occ = tcl.intersect_any_clustered(c, rays)
    assert occ.dtype == torch.bool and _build.LAUNCHES["clustered_any_twin"] == 1
    np.testing.assert_array_equal(occ.numpy(), want_occ)
    np.testing.assert_array_equal(occ.numpy(), want["hit"])


def test_twin_traverses_a_column_view():
    """The pipeline traces a block range of one ray buffer in place."""
    c, _, rays, _ = _sphere_case(False)
    buf = torch.cat([rays, rays], dim=1)
    m = rays.shape[1]
    a = tcl.intersect_closest_clustered(c, buf[:, m:])
    b = tcl.intersect_closest_clustered(c, rays)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="unit column stride"):
        tcl.intersect_closest_clustered(c, buf[:, ::2])


def test_twin_counts_its_tests():
    c, _, rays, _ = _sphere_case(False)
    stats = {"slab": 0, "tri": 0}
    got = tcl.intersect_closest_twin(c, rays, stats)
    alive = int((rays[6] > 0).sum())
    assert stats["slab"] >= alive and stats["tri"] > alive
    read = stats["read"]
    hit_slots = got["slot"][got["prim"] >= 0].long()
    assert read["prim"][hit_slots].all() and read["tri"][hit_slots].all()
    assert int(read["prim"].sum()) == torch.unique(hit_slots).numel()
    assert 0 < stats["table_bytes"] < sum(c[k].numel() * 4 for k in tcl._TABLE_KEYS)


def _kernel_walk(c, rays, any_hit):
    """csrc/clustered.cu's one-lane walk, one ray at a time in float32
    numpy: superclusters front to back in the ray's own visit order with
    the key-bound exit, hits by the (t, inst, slot) rule. Returns (slab
    tests, triangle tests, key-bound tests, {table: entries read})."""
    f = np.float32
    tb = {k: c[k].numpy() for k in tcl._TABLE_KEYS}
    n_inst, n_sc = tb["inst_aabb"].shape[1], tb["sc_aabb"].shape[1]
    blocks = tb["blocks"]
    n = {"slab": 0, "tri": 0, "key": 0}
    read = {k: set() for k in ("sc_aabb", "sc_mcount", "sc_order", "sc_key", "cl_box",
                               "cl_ref", "grp_box", "tri", "prim")}

    def inv_dir(x):
        return f(1.0) / ((f(-1e-12) if x < 0 else f(1e-12)) if abs(x) < f(1e-12) else x)

    def slab_t(box, o, inv):
        t1 = [(box[k] - o[k]) * inv[k] for k in range(3)]
        t2 = [(box[3 + k] - o[k]) * inv[k] for k in range(3)]
        tn = max(max(min(t1[0], t2[0]), min(t1[1], t2[1])), min(t1[2], t2[2]))
        tf = min(min(max(t1[0], t2[0]), max(t1[1], t2[1])), max(t1[2], t2[2]))
        return tn, tf

    def slab(box, o, inv, best):
        n["slab"] += 1
        tn, tf = slab_t(box, o, inv)
        return tn <= tf and tf >= 0 and tn <= best

    def walk(o, d, tmax):
        inv = [inv_dir(x) for x in d]
        tn, tf = slab_t(tb["root_aabb"][:, 0], o, inv)
        best = min(tmax, tf * f(1.0001) + f(1e-4) if tn <= tf and tf >= 0 else f(0.0))
        best_slot, best_inst = -1, 0
        for i in range(n_inst):
            if not slab(tb["inst_aabb"][:, i], o, inv, best):
                continue
            ro, rd, rinv = o, d, inv
            if not c["identity"]:
                mm = tb["inst_minv"][:, i]
                ro = [mm[4 * r] * o[0] + mm[4 * r + 1] * o[1] + mm[4 * r + 2] * o[2]
                      + mm[4 * r + 3] for r in range(3)]
                rd = [mm[4 * r] * d[0] + mm[4 * r + 1] * d[1] + mm[4 * r + 2] * d[2]
                      for r in range(3)]
                rinv = [inv_dir(x) for x in rd]
            a = [abs(x) for x in rd]
            ax = 0 if a[0] >= a[1] and a[0] >= a[2] else (1 if a[1] >= a[2] else 2)
            neg = rd[ax] < 0
            oc = 2 * ax + int(neg)
            op, ip, dp = ((-x[ax] if neg else x[ax]) for x in (ro, rinv, rd))
            sc_lo, sc_n = tb["inst_sc"][0, i], tb["inst_sc"][1, i]
            for col in range(sc_lo, sc_lo + sc_n):
                n["key"] += 1
                read["sc_key"].add(oc * n_sc + col)
                if dp > f(1e-7) and (tb["sc_key"][oc, col] - op) * ip > best:
                    break
                read["sc_order"].add(oc * n_sc + col)
                s = tb["sc_order"][oc, col]
                read["sc_aabb"].add(s)
                if not slab(tb["sc_aabb"][:, s], ro, rinv, best):
                    continue
                read["sc_mcount"].add(s)
                for mc in range(s * 128, s * 128 + tb["sc_mcount"][s]):
                    read["cl_box"].add(mc)
                    if not slab(tb["cl_meta"][:, mc], ro, rinv, best):
                        continue
                    read["cl_ref"].add(mc)
                    cnt = int(tb["cl_meta"][6, mc])
                    base = int(tb["cl_meta"][7, mc]) * 128
                    for g in range(-(-cnt // 16)):
                        read["grp_box"].add(base + g)
                        if not slab(blocks[10:16, base + g], ro, rinv, best):
                            continue
                        for k in range(base + 16 * g, base + min(cnt, 16 * g + 16)):
                            n["tri"] += 1
                            read["tri"].add(k)
                            v0, e1, e2 = blocks[0:3, k], blocks[3:6, k], blocks[6:9, k]
                            p = [rd[1] * e2[2] - rd[2] * e2[1], rd[2] * e2[0] - rd[0] * e2[2],
                                 rd[0] * e2[1] - rd[1] * e2[0]]
                            det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]
                            inv_det = f(1.0) / det if abs(det) > f(1e-12) else f(0.0)
                            tv = [ro[0] - v0[0], ro[1] - v0[1], ro[2] - v0[2]]
                            u = (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2]) * inv_det
                            q = [tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
                                 tv[0] * e1[1] - tv[1] * e1[0]]
                            v = (rd[0] * q[0] + rd[1] * q[1] + rd[2] * q[2]) * inv_det
                            t = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * inv_det
                            if not (abs(det) > f(1e-12) and u >= 0 and v >= 0
                                    and u + v <= f(1.0) and t > 0):
                                continue
                            if any_hit:
                                if t < best:
                                    return
                                continue
                            if t < best or (t == best and best_slot >= 0
                                            and (i, k) < (best_inst, best_slot)):
                                best, best_slot, best_inst = t, k, i
        if best_slot >= 0:
            read["prim"].add(best_slot)

    r = rays.numpy()
    for j in range(r.shape[1]):
        if r[6, j] > 0:
            walk(list(r[0:3, j]), list(r[3:6, j]), r[6, j])
    return n["slab"], n["tri"], n["key"], read


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("instanced", [False, True], ids=["identity", "instanced"])
def test_twin_counts_the_kernels_walk(any_hit, instanced):
    """The twin's test counts and read masks (which set chip_smoke.py's
    bounds) equal a ray-at-a-time replay of the kernel's front-to-back
    walk, its key-bound exit and the early exit of any-hit included."""
    c, _, rays, _ = _sphere_case(instanced)
    rays = rays[:, ::4].contiguous()
    stats = {"slab": 0, "tri": 0}
    (tcl.intersect_any_twin if any_hit else tcl.intersect_closest_twin)(c, rays, stats)
    n_slab, n_tri, n_key, read = _kernel_walk(c, rays, any_hit)
    assert (stats["slab"], stats["tri"], stats["key"]) == (n_slab, n_tri, n_key)
    for k, entries in read.items():
        assert set(torch.nonzero(stats["read"][k]).flatten().tolist()) == entries, k


def _bits_equal(got, want, keys):
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].numpy().tobytes() == want[k].numpy().tobytes(), k


@pytest.mark.parametrize("instanced", [False, True], ids=["identity", "instanced"])
def test_twin_does_not_depend_on_the_visit_order(instanced):
    """The (t, inst, slot) result of the front-to-back walk, per-ray order
    or any one of the six for every ray, key-bound exit on or off, equals
    the plain table-order walk bit for bit; so does any-hit's."""
    c, _, rays, _ = _sphere_case(instanced)
    keys = ("t", "prim", "u", "v", "inst", "slot")
    want = tcl.intersect_closest_twin(c, rays, order="table")
    want_occ = tcl.intersect_any_twin(c, rays, order="table")
    assert bool((want["prim"] >= 0).any())
    for order in ("ray", *range(6)):
        for early_exit in (True, False):
            got = tcl.intersect_closest_twin(c, rays, order=order, early_exit=early_exit)
            _bits_equal(got, want, keys)
            occ = tcl.intersect_any_twin(c, rays, order=order, early_exit=early_exit)
            assert torch.equal(occ, want_occ), (order, early_exit)


def _tie_case(kind: str):
    """Tables with an exact tie, rays through it and the slots that tie.
    "triangle": a triangle of the sphere's first supercluster (one that
    no axis flattens) copied into a free slot of a cluster of the other,
    the boxes on its way widened to hold it; "instances": two instances of
    one sphere under the same non-identity transform."""
    from fredholm_tpu_torch.accel.cluster import _direction_orders, build_tlas

    h, _, _, _ = _sphere_blas()
    rng = np.random.default_rng(5)
    if kind == "instances":
        m4 = np.diag([0.8, 0.8, 0.8, 1.0]).astype(np.float32)
        m4[:3, 3] = [0.3, -0.2, 0.1]
        tlas = build_tlas([h], [(0, m4), (0, m4)])
        target = rng.normal(size=(64, 3)) * 0.3 + m4[:3, 3]
        pair = None
    else:
        tlas = build_tlas([h], [(0, np.eye(4))])
        meta, b = tlas.cl_meta, tlas.blocks
        src = next(k for k in range(int(meta[6, 0]))
                   if (np.ptp(b[0:3, k][:, None] + np.c_[np.zeros(3), b[3:6, k], b[6:9, k]],
                              axis=1) > 1e-3).all())
        dst_col = next(j for j in range(128, 128 + int(tlas.sc_mcount[1])) if meta[6, j] < 128)
        cnt = int(meta[6, dst_col])
        dst = int(meta[7, dst_col]) * 128 + cnt
        b[0:10, dst] = b[0:10, src]
        v = np.stack([b[0:3, src], b[0:3, src] + b[3:6, src], b[0:3, src] + b[6:9, src]])
        lo, hi = v.min(axis=0), v.max(axis=0)
        g = int(meta[7, dst_col]) * 128 + cnt // 16
        b[10:13, g] = np.minimum(b[10:13, g], lo)
        b[13:16, g] = np.maximum(b[13:16, g], hi)
        meta[6, dst_col] = cnt + 1
        meta[0:3, dst_col] = np.minimum(meta[0:3, dst_col], lo)
        meta[3:6, dst_col] = np.maximum(meta[3:6, dst_col], hi)
        tlas.sc_aabb[0:3, 1] = np.minimum(tlas.sc_aabb[0:3, 1], lo)
        tlas.sc_aabb[3:6, 1] = np.maximum(tlas.sc_aabb[3:6, 1], hi)
        tlas.sc_order, tlas.sc_key = _direction_orders(tlas.sc_aabb)
        target = rng.dirichlet([2, 2, 2], 64) @ v
        pair = (src, dst)
    # rays from all around toward the tied surface
    o = rng.normal(size=(64, 3))
    o = (target + 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tcl.prepare_clustered(tlas, "cpu"), _rays(o, d, np.full(64, 1e9, np.float32)), pair


@pytest.mark.parametrize("kind", ["triangle", "instances"])
def test_exact_tie_takes_the_lowest_inst_and_slot(kind):
    """On an exact tie every visit order reports the lowest (inst, slot):
    a triangle copied into another supercluster's cluster, and two
    instances that coincide."""
    c, rays, pair = _tie_case(kind)
    keys = ("t", "prim", "u", "v", "inst", "slot")
    want = tcl.intersect_closest_twin(c, rays, order="table")
    hit = want["prim"] >= 0
    if kind == "instances":
        assert int(hit.sum()) >= 32 and (want["inst"][hit] == 0).all()
    else:
        assert c["sc_mcount"].shape[0] == 2
        on_pair = want["prim"] == int(c["blocks"][9, pair[0]])
        assert int(on_pair.sum()) >= 16 and (want["slot"][on_pair] == min(pair)).all()
    for order in ("ray", *range(6)):
        _bits_equal(tcl.intersect_closest_twin(c, rays, order=order), want, keys)


# ---------------------------------------------------------------------------
# B6: the slot fetch


def test_slot_fetch_twin_matches_reference():
    """The slots of tests/test_slot_fetch.py:52-80 on the small terrain."""
    host = tdev.build_host_tables(terrain(n=48, size=6.0))
    table = host["slot_attrs"]
    row9 = host["tlas"].blocks[9]
    rng = np.random.default_rng(11)
    filled = np.where(row9 >= 0)[0]
    slots = rng.choice(filled, size=700).astype(np.int32)
    slots = np.concatenate([slots, np.full((68,), -1, np.int32)])
    rng.shuffle(slots)
    want = j_fetch({"slot_attrs": jnp.asarray(table)}, jnp.asarray(slots))
    _build.LAUNCHES.clear()
    got = tsf.fetch_geom_by_slot(torch.as_tensor(tsf.slot_rows(table)), torch.as_tensor(slots))
    assert got.shape == (tsf.A_USED, slots.shape[0])
    assert _build.LAUNCHES["slot_fetch_twin"] == 1
    for a in range(tsf.A_USED):
        assert np.asarray(want[a]).tobytes() == got[a].numpy().tobytes(), a
    assert (got[:, slots < 0] == 0).all()


@pytest.mark.parametrize("table", ("planes", "misaligned"))
def test_slot_fetch_refuses_other_tables(table):
    """The wrapper takes the row table alone: a plane-major [32, S] table
    and a [S, 32] view off a 16-byte boundary raise, on the CPU too."""
    n_slots = 256
    if table == "planes":
        t = torch.zeros((tsf.SLOT_ROWS, n_slots), dtype=torch.float32)
    else:
        t = torch.zeros(n_slots * tsf.SLOT_ROWS + 1, dtype=torch.float32)[1:]
        t = t.view(n_slots, tsf.SLOT_ROWS)
        assert t.is_contiguous() and t.data_ptr() % 16
    slot = torch.zeros(8, dtype=torch.int32)
    _build.LAUNCHES.clear()
    with pytest.raises(ValueError, match="rows must be"):
        tsf.fetch_geom_by_slot(t, slot)
    assert not _build.LAUNCHES
