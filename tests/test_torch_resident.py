"""The port's ray-resident traversal (B7), its gate and routing, and
wavefront compaction, against the reference.

- `prepare_resident` byte-equal to the reference's, on a mesh with whole
  pages and on one whose cluster count is not a multiple of P_CL (the
  padded triangle blocks); the kernel's page and span records hold
  res_meta's floats, and B4/B5's group and triangle records the blocks'.
- The walk in turn over the kernel's records (span, page, cluster, group
  and triangle records, float32), lane by lane in numpy: bit-equal to
  the twins, and the twin's per-block and per-lane counts equal to the
  unions and counts of the lanes' wanted pages and walked clusters. The
  kernel's own walk order (csrc/resident.cu: a warp tests a level at
  once, then each candidate again in turn) replayed the same way:
  bit-equal to the twins, on the sphere and on coplanar layers where the
  group test in turn decides lanes (without it the walk differs there).
- The B7 twins against the reference's Pallas kernel in interpret mode,
  one call each on 512 rays (20% dead lanes, some finite tmax): hit masks
  and occlusion equal; prim equal except at near-ties (relative t within
  1e-6, at most 2 lanes); t within rtol 1e-5 and u, v within 1e-5
  absolute, the bar of tests/test_torch_clustered.py (XLA:CPU contracts
  the interpreted kernel's products into FMAs).
- Routing with FREDHOLM_TRAV_RESIDENT: the fused pipeline's primary trace
  takes B4, its bounce and final traces B7; the wavefront never does;
  without the gate or with two instances there are no resident tables.
  On a clustered scene with emissive faces (the light block rides the
  closest trace and its MIS hits are shaded by prim) the gate changes no
  layer.
- The whole slice: metal_row with the gate on against the reference's
  plain-path render, six layers at rtol = atol = 2e-4 and an equal
  n_path_vertices.
- Compaction: `partition_dest` byte-equal to the reference's, and renders
  bit-equal with FREDHOLM_COMPACT 1 and 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fredholm_tpu.accel import pallas_clustered as pc
from fredholm_tpu.accel.cluster import build_tlas as j_build_tlas
from fredholm_tpu.experimental import compact as j_compact
from fredholm_tpu.experimental import pallas_resident as pr
from fredholm_tpu_torch import Renderer, _build, cornell_box
from fredholm_tpu_torch.accel.bvh import build_bvh
from fredholm_tpu_torch.accel.cluster import build_tlas, extract_hierarchy
from fredholm_tpu_torch.accel.clustered import prepare_clustered
from fredholm_tpu_torch.experimental import compact, resident
from fredholm_tpu_torch.integrator import pt as wavefront
from fredholm_tpu_torch.scene.procedural import _quad, _scene, uv_sphere
from fredholm_tpu_torch.scene.types import Material
from fredholm_tpu_torch.tools.resident_steps import retest_case

from test_bvh import _sphere_blas
from test_torch_cache import cached, release_compiled_programs  # noqa: F401 (autouse)
from test_torch_render import LAYERS, _metal_row, _metal_row_reference

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

GATE = "FREDHOLM_TRAV_RESIDENT"


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _partial_page_blas():
    """A sphere whose cluster count is not a whole number of pages
    (tests/test_resident.py:106-121)."""
    for n_phi in (10, 12, 14, 18, 22, 26, 30, 34):
        h = _sphere_blas(n_theta=16, n_phi=n_phi)[0]
        if h.n_clusters % resident.P_CL:
            return h
    raise AssertionError("no mesh size gave a cluster count off the page size")


def test_prepare_resident_byte_equal(monkeypatch):
    for h, padded in ((_sphere_blas()[0], False), (_partial_page_blas(), True)):
        tlas = j_build_tlas([h], [(0, np.eye(4))])
        want = pr.prepare_resident(tlas)
        got = resident.prepare_resident(tlas, "cpu")
        # the reference's tables, and the kernel's records beside them
        assert sorted(set(got) - set(want)) == ["res_page", "res_span"]
        assert set(want) <= set(got) and ("res_blocks" in got) == padded
        for k in want:
            assert _same(got[k].numpy(), want[k]), k
        # the gate adds the same tables to the clustered ones
        monkeypatch.setenv(GATE, "1")
        c = prepare_clustered(tlas, "cpu")
        for k in want:
            assert torch.equal(c[k], got[k]), k
        monkeypatch.setenv(GATE, "0")
        assert "res_meta" not in prepare_clustered(tlas, "cpu")


@pytest.fixture(scope="module")
def sphere_case(tmp_path_factory):
    """Tables of the sphere BLAS, 512 rays from around and inside it with
    dead lanes and finite tmax, and the reference's closest hits and
    occlusion (interpret mode)."""
    h = _sphere_blas()[0]
    tlas = j_build_tlas([h], [(0, np.eye(4))])
    dev_c = {**pc.prepare_clustered(tlas), **pr.prepare_resident(tlas)}
    c = {**prepare_clustered(tlas, "cpu"), **resident.prepare_resident(tlas, "cpu")}
    rng = np.random.default_rng(3)
    o = rng.normal(size=(512, 3)).astype(np.float32)
    o *= rng.choice([0.6, 1.5, 3.0], size=(512, 1)).astype(np.float32) \
        / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d[:128] = -o[:128] / np.linalg.norm(o[:128], axis=-1, keepdims=True)
    tmax = np.full(512, 1e9, np.float32)
    short = rng.uniform(size=512) < 0.1
    tmax[short] = rng.uniform(0.2, 2.0, short.sum()).astype(np.float32)
    tmax[rng.uniform(size=512) < 0.2] = -1.0
    tmax[:4] = 0.0
    rays = torch.as_tensor(np.ascontiguousarray(np.concatenate([o.T, d.T, tmax[None]])))

    def reference():
        args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
        want = pr.intersect_closest_resident(dev_c, *args)
        occ = pr.intersect_any_resident(dev_c, *args)
        return {**{k: np.asarray(v) for k, v in want.items()}, "occ": np.asarray(occ)}

    want = cached(tmp_path_factory, "resident_traversal",
                  (rays.numpy(), {k: np.asarray(v) for k, v in dev_c.items()}), reference)
    want_occ = want.pop("occ")
    return c, rays, want, want_occ


def test_closest_twin_matches_reference(sphere_case):
    c, rays, want, _ = sphere_case
    _build.LAUNCHES.clear()
    got = {k: v.numpy() for k, v in resident.intersect_closest_resident(c, rays).items()}
    assert _build.LAUNCHES == {"resident_closest_twin": 1}
    assert "slot" not in got and (got["inst"] == 0).all()
    hit = got["prim"] >= 0
    np.testing.assert_array_equal(got["hit"], hit)
    np.testing.assert_array_equal(hit, want["hit"])
    dead = rays[6].numpy() <= 0.0
    assert 0.15 < dead.mean() < 0.3 and hit.any() and (~hit & ~dead).any()
    assert not hit[dead].any()
    same = hit & (got["prim"] == want["prim"])
    tie = hit & ~same
    rel_t = np.abs(got["t"] - want["t"]) / np.maximum(np.abs(want["t"]), 1.0)
    assert (rel_t[tie] <= 1e-6).all(), "a different prim away from a tie"
    assert tie.sum() <= 2, f"{tie.sum()} near-tie lanes"
    np.testing.assert_allclose(got["t"][same], want["t"][same], rtol=1e-5, atol=0.0)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=0.0, atol=1e-5, err_msg=k)
    # miss contract: prim = -1, u = v = 0, t = tmax
    np.testing.assert_array_equal(got["t"][~hit], rays[6].numpy()[~hit])
    np.testing.assert_array_equal(want["t"][~hit], rays[6].numpy()[~hit])
    assert (got["prim"][~hit] == -1).all()
    assert (got["u"][~hit] == 0).all() and (got["v"][~hit] == 0).all()
    # the stats the bound comes from: every live lane tests the first page
    stats = {}
    resident.intersect_closest_twin(c, rays, stats)
    assert stats["page"] >= int((~dead).sum()) and stats["tri"] > 0
    assert 0 < stats["pages"] <= resident._n_pages(c)
    # with the span gate every live lane tests every span box, and only
    # the page boxes of the spans it passes
    assert stats["page"] == int((~dead).sum()) * resident._n_pages(c)
    assert stats["span"] == int((~dead).sum()) * c["res_span"].shape[0]
    assert 0 < stats["page_in_span"] < stats["page"]
    # the bytes: each entry read once; prim at each distinct final hit,
    # whose triangle was tested
    read = {k: v.numpy() for k, v in stats["read"].items()}
    assert read["prim"].sum() == len(np.unique(got["prim"][hit]))
    assert not (read["prim"] & ~read["tri"]).any()
    assert read["page_box"].sum() <= stats["pages"] + 1 and read["cl_box"].sum() > 0
    rows = {"page_box": 6, "cl_count": 1, "cl_box": 6, "grp_box": 6, "tri": 9, "prim": 1}
    assert stats["table_bytes"] == 4 * (6 + sum(r * int(read[k].sum()) for k, r in rows.items()))
    assert stats["table_bytes"] < 4 * (c["res_meta"].numel() + c["blocks"].numel())
    assert not (read["page_box_in_span"] & ~read["page_box"]).any()
    rows = {**rows, "page_box": 0, "span_box": 6, "page_box_in_span": 6}
    assert stats["span_table_bytes"] == 4 * (6 + sum(r * int(read[k].sum())
                                                     for k, r in rows.items()))


def test_any_twin_matches_reference(sphere_case):
    c, rays, want, want_occ = sphere_case
    _build.LAUNCHES.clear()
    occ = resident.intersect_any_resident(c, rays)
    assert occ.dtype == torch.bool and _build.LAUNCHES == {"resident_any_twin": 1}
    np.testing.assert_array_equal(occ.numpy(), want_occ)
    np.testing.assert_array_equal(occ.numpy(), want["hit"])
    # any-hit counts its triangle tests to each lane's first occluder
    s_any, s_cl = {}, {}
    resident.intersect_any_twin(c, rays, s_any)
    resident.intersect_closest_twin(c, rays, s_cl)
    assert 0 < s_any["tri"] < s_cl["tri"]
    assert not s_any["read"]["prim"].any() and s_any["read"]["tri"].any()


def test_resident_records_byte_equal():
    for h in (_sphere_blas()[0], _partial_page_blas()):
        tlas = j_build_tlas([h], [(0, np.eye(4))])
        c = {**prepare_clustered(tlas, "cpu"), **resident.prepare_resident(tlas, "cpu")}
        meta = c["res_meta"].numpy()
        page, span = c["res_page"].numpy(), c["res_span"].numpy()
        n_pages = resident._n_pages(c)
        assert page.shape == (n_pages, 1 + resident.P_CL, 8)
        first = np.arange(n_pages) * resident.P_CL
        assert _same(page[:, 0, 0:3], np.ascontiguousarray(meta[8:11, first].T))
        assert _same(page[:, 0, 4:7], np.ascontiguousarray(meta[11:14, first].T))
        cl = page[:, 1:].reshape(-1, 8)
        k = cl.shape[0]
        for words, rows in ((slice(0, 3), slice(0, 3)), (slice(3, 4), slice(6, 7)),
                            (slice(4, 7), slice(3, 6))):
            assert _same(cl[:, words], np.ascontiguousarray(meta[rows, :k].T))
        assert not page[:, :, 7].any() and not page[:, 0, 3].any()
        # a span holds the union of its pages' boxes
        assert span.shape == (-(-n_pages // resident.SPAN), 8)
        for s_ in range(span.shape[0]):
            boxes = page[s_ * resident.SPAN:(s_ + 1) * resident.SPAN, 0]
            assert _same(span[s_, 0:3], boxes[:, 0:3].min(0))
            assert _same(span[s_, 4:7], boxes[:, 4:7].max(0))
        # the group and triangle records the kernel reads for each cluster
        # with triangles: the blocks' columns
        blocks = c.get("res_blocks", c["blocks"]).numpy()
        grp, tri = c["grp_rec"].numpy(), c["tri_rec"].numpy()
        for cid in np.nonzero(meta[6] > 0)[0]:
            cols = cid * 128 + np.arange(8)
            g = grp[cid * 8:(cid + 1) * 8]
            assert _same(g[:, 0:3], np.ascontiguousarray(blocks[10:13, cols].T))
            assert _same(g[:, 4:7], np.ascontiguousarray(blocks[13:16, cols].T))
            slots = cid * 128 + np.arange(int(meta[6, cid]))
            t_ = tri[slots]
            for words, rows in ((slice(0, 3), slice(0, 3)), (slice(3, 4), slice(9, 10)),
                                (slice(4, 7), slice(3, 6)), (slice(8, 11), slice(6, 9))):
                assert _same(t_[:, words], np.ascontiguousarray(blocks[rows, slots].T))


_F = np.float32


def _slab_np(box, o, inv, best):
    """common.cuh `slab_box` on a record (lo.xyz, w, hi.xyz, w), float32."""
    t1 = [(box[k] - o[k]) * inv[k] for k in range(3)]
    t2 = [(box[4 + k] - o[k]) * inv[k] for k in range(3)]
    tn = max(max(min(t1[0], t2[0]), min(t1[1], t2[1])), min(t1[2], t2[2]))
    tf = min(min(max(t1[0], t2[0]), max(t1[1], t2[1])), max(t1[2], t2[2]))
    return tn <= tf and tf >= 0 and tn <= best


def _mt_np(o, d, rec):
    """common.cuh `moller_trumbore` of one ray against triangle records
    [n, 12] (v0, prim, e1, 0, e2, 0), float32 in its order: t, u, v and
    valid, each [n]."""
    v0, e1, e2 = rec[:, 0:3].T, rec[:, 4:7].T, rec[:, 8:11].T
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    ok = np.abs(det) > _F(1e-12)
    inv_det = np.divide(_F(1), det, out=np.zeros_like(det), where=ok)
    tx, ty, tz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    u = (tx * px + ty * py + tz * pz) * inv_det
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    return t, u, v, ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)


def _root_clamp(c, o, inv):
    """common.cuh `root_exit_clamp`, float32."""
    root = c["root_aabb"].numpy()[:, 0]
    t1 = [(root[k] - o[k]) * inv[k] for k in range(3)]
    t2 = [(root[3 + k] - o[k]) * inv[k] for k in range(3)]
    rtn = max(max(min(t1[0], t2[0]), min(t1[1], t2[1])), min(t1[2], t2[2]))
    rtf = min(min(max(t1[0], t2[0]), max(t1[1], t2[1])), max(t1[2], t2[2]))
    return rtf * _F(1.0001) + _F(1e-4) if rtn <= rtf and rtf >= 0 else _F(0)


def _walk_lane(c, ray, any_hit):
    """One live lane through the kernel's records (csrc/resident.cu
    `k_resident`): its result (t, prim, u, v; any-hit: occluded), the
    pages and clusters whose boxes pass its gates, and its span box tests
    and page box tests in passing spans ({"span": n, "page_in_span": n})."""
    span, page = c["res_span"].numpy(), c["res_page"].numpy()
    grp, tri = c["grp_rec"].numpy(), c["tri_rec"].numpy()
    n_pages, p_cl, sp = page.shape[0], resident.P_CL, resident.SPAN
    o, d, tmax = ray[0:3], ray[3:6], ray[6]
    eps = _F(1e-12)
    inv = [_F(1) / (x if abs(x) >= eps else (-eps if x < 0 else eps)) for x in d]
    best, prim, bu, bv = min(tmax, _root_clamp(c, o, inv)), -1, _F(0), _F(0)
    pages, clusters, tests = set(), set(), {"span": 0, "page_in_span": 0}
    for s in range(-(-n_pages // sp)):
        tests["span"] += 1
        if not _slab_np(span[s], o, inv, best):
            continue
        for p in range(s * sp, min(n_pages, (s + 1) * sp)):
            tests["page_in_span"] += 1
            if not _slab_np(page[p, 0], o, inv, best):
                continue
            pages.add(p)
            for cl in range(p_cl):
                rec, cid = page[p, 1 + cl], p * p_cl + cl
                cnt = int(rec[3])
                if cnt <= 0 or not _slab_np(rec, o, inv, best):
                    continue
                clusters.add(cid)
                for g in range(-(-cnt // 16)):
                    if not _slab_np(grp[cid * 8 + g], o, inv, best):
                        continue
                    ks = np.arange(g * 16, min(cnt, g * 16 + 16))
                    t, u, v, ok = _mt_np(o, d, tri[cid * 128 + ks])
                    for q in range(ks.shape[0]):
                        if ok[q] and t[q] < best:
                            if any_hit:
                                return True, pages, clusters, tests
                            best, prim, bu, bv = t[q], int(tri[cid * 128 + ks[q], 3]), u[q], v[q]
    if any_hit:
        return False, pages, clusters, tests
    return (best if prim >= 0 else tmax, prim, bu, bv), pages, clusters, tests


@pytest.mark.parametrize("any_hit", [False, True])
def test_twin_block_stats_brute_force(sphere_case, any_hit):
    c, rays, _, _ = sphere_case
    stats = {}
    twin = (resident.intersect_any_twin if any_hit else resident.intersect_closest_twin)(
        c, rays, stats)
    r = rays.numpy()
    m = r.shape[1]
    # the kernel's blocks: tile i // TILE goes to block tile % n_blocks
    n_blocks = -(-m // resident.RES_BLOCK)
    assert n_blocks > 1
    blk_pages, blk_clusters = [0] * n_blocks, [0] * n_blocks
    lane_pages, lane_clusters = [0] * m, [0] * m
    tests = {"span": 0, "page_in_span": 0}
    for i in range(m):
        if not r[6, i] > 0:
            res = False if any_hit else (r[6, i], -1, _F(0), _F(0))
        else:
            b = (i // resident.TILE) % n_blocks
            res, pages, clusters, n = _walk_lane(c, r[:, i], any_hit)
            lane_pages[i], lane_clusters[i] = len(pages), len(clusters)
            blk_pages[b] += len(pages)
            blk_clusters[b] += len(clusters)
            for k in tests:
                tests[k] += n[k]
        # bit-equal to the twin lane by lane
        assert _same_result(twin, i, res, any_hit), i
    assert len(set(lane_pages)) > 2 and all(blk_pages)
    assert stats["per_block"]["pages"].tolist() == blk_pages
    assert stats["per_block"]["clusters"].tolist() == blk_clusters
    assert stats["per_lane"]["pages"].tolist() == lane_pages
    assert stats["per_lane"]["clusters"].tolist() == lane_clusters
    assert {k: stats[k] for k in tests} == tests


def _same_result(twin, i, res, any_hit) -> bool:
    if any_hit:
        return bool(twin[i]) == res
    got = [twin[k][i].item() for k in ("t", "prim", "u", "v")]
    return got == [float(res[0]), res[1], float(res[2]), float(res[3])]


def _walk_warp(c, ray, any_hit, group_retest=True):
    """One ray through the kernel's warp walk (csrc/resident.cu `walk`):
    64 spans, then a span's 32 (page, cluster) slots, then a cluster's
    groups and their triangles, each level tested at once at the best t
    of that moment; each candidate tested again in cid order at the best
    t of its turn (a page at its first candidate cluster); a group's
    triangles reduced to their first (t, index) minimum. Returns (t, prim,
    u, v), or occluded. group_retest=False leaves out the group's test in
    turn (a walk that would not be exact)."""
    span, page = c["res_span"].numpy(), c["res_page"].numpy()
    grp, tri = c["grp_rec"].numpy(), c["tri_rec"].numpy()
    n_pages, sp = page.shape[0], resident.SPAN
    n_spans = -(-n_pages // sp)
    o, d, tmax = ray[0:3], ray[3:6], ray[6]
    eps = _F(1e-12)
    inv = [_F(1) / (x if abs(x) >= eps else (-eps if x < 0 else eps)) for x in d]
    best = min(tmax, _root_clamp(c, o, inv))
    prim, bu, bv = -1, _F(0), _F(0)
    for s0 in range(0, n_spans, 64):
        spans = [s for s in range(s0, min(n_spans, s0 + 64)) if _slab_np(span[s], o, inv, best)]
        for s in spans:
            if not _slab_np(span[s], o, inv, best):
                continue
            slots = [ln for ln in range(32) if s * sp + ln // 4 < n_pages
                     and page[s * sp + ln // 4, 1 + ln % 4, 3] > 0
                     and _slab_np(page[s * sp + ln // 4, 0], o, inv, best)
                     and _slab_np(page[s * sp + ln // 4, 1 + ln % 4], o, inv, best)]
            page_in, skip = -1, -1
            for cs in slots:
                p, rec = s * sp + cs // 4, page[s * sp + cs // 4, 1 + cs % 4]
                if cs // 4 == skip:
                    continue
                if cs // 4 != page_in:
                    page_in = cs // 4
                    if not _slab_np(page[p, 0], o, inv, best):
                        skip = page_in
                        continue
                if not _slab_np(rec, o, inv, best):
                    continue
                cnt, cid = int(rec[3]), s * 32 + cs
                groups = [g for g in range(-(-cnt // 16)) if _slab_np(grp[cid * 8 + g], o, inv,
                                                                       best)]
                ks = np.asarray([k for k in range(cnt) if k // 16 in groups], np.int64)
                if ks.size == 0:
                    continue
                t, u, v, ok = _mt_np(o, d, tri[cid * 128 + ks])
                if any_hit:
                    if (ok & (t < best)).any():
                        return True
                    continue
                for g in groups:
                    if group_retest and not _slab_np(grp[cid * 8 + g], o, inv, best):
                        continue
                    cand = [(t[q], ks[q], q) for q in range(ks.size)
                            if ks[q] // 16 == g and ok[q] and t[q] < best]
                    if cand:
                        _, k, q = min(cand)
                        best, prim, bu, bv = t[q], int(tri[cid * 128 + k, 3]), u[q], v[q]
    if any_hit:
        return False
    return best if prim >= 0 else tmax, prim, bu, bv


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_warp_walk_matches_twin(sphere_case, any_hit):
    """The kernel's walk order (levels tested at once, candidates tested
    again in turn) gives the twin's bits, lane by lane."""
    c, rays, _, _ = sphere_case
    twin = (resident.intersect_any_twin if any_hit else resident.intersect_closest_twin)(c, rays)
    r = rays.numpy()
    for i in range(r.shape[1]):
        if not r[6, i] > 0:
            res = False if any_hit else (r[6, i], -1, _F(0), _F(0))
        else:
            res = _walk_warp(c, r[:, i], any_hit)
        assert _same_result(twin, i, res, any_hit), i


def test_kernel_warp_walk_coplanar_layers():
    """Where the in-turn group test decides results (tools/resident_steps.py
    `retest_case`: coplanar layers in two groups of one cluster, hits a
    few ulps apart), the kernel's walk gives the twin's bits, and without
    that test it does not. The span, page and cluster tests in turn only
    skip work: their boxes nest (span > page > cluster > group, each the
    float min/max of the next), so a box that fails at the best t of the
    moment fails the group test at once behind it too."""
    c, rays = retest_case("cpu")
    r = rays.numpy()
    twin = resident.intersect_closest_twin(c, rays)
    occ = resident.intersect_any_twin(c, rays)
    assert bool(occ.all()) and bool(twin["hit"].all())
    assert len(set(twin["prim"].tolist())) > 4
    decided = 0
    for i in range(r.shape[1]):
        assert _same_result(twin, i, _walk_warp(c, r[:, i], False), False), i
        assert _same_result(occ, i, _walk_warp(c, r[:, i], True), True), i
        decided += not _same_result(twin, i, _walk_warp(c, r[:, i], False, False), False)
    assert decided >= 10, decided


def _emissive_spheres():
    """A clustered scene (three spheres, 2,976 faces) under a small
    emissive quad: two area lights, so the fused pipeline's light block
    rides the closest-hit trace."""
    parts, mats = [], []
    for i, x in enumerate((-1.05, 0.0, 1.05)):
        v, n, t, f = uv_sphere([x, 0.45, 0.0], 0.45)
        parts.append((v, n, t, f, np.full(len(f), i, np.int32)))
        mats.append(Material(metalness=0.5 * i, specular_roughness=0.3))
    v, n, t, f = _quad([-0.4, 1.6, -0.4], [0.4, 1.6, -0.4], [0.4, 1.6, 0.4], [-0.4, 1.6, 0.4])
    parts.append((v, n, t, f, np.full(2, 3, np.int32)))
    mats.append(Material(emission=1.0, emission_color=(6.0, 6.0, 6.0)))
    v, n, t, f = _quad([-3, 0, -3], [-3, 0, 3], [3, 0, 3], [3, 0, -3])
    parts.append((v, n, t, f, np.full(2, 4, np.int32)))
    mats.append(Material(base_color=(0.5, 0.5, 0.5), specular=0.0))
    return _scene(parts, mats)


def _render(r, **kw):
    _build.LAUNCHES.clear()
    r.render(**kw)
    return {k: v.clone() for k, v in r.layers.items()}, dict(_build.LAUNCHES)


def test_routing(monkeypatch):
    spp, depth = 2, 3
    monkeypatch.setenv(GATE, "1")
    r = _metal_row(Renderer, device="cpu")
    assert "res_meta" in r._dev["clusters"]
    assert wavefront._use_resident(r._dev, coherent=False)
    assert not wavefront._use_resident(r._dev, coherent=True)
    _, n = _render(r, n_samples=spp, max_depth=depth)
    # B4 and the slot fetch at d = 0 only; B7 at d > 0 and the final stage
    assert n["clustered_closest_twin"] == n["slot_fetch_twin"] == spp
    assert n["resident_closest_twin"] == (depth - 1) * spp
    assert n["resident_any_twin"] == depth * spp
    assert "clustered_any_twin" not in n
    # the wavefront's traces are coherent: never B7
    r.use_fused = False
    _, n = _render(r, n_samples=1, max_depth=depth)
    assert n["clustered_closest_twin"] > 0 and n["clustered_any_twin"] > 0
    assert not any(k.startswith("resident") for k in n)
    # two instances: no resident tables
    v, _, _, f = uv_sphere([0, 0, 0], 1.0)
    v0, e1, e2 = v[f[:, 0]], v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    h = extract_hierarchy(build_bvh(lo, hi), v0, e1, e2)
    m_b = np.eye(4, dtype=np.float32)
    m_b[:3, 3] = [3.0, 0.0, 0.0]
    c2 = prepare_clustered(build_tlas([h], [(0, np.eye(4, dtype=np.float32)), (0, m_b)]), "cpu")
    assert "res_meta" not in c2 and not resident.routes(c2, coherent=False)
    # emissive faces: the light block's hits by prim (B7) or by slot (B4)
    layers = {}
    for gate in ("1", "0"):
        monkeypatch.setenv(GATE, gate)
        r = Renderer(16, 16, device="cpu")
        r.set_scene(_emissive_spheres())
        r.camera.origin = np.asarray([0.0, 0.9, 2.6], np.float32)
        r.camera._update_transform()
        assert r._dev["n_lights"] == 2 and r._params(depth)["use_fused"]
        layers[gate], n = _render(r, n_samples=spp, max_depth=depth)
        assert ("resident_closest_twin" in n) == (gate == "1")
    assert float(layers["1"]["beauty"].max()) > 0
    for k in layers["0"]:
        assert torch.equal(layers["1"][k], layers["0"][k]), k
    monkeypatch.setenv(GATE, "0")
    assert "res_meta" not in _metal_row(Renderer, device="cpu")._dev["clusters"]


def test_metal_row_gate_on_matches_reference(monkeypatch, tmp_path_factory):
    want = _metal_row_reference(tmp_path_factory)
    monkeypatch.setenv(GATE, "1")
    t = _metal_row(Renderer, device="cpu")
    got, n = _render(t, n_samples=2, max_depth=3)
    assert n["resident_closest_twin"] > 0 and n["resident_any_twin"] > 0
    for key in LAYERS:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=2e-4, atol=2e-4,
                                   err_msg=key)
    assert float(got["n_path_vertices"]) == float(want["n_path_vertices"]) > 0


def test_compaction(monkeypatch):
    rng = np.random.default_rng(5)
    alive = rng.uniform(size=1000) < 0.3
    want = np.asarray(j_compact.partition_dest(jnp.asarray(alive)))
    got = compact.partition_dest(torch.as_tensor(alive)).numpy()
    assert _same(got, want)
    assert [compact.enabled(m, dense) for m in compact.MODES for dense in (True, False)] \
        == [False, False, True, True, False, True]
    monkeypatch.setenv(GATE, "1")
    for make in (lambda: _metal_row(Renderer, device="cpu"), _cornell_8):
        layers = {}
        for mode in ("1", "0"):
            monkeypatch.setenv(compact.ENV, mode)
            r = make()
            assert r._params(3)["compact"] == mode
            layers[mode], _ = _render(r, n_samples=2, max_depth=3)
        for k in layers["0"]:
            assert torch.equal(layers["1"][k], layers["0"][k]), k


def _cornell_8():
    r = Renderer(8, 8, device="cpu")
    r.set_scene(cornell_box())
    r.camera.origin = np.asarray([0.0, 1.0, 0.6], np.float32)
    r.camera._update_transform()
    return r
