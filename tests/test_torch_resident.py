"""The port's ray-resident traversal (B7), its gate and routing, and
wavefront compaction, against the reference.

- `prepare_resident` byte-equal to the reference's, on a mesh with whole
  pages and on one whose cluster count is not a multiple of P_CL (the
  padded triangle blocks).
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

from test_bvh import _sphere_blas
from test_torch_cache import cached
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
        assert sorted(got) == sorted(want) and ("res_blocks" in got) == padded
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
    assert 0 < stats["pages"] <= stats["block_pages"]
    assert stats["meta_cols"] == c["res_meta"].shape[1]
    # the bytes: each entry read once; prim at each distinct final hit,
    # whose triangle was tested
    read = {k: v.numpy() for k, v in stats["read"].items()}
    assert read["prim"].sum() == len(np.unique(got["prim"][hit]))
    assert not (read["prim"] & ~read["tri"]).any()
    assert read["page_box"].sum() <= stats["pages"] + 1 and read["cl_box"].sum() > 0
    rows = {"page_box": 6, "cl_count": 1, "cl_box": 6, "grp_box": 6, "tri": 9, "prim": 1}
    assert stats["table_bytes"] == 4 * (6 + sum(r * int(read[k].sum()) for k, r in rows.items()))
    assert stats["table_bytes"] < 4 * (c["res_meta"].numel() + c["blocks"].numel())


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
