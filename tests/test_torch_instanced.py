"""Instanced scenes, port against reference (fredholm_tpu/scene/types.py
`InstancedScene`, scene/device.py `build_instanced_device_scene` and
`update_instance_transforms`, accel/cluster.py `update_tlas_instances`,
fused/pt_fused.py `_xform_attrs_cols`):

- the host tables of `instance_test(n=3)` (also with its pedestal
  emissive) and `instanced_tiles(grid=2, tile_n=8, size=4.0)` byte-equal
  to the reference's, its BVH built by
  its numpy builder (`build_bvh(..., prefer_native=False)`, the builder
  the port copies; patched where the reference's device module imports
  it), and again after a move with a rotation and a non-uniform scale;
  `dev_from_reference` carries the reference's tables across unchanged,
  the device's slot rows the host's slot table slot-major, bit for bit;
- the hit-attribute transform twin against `_xform_attrs_cols` on seeded
  planes at rtol = atol = 1e-6 (XLA:CPU may contract the affine rows'
  products into FMAs; the twin rounds each once, as the kernel does);
  the CPU fetch on the row table equal to the twin after the reference's
  fetch of the plane-major table;
- `Renderer(device="cpu")` renders `instanced_tiles(grid=2, tile_n=8)`
  under a sun like the reference `Renderer` (16x16, 2 spp, depth 3): six
  layers at rtol = atol = 2e-4, path vertices exactly, through the
  instanced slot fetch; a pixel may differ beyond that only where a ray
  meets a near-tie (the traversal tests' allowance,
  test_torch_clustered.py), at most one, within 1%;
- moving the placements and rendering equals a fresh upload of the moved
  scene, bit for bit;
- the envelope: the wavefront integrator raises on an instanced scene,
  and so does alpha cutout at `set_scene`.
"""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fredholm_tpu.accel.bvh import build_bvh as j_build_bvh
from fredholm_tpu.fused import pt_fused as jpf
from fredholm_tpu.fused.slot_fetch import build_slot_attrs as j_slot_attrs
from fredholm_tpu.fused.slot_fetch import fetch_geom_by_slot as j_fetch
from fredholm_tpu.renderer import Renderer as JRenderer
from fredholm_tpu.scene import device as jdev
from fredholm_tpu.scene import procedural as jproc
from fredholm_tpu_torch import Renderer, _build
from fredholm_tpu_torch.fused import slot_fetch as tsf
from fredholm_tpu_torch.scene import device as tdev
from fredholm_tpu_torch.scene import procedural as tproc
from fredholm_tpu_torch.scene.types import InstancedScene, TextureImage

from test_torch_cache import cached, release_compiled_programs  # noqa: F401 (autouse)

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

LAYERS = ("beauty", "position", "normal", "depth", "texcoord", "albedo")
TLAS_FIELDS = ("sc_aabb", "sc_mcount", "sc_order", "sc_key", "blocks", "inst_aabb",
               "inst_minv", "inst_sc", "reg_aabb")
TABLES = ("fused_table", "fused_mat_table", "light_table", "inst_table", "light_verts",
          "light_normals", "light_uvs", "light_mat", "face_verts", "face_normals",
          "face_uvs", "face_mat")


def _emissive_pedestals(m):
    """instance_test(n=3) with its pedestal emissive: every placement
    carries two world-space lights."""
    iscene = m.instance_test(n=3)
    mats = list(iscene.base.materials)
    mats[1] = dataclasses.replace(mats[1], emission=4.0, emission_color=(1.0, 0.9, 0.8))
    iscene.base.materials = mats
    return iscene


SCENES = {
    "instance_test": (lambda m: m.instance_test(n=3)),
    "emissive": _emissive_pedestals,
    "tiles": (lambda m: m.instanced_tiles(grid=2, tile_n=8, size=4.0)),
}


def _numpy_bvh(lo, hi, **kw):
    return j_build_bvh(lo, hi, prefer_native=False, **kw)


def _reference_build(iscene):
    with mock.patch.object(jdev, "build_bvh", _numpy_bvh):
        return jdev.build_instanced_device_scene(iscene)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _moves(n: int):
    """A 4x4 for each of n placements: a rotation about an oblique axis
    with a non-uniform scale and a translation, one a placement."""
    out = []
    for i in range(n):
        a = 0.4 + 0.7 * i
        c, s = np.cos(a), np.sin(a)
        rot = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ \
            np.asarray([[1, 0, 0], [0, np.cos(0.3), -np.sin(0.3)], [0, np.sin(0.3), np.cos(0.3)]])
        m = np.eye(4)
        m[:3, :3] = rot @ np.diag([1.0 + 0.1 * i, 0.6, 1.3])
        m[:3, 3] = (1.5 * i - 1.0, 0.2 * i, -0.5 * i)
        out.append(m.astype(np.float32))
    return out


def _check_tables(port, ref, port_clusters, ref_clusters):
    for k in TABLES:
        assert _same(port[k], ref[k]), k
    for k in ("n_lights", "n_faces"):
        assert port[k] == ref[k], k
    for k in TLAS_FIELDS + ("root_aabb",):
        assert _same(port_clusters[k], ref_clusters[k]), k
    n_sc = np.asarray(ref_clusters["sc_mcount"]).shape[0]
    assert _same(port_clusters["cl_meta"], np.asarray(ref_clusters["cl_meta"])[:, :n_sc * 128])


def _tlas_tables(tlas, clusters):
    """A TLAS's tables beside the root box its prepared tables carry; the
    prepared instance entries are the TLAS's own."""
    for k in ("inst_aabb", "inst_minv", "inst_sc"):
        assert _same(clusters[k].numpy(), getattr(tlas, k)), k
    return {**{k: getattr(tlas, k) for k in TLAS_FIELDS + ("cl_meta",)},
            "root_aabb": clusters["root_aabb"].numpy()}


def _np(d):
    return {k: (_np(v) if isinstance(v, dict) else np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in d.items()}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_host_tables_byte_equal(name):
    """Scene, upload tables, TLAS, slot table; and the reference's tables
    carried across by dev_from_reference are the port's own."""
    iscene = SCENES[name](tproc)
    jscene = SCENES[name](jproc)
    for k in ("vertices", "normals", "texcoords", "indices", "material_ids"):
        assert _same(getattr(iscene.base, k), getattr(jscene.base, k)), k
    assert all(_same(a.transform, b.transform) and a.submesh == b.submesh
               for a, b in zip(iscene.instances, jscene.instances))
    host = tdev.build_instanced_host_tables(iscene)
    ref = _np(_reference_build(jscene))
    tlas = host["tlas"]
    _check_tables(host, ref, _tlas_tables(tlas, tdev.prepare_clustered(tlas, "cpu")),
                  ref["clusters"])
    assert tlas.inst_identity == ref["_inst_identity"]
    assert host["n_lights"] == (6 if name == "emissive" else 0)
    ref_slots = j_slot_attrs(ref, ref["clusters"]["blocks"][9])
    assert _same(host["slot_attrs"], ref_slots)
    if "slot_attrs" in ref:
        assert _same(ref["slot_attrs"], ref_slots)

    port = tdev.build_instanced_device_scene(iscene, "cpu")
    # the device's slot table: the host's slot-major, bit for bit
    assert "slot_attrs" not in port and port["slot_rows"].is_contiguous()
    assert _same(port["slot_rows"].numpy(), np.ascontiguousarray(ref_slots.T))
    carried = tdev.dev_from_reference(ref, "cpu")
    assert set(carried) == set(port) - {"_host"}
    for k, v in carried.items():
        if isinstance(v, dict):
            assert set(v) == set(port[k]), k
            for name_, x in v.items():
                assert (torch.equal(x, port[k][name_]) if isinstance(x, torch.Tensor)
                        else x == port[k][name_]), (k, name_)
        elif isinstance(v, torch.Tensor):
            assert torch.equal(v, port[k]), k
        else:
            assert v == port[k], k


@pytest.mark.parametrize("name", sorted(SCENES))
def test_moved_tables_byte_equal(name):
    """update_instance_transforms: the TLAS's instance entries, root box,
    inst_table and lights equal the reference's after a move, and the
    kernels' instance records equal a fresh upload's."""
    iscene = SCENES[name](tproc)
    moves = _moves(len(iscene.instances))
    port = tdev.update_instance_transforms(tdev.build_instanced_device_scene(iscene, "cpu"),
                                           moves)
    ref = _np(jdev.update_instance_transforms(_reference_build(SCENES[name](jproc)), moves))
    tables = {k: port[k].numpy() for k in TABLES}
    _check_tables({**tables, "n_lights": port["n_lights"], "n_faces": port["n_faces"]}, ref,
                  _tlas_tables(port["_host"]["tlas"], port["clusters"]), ref["clusters"])
    assert port["clusters"]["identity"] is False
    fresh = tdev.build_instanced_device_scene(dataclasses.replace(
        iscene, instances=port["_host"]["scene"].instances), "cpu")
    for k, v in fresh["clusters"].items():
        got = port["clusters"][k]
        assert torch.equal(got, v) if isinstance(v, torch.Tensor) else got == v, k


def test_xform_twin_matches_reference():
    """The transform twin against `_xform_attrs_cols` on seeded planes;
    the CPU wrapper is the plain fetch followed by the twin."""
    rng = np.random.default_rng(15)
    n, n_inst = 4096, 5
    planes = rng.uniform(-3.0, 3.0, (26, n)).astype(np.float32)
    planes[:, :64] = 0.0  # misses: zero planes
    inst = rng.integers(-1, n_inst + 1, n).astype(np.int32)  # clamped at both ends
    inst[:64] = 0
    table = tdev.instance_table([(0, m) for m in _moves(n_inst)])
    got = tsf.xform_twin(torch.from_numpy(planes), torch.from_numpy(inst),
                         torch.from_numpy(table)).numpy()
    attrs = {c: jnp.asarray(planes[c]) for c in range(26)}
    jpf._xform_attrs_cols({"inst_table": jnp.asarray(table)}, jnp.asarray(inst), attrs)
    want = np.stack([np.asarray(attrs[c]) for c in range(26)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # a miss sits at instance 0's origin with zero normals and area
    assert np.array_equal(got[0:9, 0], np.tile(table[0, [3, 7, 11]], 3))
    assert not got[9:18, :64].any() and not got[24, :64].any()

    # the CPU wrapper on the row table: the reference's fetch of the
    # plane-major table, then the twin; a slot past the table is a miss
    planes = rng.uniform(-1, 1, (32, 512)).astype(np.float32)
    slot = rng.integers(-1, 600, n).astype(np.int32)
    want = j_fetch({"slot_attrs": jnp.asarray(planes)}, jnp.asarray(np.where(slot < 512, slot, -1)))
    want = torch.from_numpy(np.stack([np.asarray(want[c]) for c in range(26)]))
    _build.LAUNCHES.clear()
    fetched = tsf.fetch_geom_by_slot(torch.from_numpy(tsf.slot_rows(planes)),
                                     torch.from_numpy(slot), torch.from_numpy(inst),
                                     torch.from_numpy(table))
    assert torch.equal(fetched, tsf.xform_twin(want, torch.from_numpy(inst),
                                               torch.from_numpy(table)))
    assert _build.LAUNCHES["slot_fetch_inst_twin"] == 1


def _setup(cls, iscene, **kw):
    r = cls(width=16, height=16, **kw)
    r.set_scene(iscene)
    r.camera.origin = np.asarray([0.0, 3.0, 7.0], np.float32)
    r.camera.look_around(0.0, -0.3)
    r.set_directional_light([2.0, 1.9, 1.8], [0.35, 0.75, 0.3], angle=0.5)
    r.set_bg_color((0.4, 0.5, 0.7))
    return r


@pytest.fixture(scope="module")
def port_render():
    r = _setup(Renderer, SCENES["tiles"](tproc), device="cpu")
    _build.LAUNCHES.clear()
    r.render(n_samples=2, max_depth=3)
    return r, dict(_build.LAUNCHES)


@pytest.fixture(scope="module")
def reference_layers(tmp_path_factory):
    def render():
        with mock.patch.object(jdev, "build_bvh", _numpy_bvh):
            j = _setup(JRenderer, SCENES["tiles"](jproc))
        j.use_pallas = False
        j.render(n_samples=2, max_depth=3)
        return {k: np.asarray(v) for k, v in j.layers.items()}

    return cached(tmp_path_factory, "instanced_tiles_layers", ("tiles2x8", 16, 2, 3), render)


def test_render_went_through_the_instanced_fetch(port_render):
    r, launches = port_render
    assert "inst_table" in r._dev and "tri_soa" not in r._dev
    assert r._dev["clusters"]["n_instances"] == 4 and not r._dev["clusters"]["identity"]
    # closest + fetch at every bounce, world space by the hits' instances
    assert launches["clustered_closest_twin"] == launches["slot_fetch_inst_twin"] == 2 * 3
    assert "slot_fetch_twin" not in launches


def test_slice_matches_reference(port_render, reference_layers):
    r, _ = port_render
    for key in LAYERS:
        got = r.layers[key].numpy()
        want = reference_layers[key]
        bad = ~np.isclose(got, want, rtol=2e-4, atol=2e-4)
        bad_px = bad.reshape(got.shape[0], -1).any(axis=1)
        assert bad_px.sum() <= (1 if key == "beauty" else 0), (key, np.nonzero(bad_px)[0])
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-4, err_msg=key)
    got = float(r.layers["n_path_vertices"])
    assert got == float(reference_layers["n_path_vertices"]) > 0


def test_moved_render_equals_fresh_upload():
    iscene = SCENES["tiles"](tproc)
    moves = _moves(len(iscene.instances))
    moved = _setup(Renderer, iscene, device="cpu")
    moved.render(n_samples=1, max_depth=2)
    moved.set_instance_transforms(moves)
    moved.render(n_samples=2, max_depth=3)
    fresh = _setup(Renderer, dataclasses.replace(
        iscene, instances=moved.scene.instances), device="cpu")
    fresh.render(n_samples=2, max_depth=3)
    for key in LAYERS + ("n_path_vertices",):
        assert torch.equal(moved.layers[key], fresh.layers[key]), key
    assert float(moved.layers["beauty"].mean()) > 1e-3


def test_instanced_envelope():
    r = _setup(Renderer, SCENES["tiles"](tproc), device="cpu")
    r.use_fused = False
    with pytest.raises(NotImplementedError, match="instanced"):
        r.render(n_samples=1, max_depth=2)
    iscene = SCENES["instance_test"](tproc)
    tex = np.full((4, 4, 4), 255, np.uint8)
    tex[..., 3] = 0
    base = dataclasses.replace(iscene.base, textures=[TextureImage(data=tex)], materials=[
        dataclasses.replace(iscene.base.materials[0], base_color_texture_id=0),
        iscene.base.materials[1]])
    with pytest.raises(NotImplementedError, match="alpha"):
        Renderer(8, 8, device="cpu").set_scene(InstancedScene(base, iscene.instances))
