"""The four BSDF lobes of the fused pipeline's full shading variant (coat,
transmission, sheen, diffuse_t) on the CPU, port against reference:

- the host scenes `furnace_sphere` and `sphere_grid_test` are byte-equal
  to the reference's;
- the port's `mega_body` matches the reference's (fredholm_tpu/fused/
  pt_fused.py:771) on the same captured planes, for `lobes_on` each new
  lobe alone and all seven, at the TOL of test_torch_shade.py. The planes
  come from the port's CPU pipeline on a Cornell box whose white faces
  and a sphere inside turn every lobe on, under the box's two area lights
  and a sun, so bounce 1 has lanes shading from inside a block;
- `Renderer(device="cpu")` renders like the reference `Renderer` (six
  layers at rtol = atol = 2e-4, path vertices exactly) at 16x16, 2 spp,
  depth 2 on the setups of five goldens (tools/gen_goldens.py):
  clear_coat, sheen, transmission_rough, diffuse_transmission and
  metal_rough_grid. The reference renders on its plain path, once a
  session (test_torch_cache.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from fredholm_tpu.fused import pt_fused as jpf
from fredholm_tpu.renderer import Renderer as JRenderer
from fredholm_tpu.scene import procedural as jproc
from fredholm_tpu.scene.types import Material as JMaterial
from fredholm_tpu_torch import Camera, Renderer, cornell_box
from fredholm_tpu_torch.accel.dense import intersect_closest
from fredholm_tpu_torch.fused import cbsdf, kernels
from fredholm_tpu_torch.fused import pt_fused as tpf
from fredholm_tpu_torch.scene import procedural as tproc
from fredholm_tpu_torch.scene.device import build_device_scene
from fredholm_tpu_torch.scene.types import Material

from test_torch_cache import cached_all, release_compiled_programs  # noqa: F401 (autouse)
from test_torch_shade import _compare, _to_jax

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

LAYERS = ("beauty", "position", "normal", "depth", "texcoord", "albedo")
NEW_LOBES = ("coat", "transmission", "sheen", "diffuse_t")


def _byte_equal(a, b):
    for f in ("vertices", "normals", "texcoords", "indices", "material_ids", "instance_ids",
              "transforms"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f
    assert list(a.submesh_offsets) == list(b.submesh_offsets)
    assert list(a.submesh_n_faces) == list(b.submesh_n_faces)
    assert [dataclasses.asdict(m) for m in a.materials] == \
        [dataclasses.asdict(m) for m in b.materials]


@pytest.mark.parametrize("name", ["furnace_sphere", "sphere_grid_test"])
def test_host_scene_is_byte_equal(name):
    if name == "furnace_sphere":
        got = tproc.furnace_sphere(Material(specular=0.0, coat=0.3))
        want = jproc.furnace_sphere(JMaterial(specular=0.0, coat=0.3))
    else:
        args = ("metalness", [0.0, 0.5, 1.0], "specular_roughness", [0.1, 0.6])
        got = tproc.sphere_grid_test(*args, base=Material(sheen=0.5), spacing=1.0)
        want = jproc.sphere_grid_test(*args, base=JMaterial(sheen=0.5), spacing=1.0)
    _byte_equal(got, want)


# ---------------------------------------------------------------------------
# mega_body on captured planes

W = H = 24
# every lobe on: coat, metal, specular, transmission, sheen, diffuse_t
# (subsurface on a thin wall) and diffuse_r
ALL_ON = Material(base_color=(0.7, 0.5, 0.3), coat=0.6, coat_roughness=0.3,
                  coat_color=(0.9, 0.8, 0.7), metalness=0.2, specular_roughness=0.3,
                  transmission=0.4, sheen=0.5, sheen_color=(0.8, 0.9, 1.0),
                  sheen_roughness=0.4, subsurface=0.5, thin_walled=1.0, diffuse_roughness=0.3)


def _lobe_scene():
    """The Cornell box (two area lights), its white faces (walls and both
    blocks) all-lobe, with an all-lobe sphere inside: 996 faces, traced
    densely."""
    box = cornell_box()
    v, n, t, f = tproc.uv_sphere([0.0, 0.45, -0.2], 0.35)
    mats = [ALL_ON] + list(box.materials[1:]) + [ALL_ON]
    parts = [(box.vertices, box.normals, box.texcoords, box.indices, box.material_ids),
             (v, n, t, f, np.full((len(f),), len(box.materials), np.int32))]
    return tproc._scene(parts, mats)


def _cfgs(lobes_on):
    kw = dict(width=W, height=H, max_depth=3, n_lights=2, lobes_on=tuple(lobes_on))
    return (tpf.FusedConfig(has_dl=True, **kw),
            jpf.FusedConfig(sky_mode=0, has_dl=True, **kw))


@pytest.fixture(scope="module")
def captured():
    """mega_body's calls of one sample of the port's CPU pipeline with
    every lobe on: (args, result) at d = 0, 1, 2."""
    dev = build_device_scene(_lobe_scene(), "cpu")
    assert dev["n_lights"] == 2 and dev["n_faces"] == 996
    cfg, _ = _cfgs(cbsdf.ALL_LOBES)
    cam = Camera(origin=np.asarray([0.0, 0.9, 1.2], np.float32))
    params = {"camera": cam.device_params("cpu"), "seed": 5,
              "bg_color": np.asarray([0.3, 0.4, 0.5], np.float32),
              "directional_light": {"le": np.asarray([2.0, 1.9, 1.8], np.float32),
                                    "dir": np.asarray([0.3, 0.9, 0.3], np.float32),
                                    "angle": np.float32(1.0)}}
    n = W * H
    sv, usv = tpf.pack_scalars(params, n, "cpu")
    rng = np.random.default_rng(23)
    n_spp = torch.as_tensor(rng.integers(0, 40, n).astype(np.int64))
    calls = []
    orig = tpf.mega_body

    def rec(*a):
        r = orig(*a)
        calls.append((a, r))
        return r

    tpf.mega_body = rec
    try:
        state, sidx, rays = kernels.raygen(cfg, sv, usv, n_spp)
        pending = None
        for d in range(cfg.max_depth):
            hits = intersect_closest(dev["tri_soa"], rays, rays.shape[1])
            state, rays, pending, _ = kernels.mega(cfg, d, sv, usv, dev, n_spp, sidx, state,
                                                   rays, pending, tpf.Traced(hits))
    finally:
        tpf.mega_body = orig
    return calls


def test_captured_planes_shade_from_inside(captured):
    """Bounce 1 has live lanes that hit a face from its back (the shading
    sees `entering` false)."""
    args, _ = captured[1]
    state, rhit, rattr = args[8], args[9], args[10]
    from fredholm_tpu_torch.fused.pt_fused import _attr3
    from fredholm_tpu_torch.fused.cvec import cross, dot

    fv0, fv1, fv2 = _attr3(rattr, "v0"), _attr3(rattr, "v1"), _attr3(rattr, "v2")
    back = dot(state["d"], cross(fv1 - fv0, fv2 - fv0)) >= 0.0
    inside = state["alive"] & rhit["hit"] & back
    assert int(inside.sum()) >= 5


@pytest.mark.parametrize("lobes", [(lobe,) for lobe in NEW_LOBES] + [cbsdf.ALL_LOBES],
                         ids=list(NEW_LOBES) + ["all"])
@pytest.mark.parametrize("d", [0, 1])
def test_mega_body_matches_per_lobe(captured, lobes, d):
    args, _ = captured[d]
    assert args[1] == d
    tcfg, jcfg = _cfgs(lobes)
    got = tpf.mega_body(tcfg, *args[1:])
    want = jpf.mega_body(jcfg, *_to_jax(args[1:]))
    _compare(got, want)
    assert float(got[2]["tpf"].x.abs().max()) > 0.0


# ---------------------------------------------------------------------------
# whole renders against the reference


def _golden(name, cls):
    """The golden's setup (tools/gen_goldens.py) at 16x16 for the port
    (cls Renderer, on the CPU) or the reference (JRenderer)."""
    port = cls is Renderer
    proc, M = (tproc, Material) if port else (jproc, JMaterial)
    r = cls(width=16, height=16, **({"device": "cpu"} if port else {}))
    sun = None
    at = (0.0, 0.6, 1.8)
    if name == "clear_coat":
        scene = proc.sphere_array_test("coat_roughness", [0.05, 0.6],
                                       base=M(coat=1.0, base_color=(0.6, 0.1, 0.1)), spacing=1.05)
        bg = (0.7, 0.75, 0.8)
    elif name == "sheen":
        scene = proc.sphere_array_test("sheen", [0.3, 1.0], base=M(
            base_color=(0.2, 0.2, 0.5), sheen_color=(0.9, 0.9, 0.9)), spacing=1.05)
        sun, bg = ((3, 3, 3), (0.3, 1.0, 0.4), 1.0), (0.1, 0.1, 0.12)
    elif name == "transmission_rough":
        scene = proc.sphere_array_test("specular_roughness", [0.05, 0.5],
                                       base=M(transmission=1.0, diffuse=0.0), spacing=1.05)
        bg = (0.9, 0.6, 0.3)
    elif name == "diffuse_transmission":
        scene = proc.sphere_array_test("subsurface", [0.0, 1.0], base=M(thin_walled=1.0),
                                       spacing=1.05)
        sun, bg = ((4, 4, 4), (-0.2, 1.0, -0.5), 2.0), (0.05, 0.05, 0.05)
    else:
        scene = proc.sphere_grid_test("metalness", [0.0, 0.5, 1.0], "specular_roughness",
                                      [0.1, 0.6], spacing=1.0)
        at, bg = (0.0, 1.2, 3.4), (0.5, 0.6, 0.7)
    r.set_scene(scene)
    r.camera.origin = np.asarray(at, np.float32)
    r.camera._update_transform()
    if sun is not None:
        r.set_directional_light(sun[0], sun[1], angle=sun[2])
    r.set_bg_color(bg)
    return r


GOLDENS = {"clear_coat": "coat", "sheen": "sheen", "transmission_rough": "transmission",
           "diffuse_transmission": "diffuse_t", "metal_rough_grid": "metal"}
KW = dict(n_samples=2, max_depth=2)


def _reference(name):
    j = _golden(name, JRenderer)
    j.use_pallas = False
    cfg = j._config(1, KW["max_depth"])
    assert cfg.use_fused and GOLDENS[name] in cfg.lobes_on
    return j


def _port(name):
    t = _golden(name, Renderer)
    assert t._params(KW["max_depth"])["use_fused"] and GOLDENS[name] in t._lobes
    cfg = tpf.make_config(t._dev, t._params(KW["max_depth"]))
    assert kernels.mega_variant(cfg) == ("rich" if name == "metal_rough_grid" else "full")
    return t


def _layers(r):
    r.render(**KW)
    return {k: np.asarray(r.layers[k]) for k in r.layers}


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """{name: (port layers, reference layers)} of the five setups, each
    rendered once a session. One request for all ten entries: a worker
    computes the entries no other worker holds before it waits on one."""
    entries = []
    for name in GOLDENS:
        entries.append((f"lobes_{name}", sorted(KW.items()),
                        lambda name=name: _layers(_reference(name))))
        entries.append((f"lobes_{name}_port", sorted(KW.items()),
                        lambda name=name: _layers(_port(name))))
    out = cached_all(tmp_path_factory, entries)
    return {name: (out[2 * k + 1], out[2 * k]) for k, name in enumerate(GOLDENS)}


@pytest.mark.parametrize("key", LAYERS)
@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden_setup_matches_reference(renders, name, key):
    got, want = renders[name]
    np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=2e-4, err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden_setup_path_vertices_match(renders, name):
    got, want = renders[name]
    assert float(got["n_path_vertices"]) == float(want["n_path_vertices"]) > 0, name
