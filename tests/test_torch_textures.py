"""Textured materials in the fused pipeline on the CPU, port against
reference (fredholm_tpu/scene/texture.py, fredholm_tpu/fused/pt_fused.py
`fetch_texture_planes`, `_apply_tex_overrides`, `emission_from_attrs`
and the bump / normal mapping of `mega_body`):

- `pack_textures` and `texture_headers_np` byte-equal on a checker, the
  normal map, a 3-channel texture, a 13x6 texture (a width that is no
  multiple of 4) and a 3x2 one (narrower than a run's x-stride);
- `sample_texture_hdr` against the reference at uv inside and outside
  [0, 1), below 0 included, sRGB and linear, at atol 2e-6 (rtol 0): the
  sRGB decode is `jnp.power` against `torch.pow`, which may differ by a
  few ulp, and XLA:CPU contracts the bilinear blend into FMAs (measured
  worst 6.0e-8);
- the three texture test scenes byte-equal, and the fused material table
  of each;
- `fetch_texture_planes` and `mega_body` on captured planes, at d = 0 and
  d = 1, at the TOL of test_torch_shade.py: a Cornell box and a sphere
  whose materials use all ten texture kinds (one kind a material, the
  heightmap and metallic_roughness included), the ceiling light
  emission-textured and hit by light rays, lanes inside a block, with
  the albedo and normal AOVs at d = 0;
- two reference quirks the port mirrors: coat roughness reads the
  texture's green channel (pt_fused.py:644), and NEE toward an
  emission-textured light sees the untextured emission_color
  (pt_fused.py:975);
- `Renderer(device="cpu")` renders like the reference `Renderer` (six
  layers at rtol = atol = 2e-4, path vertices exactly) at 16x16, 2 spp,
  depth 2 on the setups of the goldens texture, normalmap and
  emission_texture (tools/gen_goldens.py), the reference's renders once
  a session (test_torch_cache.py);
- the envelope: alpha cutout raises at `set_scene`, a textured scene
  routed to the wavefront raises at render.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fredholm_tpu.fused import pt_fused as jpf
from fredholm_tpu.renderer import Renderer as JRenderer
from fredholm_tpu.scene import procedural as jproc
from fredholm_tpu.scene import texture as jtex
from fredholm_tpu.scene.device import build_device_scene as j_build
from fredholm_tpu.scene.types import TextureImage as JTextureImage
from fredholm_tpu_torch import Camera, Renderer, cornell_box
from fredholm_tpu_torch.accel.dense import intersect_closest
from fredholm_tpu_torch.fused import cbsdf, kernels
from fredholm_tpu_torch.fused import pt_fused as tpf
from fredholm_tpu_torch.scene import procedural as tproc
from fredholm_tpu_torch.scene import texture as ttex
from fredholm_tpu_torch.scene.device import COL, TEX_KINDS, build_device_scene, build_host_tables
from fredholm_tpu_torch.scene.types import TextureImage

from test_torch_cache import cached_all
from test_torch_lobes import ALL_ON, _byte_equal
from test_torch_shade import _to_jax

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

LAYERS = ("beauty", "position", "normal", "depth", "texcoord", "albedo")


def _random_texture(h, w, channels, srgb, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, channels)).astype(np.uint8), srgb


def _textures(name):
    """(data, is_srgb) of a test texture."""
    if name == "checker":
        t = tproc.checker_texture()
        return t.data, t.is_srgb
    if name == "normalmap":
        t = tproc.normalmap_test().textures[0]
        return t.data, t.is_srgb
    if name == "rgb":
        return _random_texture(8, 8, 3, True, 1)
    if name == "tiny":  # narrower than a run's x-stride
        return _random_texture(2, 3, 4, True, 3)
    return _random_texture(6, 13, 4, False, 2)  # "odd": width 13


TEXTURES = ("checker", "normalmap", "rgb", "odd", "tiny")


def _pair(names):
    got = [TextureImage(*_textures(k)) for k in names]
    want = [JTextureImage(*_textures(k)) for k in names]
    return got, want


@pytest.mark.parametrize("name", TEXTURES)
def test_pack_textures_byte_equal(name):
    got, want = _pair([name, "checker"])
    p, r = ttex.pack_textures(got), jtex.pack_textures(want)
    runs = np.asarray(r["runs"])
    assert p["runs"].dtype == runs.dtype and p["runs"].shape == runs.shape
    assert p["runs"].tobytes() == runs.tobytes()
    hdr = jtex.texture_headers_np(want)
    assert ttex.texture_headers_np(got).tobytes() == hdr.tobytes()
    assert p["header"].tobytes() == np.asarray(r["header"]).tobytes() == hdr.tobytes()


def _uv(n, seed):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    uv[:16] = rng.uniform(0.0, 1.0, (16, 2))
    uv[16:20] = [[0.0, 0.0], [-1e-3, -1e-3], [1.0, 1.0], [-1.0, 0.5]]
    return uv


@pytest.mark.parametrize("name", TEXTURES)
def test_sample_texture_matches_reference(name):
    """Every texture of a two-texture atlas (this one, then the checker)
    and the white fallback, at uv in and out of [0, 1)."""
    got, want = _pair([name, "checker"])
    p, r = ttex.pack_textures(got), jtex.pack_textures(want)
    n = 600
    uv = _uv(n, 3)
    tid = np.arange(n) % 3
    hdr = p["header"][tid]
    cols = [torch.as_tensor(np.ascontiguousarray(hdr[:, i])) for i in range(5)]
    out = ttex.sample_texture_hdr(torch.as_tensor(p["runs"].view(np.int32)),
                                  torch.as_tensor(uv[:, 0]), torch.as_tensor(uv[:, 1]), cols)
    ref = jtex.sample_texture_hdr(r, jnp.asarray(tid), jnp.asarray(uv),
                                  tuple(jnp.asarray(hdr[:, i]) for i in range(5)))
    np.testing.assert_allclose(out.numpy().T, np.asarray(ref), rtol=0, atol=2e-6)
    assert float(out[:3].std()) > 0.05


SCENES = ("texture_test", "normalmap_test", "emission_texture_test")


@pytest.mark.parametrize("name", SCENES)
def test_host_scene_is_byte_equal(name):
    got, want = getattr(tproc, name)(), getattr(jproc, name)()
    _byte_equal(got, want)
    assert len(got.textures) == len(want.textures) == 1
    a, b = got.textures[0], want.textures[0]
    assert a.is_srgb == b.is_srgb and a.data.tobytes() == b.data.tobytes()


@pytest.mark.parametrize("name", SCENES)
def test_fused_mat_table_byte_equal(name):
    host = build_host_tables(getattr(tproc, name)())
    ref = j_build(getattr(jproc, name)())
    assert host["fused_mat_table"].tobytes() == np.asarray(ref["fused_mat_table"]).tobytes()
    assert host["tex_runs"].tobytes() == np.asarray(ref["textures"]["runs"]).tobytes()
    kinds = {"texture_test": ("base_color",), "normalmap_test": ("normalmap",),
             "emission_texture_test": ("emission",)}[name]
    assert host["tex_kinds"] == kinds


# ---------------------------------------------------------------------------
# the texture fetch and mega_body on captured planes

W = H = 32
# texture kind -> the texture (index into _kind_textures) its material uses
KIND_TEX = {"base_color": 0, "specular_color": 1, "specular_roughness": 2, "metalness": 3,
            "metallic_roughness": 2, "coat": 3, "coat_roughness": 1, "emission": 0,
            "normalmap": 4, "heightmap": 3}


def _kind_textures(cls):
    """checker (sRGB), 13x6 RGBA (linear), 8x8 RGB (sRGB), a 10x10 linear
    ramp (heightmap-like) and the normal map."""
    ramp = np.zeros((10, 10, 4), np.uint8)
    ramp[..., :3] = (np.add.outer(np.arange(10), np.arange(10)) * 12)[..., None]
    ramp[..., 3] = 255
    return [cls(*_textures("checker")), cls(*_textures("odd")), cls(*_textures("rgb")),
            cls(ramp, False), cls(*_textures("normalmap"))]


def _kind_scene():
    """The Cornell box and a sphere, every material all-lobe with one
    texture kind: floor base_color, ceiling coat_roughness, back wall
    normalmap, left wall specular_color, right wall metalness, tall block
    specular_roughness, short block heightmap, the sphere's faces
    metallic_roughness and coat in turn; the ceiling light
    emission-textured. 996 faces, traced densely."""
    box = cornell_box()

    def mat(kind, **kw):
        return dataclasses.replace(ALL_ON, **{kind + "_texture_id": KIND_TEX[kind]}, **kw)

    light = dataclasses.replace(box.materials[3], emission_texture_id=KIND_TEX["emission"])
    mats = [mat("base_color"), mat("specular_color"), mat("metalness"), light,
            mat("coat_roughness"), mat("normalmap"), mat("specular_roughness"),
            mat("heightmap"), mat("metallic_roughness"), mat("coat", coat=0.2)]
    mids = np.asarray(box.material_ids).copy()
    # faces: floor 0-1, ceiling 2-3, back 4-5, left 6-7, right 8-9, light
    # 10-11, tall block 12-23, short block 24-35
    mids[2:4], mids[4:6], mids[12:24], mids[24:36] = 4, 5, 6, 7
    v, n, t, f = tproc.uv_sphere([-0.1, 1.25, 0.1], 0.3)
    parts = [(box.vertices, box.normals, box.texcoords, box.indices, mids),
             (v, n, t, f, np.where(np.arange(len(f)) % 2 == 0, 8, 9).astype(np.int32))]
    return tproc._scene(parts, mats, _kind_textures(TextureImage))


def _cfgs(tex_kinds=TEX_KINDS):
    kw = dict(width=W, height=H, max_depth=3, n_lights=2, lobes_on=cbsdf.ALL_LOBES,
              tex_kinds=tuple(tex_kinds))
    return (tpf.FusedConfig(has_dl=True, **kw),
            jpf.FusedConfig(sky_mode=0, has_dl=True, **kw))


@pytest.fixture(scope="module")
def captured():
    """(dev, mega_body's calls of one sample of the port's CPU pipeline
    at d = 0, 1, 2, as (args, result))."""
    dev = build_device_scene(_kind_scene(), "cpu")
    assert dev["n_lights"] == 2 and dev["n_faces"] == 996
    assert dev["tex_kinds"] == TEX_KINDS
    cfg, _ = _cfgs()
    cam = Camera(origin=np.asarray([0.0, 0.9, 1.2], np.float32))
    params = {"camera": cam.device_params("cpu"), "seed": 5,
              "bg_color": np.asarray([0.3, 0.4, 0.5], np.float32),
              "directional_light": {"le": np.asarray([2.0, 1.9, 1.8], np.float32),
                                    "dir": np.asarray([0.3, 0.9, 0.3], np.float32),
                                    "angle": np.float32(1.0)}}
    n = W * H
    sv, usv = tpf.pack_scalars(params, n, "cpu")
    rng = np.random.default_rng(29)
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
    return dev, calls


def test_captured_planes_cover_every_kind(captured):
    """Live lanes hit every texture kind at d = 0 (three or more each)
    and d = 1, some of them from inside a block; light rays of d = 0 hit
    the textured emitter."""
    _, calls = captured
    from fredholm_tpu_torch.fused.cvec import cross, dot

    for d in (0, 1):
        args, _ = calls[d]
        state, rhit, rattr = args[8], args[9], args[10]
        live = state["alive"] & rhit["hit"]
        for kind in TEX_KINDS:
            assert int((live & (rattr[f"tx_{kind}_has"] > 0)).sum()) >= (3 if d == 0 else 1), \
                (d, kind)
    args, _ = calls[1]
    state, rhit, rattr, resolve = args[8], args[9], args[10], args[11]
    fv0, fv1, fv2 = (tpf._attr3(rattr, k) for k in ("v0", "v1", "v2"))
    back = dot(state["d"], cross(fv1 - fv0, fv2 - fv0)) >= 0.0
    assert int((state["alive"] & rhit["hit"] & back).sum()) >= 5
    la = resolve["lattr"]
    on_light = resolve["l_hit"] & (la["tx_emission_has"] > 0) & (resolve["tpf"].x > 0)
    assert int(on_light.sum()) >= 3


def _reference_attrs(dev, attrs):
    """The reference's fetch_texture_planes on the port's attribute columns."""
    _, jcfg = _cfgs()
    jdev = {"textures": {"runs": jnp.asarray(dev["tex_runs"].numpy().view(np.uint32))}}
    out = {c: jnp.asarray(attrs[c].numpy()) for c in attrs if isinstance(c, int)}
    return jdev, jcfg, out


@pytest.mark.parametrize("block", ["rad", "light"])
@pytest.mark.parametrize("d", [0, 1])
def test_fetch_texture_planes_match(captured, d, block):
    """The planes the port's gather stage adds equal the reference's on
    the same columns and barycentrics."""
    dev, calls = captured
    args, _ = calls[d]
    if block == "rad":
        hit, attrs = args[9], args[10]
        w1, w2 = hit["u"], hit["v"]
    else:
        resolve = calls[d + 1][0][11]  # the light block bounce d emitted
        attrs, w1, w2 = resolve["lattr"], resolve["l_u"], resolve["l_v"]
    jdev, jcfg, ref = _reference_attrs(dev, attrs)
    jpf.fetch_texture_planes(jdev, jcfg, ref, jnp.asarray(w1.numpy()), jnp.asarray(w2.numpy()))
    keys = [k for k in attrs if isinstance(k, str)]
    assert sorted(keys) == sorted(k for k in ref if isinstance(k, str))
    for k in keys:
        np.testing.assert_allclose(attrs[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=2e-6,
                                   err_msg=k)


def _leaves(x, path="out"):
    """(path, numpy array) of every tensor or array in a body's output."""
    if isinstance(x, dict):
        for k in sorted(x, key=str):
            yield from _leaves(x[k], f"{path}.{k}")
    elif isinstance(x, tuple):
        for k, v in enumerate(x):
            yield from _leaves(v, f"{path}[{k}]")
    elif x is not None:
        yield path, np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _f64(x):
    """x with every float32 tensor as float64 (the bodies follow their
    inputs' type)."""
    if isinstance(x, tpf.V3):
        return tpf.V3(*(_f64(c) for c in x))
    if isinstance(x, dict):
        return {k: _f64(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_f64(v) for v in x)
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.double()
    return x


@pytest.mark.parametrize("d", [0, 1])
def test_mega_body_matches_all_kinds(captured, d):
    """Every plane at TOL on every lane but ill-conditioned ones: a lane
    where either package's float32 result lies more than TOL / 2 from the
    port's body evaluated in float64 on the same planes is one float32
    cannot resolve; it may differ by up to 1e-4, on at most 1% of the
    lanes. Measured: 2 lanes at d = 0 and 3 at d = 1 of 1024, e.g. lane
    430's next direction at d = 0, a GGX visible-normal sample of the
    metal lobe at the rim of the disk (u0 = 0.99996): port and reference
    2.7e-5 and 5.6e-5 from float64. The rest XLA:CPU's FMA contraction
    moves (the reference's result off float64, the port's on it)."""
    _, calls = captured
    args, _ = calls[d]
    assert args[1] == d
    tcfg, jcfg = _cfgs()
    got = tpf.mega_body(tcfg, *args[1:])
    want = jpf.mega_body(jcfg, *_to_jax(args[1:]))
    exact = tpf.mega_body(tcfg, *_f64(args[1:]))
    excused = set()
    for (p, g), (_, w), (_, e) in zip(_leaves(got), _leaves(want), _leaves(exact)):
        assert g.shape == w.shape == e.shape, p
        if g.dtype == np.bool_ or g.dtype == np.int64:
            np.testing.assert_array_equal(g.astype(np.uint64), w.astype(np.uint64), err_msg=p)
            continue
        off = ~np.isclose(g, w, rtol=1e-5, atol=1e-5, equal_nan=True)
        half = 0.5 * (1e-5 + 1e-5 * np.abs(e))
        ill = (np.abs(g - e) > half) | (np.abs(w - e) > half)
        assert not (off & ~ill).any(), (p, np.nonzero(off & ~ill))
        excused |= set(np.nonzero(np.atleast_1d(off))[0].tolist())
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=p)
    assert len(excused) <= W * H // 100, sorted(excused)
    if d == 0:
        # the textured AOVs: albedo from the base-color texture, the normal
        # bumped and normal-mapped; both differ from the untextured ones
        untextured = tpf.mega_body(tcfg._replace(tex_kinds=()), *args[1:])
        for key in ("albedo", "normal"):
            assert any(float((g - p).abs().max()) > 1e-3
                       for g, p in zip(got[3][key], untextured[3][key])), key


def test_coat_roughness_reads_green_channel():
    """Reference quirk, mirrored (pt_fused.py:644): a coat-roughness
    texture's green channel sets coat_roughness, not its red one."""
    n = 4
    r = torch.full((n,), 0.9)
    g = torch.tensor([0.2, 0.4, 1.5, -0.5])
    attrs = {"tx_coat_roughness_has": torch.tensor([1.0, 1.0, 1.0, 0.0]),
             "tx_coat_roughness_r": r, "tx_coat_roughness_g": g,
             "tx_coat_roughness_b": torch.zeros(n)}
    sp = {"coat_roughness": torch.full((n,), 0.1)}
    tpf._apply_tex_overrides(_cfgs(("coat_roughness",))[0], sp, attrs)
    want = torch.tensor([0.2, 0.4, 1.0, 0.1])
    assert torch.equal(sp["coat_roughness"], want)
    jsp = {"coat_roughness": jnp.full((n,), 0.1)}
    jpf._apply_tex_overrides(_cfgs(("coat_roughness",))[1], jsp, _to_jax(attrs))
    assert np.array_equal(np.asarray(jsp["coat_roughness"]), want.numpy())


def test_nee_keeps_untextured_emission(captured):
    """Reference quirk, mirrored (pt_fused.py:975): NEE toward an
    emission-textured light reads the light table's emission_color, so
    the pending area contribution does not see the texture; the light
    ray's hit does (`emission_from_attrs`)."""
    dev, calls = captured
    assert np.array_equal(dev["light_table"][:, 18:21].numpy(),
                          np.tile(np.float32(10.0), (2, 3)))
    args, (_, _, pend, _) = calls[1]
    tcfg, jcfg = _cfgs()
    want = jpf.mega_body(jcfg, *_to_jax(args[1:]))[2]
    np.testing.assert_allclose(pend["c_area"].x.numpy(), np.asarray(want["c_area"].x),
                               rtol=1e-5, atol=1e-5)
    # the emission planes do not enter the NEE: black them out, same c_area
    rattr = dict(args[10])
    for ch in "rgb":
        rattr["tx_emission_" + ch] = torch.zeros_like(rattr["tx_emission_" + ch])
    blacked = tpf.mega_body(tcfg, *args[1:10], rattr, *args[11:])[2]
    assert torch.equal(blacked["c_area"].x, pend["c_area"].x)
    assert float(pend["c_area"].x.max()) > 0.0


# ---------------------------------------------------------------------------
# whole renders against the reference


def _golden(name, cls):
    """The golden's setup (tools/gen_goldens.py) at 16x16 for the port
    (cls Renderer, on the CPU) or the reference (JRenderer)."""
    port = cls is Renderer
    proc = tproc if port else jproc
    r = cls(width=16, height=16, **({"device": "cpu"} if port else {}))
    r.set_scene(getattr(proc, name + "_test")())
    at = {"texture": (0.0, 1.0, 2.2), "normalmap": (0.0, 1.0, 2.2),
          "emission_texture": (0.0, 1.0, 2.6)}[name]
    r.camera.origin = np.asarray(at, np.float32)
    r.camera._update_transform()
    if name == "normalmap":
        r.set_directional_light((3, 3, 3), (0.5, 1.0, 0.4), angle=1.0)
    r.set_bg_color({"texture": (0.7, 0.8, 0.9), "normalmap": (0.2, 0.2, 0.25),
                    "emission_texture": (0.0, 0.0, 0.0)}[name])
    return r


GOLDENS = {"texture": "base_color", "normalmap": "normalmap", "emission_texture": "emission"}
KW = dict(n_samples=2, max_depth=2)


def _reference(name):
    j = _golden(name, JRenderer)
    j.use_pallas = False
    cfg = j._config(1, KW["max_depth"])
    assert cfg.use_fused and cfg.tex_kinds == (GOLDENS[name],)
    return j


def _port(name):
    t = _golden(name, Renderer)
    assert t._params(KW["max_depth"])["use_fused"] and "clusters" in t._dev
    cfg = tpf.make_config(t._dev, t._params(KW["max_depth"]))
    assert cfg.tex_kinds == (GOLDENS[name],) and kernels.mega_variant(cfg) == "tex"
    return t


def _layers(r):
    r.render(**KW)
    return {k: np.asarray(r.layers[k]) for k in r.layers}


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """{name: (port layers, reference layers)} of the three setups, each
    rendered once a session, through one request."""
    entries = []
    for name in GOLDENS:
        entries.append((f"textures_{name}", sorted(KW.items()),
                        lambda name=name: _layers(_reference(name))))
        entries.append((f"textures_{name}_port", sorted(KW.items()),
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


def test_heightmap_step_guard():
    """A lane whose heightmap header has width or height 0 (the reference
    divides by it, ROADMAP Queue C item 4) gets finite planes; the other
    lanes' planes are the unguarded ones."""
    p = ttex.pack_textures([TextureImage(*_textures("checker"))])
    runs = torch.as_tensor(p["runs"].view(np.int32))
    n = 4
    attrs = {c: torch.zeros(n) for c in range(COL["tx_heightmap"] + 6)}
    attrs[COL["uv1"]] = torch.full((n,), 1.0)
    base = COL["tx_heightmap"]
    for i, v in enumerate([0.0, *p["header"][0]]):
        attrs[base + i] = torch.full((n,), float(v))
    attrs[base + 2][1] = 0.0  # width 0
    attrs[base + 3][2] = 0.0  # height 0
    cfg = _cfgs(("heightmap",))[0]
    w1 = torch.tensor([0.3, 0.3, 0.3, 0.3])
    tpf.fetch_texture_planes(runs, cfg, attrs, w1, torch.full((n,), 0.2))
    for k in ("has", "dfdu", "dfdv"):
        assert bool(torch.isfinite(attrs["tx_heightmap_" + k]).all()), k
    jdev = {"textures": {"runs": jnp.asarray(p["runs"])}}
    ref = {c: jnp.asarray(v.numpy()) for c, v in attrs.items() if isinstance(c, int)}
    jpf.fetch_texture_planes(jdev, _cfgs(("heightmap",))[1], ref, jnp.asarray(w1.numpy()),
                             jnp.full((n,), 0.2))
    for k in ("dfdu", "dfdv"):
        np.testing.assert_allclose(attrs["tx_heightmap_" + k][[0, 3]].numpy(),
                                   np.asarray(ref["tx_heightmap_" + k])[[0, 3]], atol=2e-6)


def test_textured_progressive_accumulation_is_exact():
    r = Renderer(8, 8, device="cpu")
    r.set_scene(tproc.texture_test())
    r.render(n_samples=1, max_depth=2)
    r.render(n_samples=1, max_depth=2)
    split = {k: v.clone() for k, v in r.layers.items()}
    r.init_render_states()
    r.render(n_samples=2, max_depth=2)
    for k in LAYERS + ("n_path_vertices",):
        assert torch.equal(split[k], r.layers[k]), k


def test_textured_cpu_render_runs_the_twins():
    """On the CPU a textured render runs the stage twins, mega's once a
    bounce, and no kernel."""
    from fredholm_tpu_torch import _build

    r = Renderer(8, 8, device="cpu")
    r.set_scene(tproc.emission_texture_test())
    _build.LAUNCHES.clear()
    r.render(n_samples=2, max_depth=3)
    counts = dict(_build.LAUNCHES)
    assert counts["mega_twin"] == 6 and counts["final_twin"] == counts["raygen_twin"] == 2
    assert not {k: v for k, v in counts.items() if not k.endswith("_twin")}, counts


# ---------------------------------------------------------------------------
# the envelope


@pytest.mark.parametrize("case", ["alpha_texture", "base_color_alpha", "opaque_alpha"])
def test_alpha_cutout_envelope(case):
    """An alpha texture, or a base-color texture with an alpha below 128,
    raises; a base-color alpha of 128 and above cuts nothing
    (renderer.py:137-149) and takes the textured pipeline."""
    scene = tproc.texture_test()
    if case == "alpha_texture":
        scene.materials[0] = dataclasses.replace(scene.materials[0], alpha_texture_id=0)
    else:
        data = scene.textures[0].data.copy()
        data[0, 0, 3] = 100 if case == "base_color_alpha" else 128
        scene.textures[0] = TextureImage(data, True)
    r = Renderer(8, 8, device="cpu")
    if case == "opaque_alpha":
        r.set_scene(scene)
        assert tpf.make_config(r._dev, r._params(2)).tex_kinds == ("base_color",)
        return
    with pytest.raises(NotImplementedError, match="alpha"):
        r.set_scene(scene)


@pytest.mark.parametrize("route", ["use_fused", "bluenoise", "thin_film", "many_lights",
                                   "fused"])
def test_textured_scene_routes(route):
    """Each route to the wavefront integrator raises for a textured scene;
    the fused route renders it."""
    scene = tproc.texture_test()
    if route == "thin_film":
        scene.materials[1] = dataclasses.replace(scene.materials[1], thin_film_thickness=300.0)
    if route == "many_lights":
        scene.materials[0] = dataclasses.replace(scene.materials[0], emission=1.0,
                                                 emission_color=(1.0, 1.0, 1.0))
    r = Renderer(8, 8, device="cpu")
    r.set_scene(scene)
    if route == "use_fused":
        r.use_fused = False
    if route == "bluenoise":
        r.sampler_mode = "bluenoise"
    if route == "fused":
        r.render(n_samples=1, max_depth=2)
        assert float(r.layers["n_path_vertices"]) > 0
        return
    assert not r._params(2)["use_fused"]
    with pytest.raises(NotImplementedError, match="wavefront integrator has no textures"):
        r.render(n_samples=1, max_depth=2)
