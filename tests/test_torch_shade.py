"""The port's pipeline bodies (raygen, mega at d = 0 and d = 1, final
resolve) must match the reference's jnp bodies (fredholm_tpu/fused/
pt_fused.py:424, :771, :1090) on identical planes and tables, at
rtol = atol = 1e-5, with boolean planes equal.

The planes are real ones: the port's CPU pipeline runs a 32x32 Cornell
sample and every body call is captured, then replayed through the
reference body on the same numbers. Also checks that the CUDA header's
column constants and launch-argument struct agree with the Python side.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fredholm_tpu.fused import pt_fused as jpf
from fredholm_tpu.fused.cvec import V3 as JV3
from fredholm_tpu_torch import Camera, _build, cornell_box
from fredholm_tpu_torch.fused import kernels
from fredholm_tpu_torch.fused import pt_fused as tpf
from fredholm_tpu_torch.fused.cvec import V3 as TV3
from fredholm_tpu_torch.scene.device import COL, GEOM_COLS, build_device_scene
from test_torch_cache import release_compiled_programs  # noqa: F401 (autouse)

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
W = H = 32


def _to_jax(x):
    if isinstance(x, TV3):
        return JV3(*(_to_jax(c) for c in x))
    if isinstance(x, dict):
        return {k: _to_jax(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_jax(v) for v in x)
    if isinstance(x, torch.Tensor):
        a = x.numpy()
        if a.dtype == np.int64:  # uint32 values
            return jnp.asarray(a.astype(np.uint32))
        return jnp.asarray(a)
    return x


def _compare(got, want, path="out"):
    if isinstance(got, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in got:
            _compare(got[k], want[k], f"{path}.{k}")
    elif isinstance(got, tuple):
        assert len(got) == len(want), path
        for k, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{path}[{k}]")
    elif got is None:
        assert want is None, path
    else:
        g, w = got.numpy(), np.asarray(want)
        if g.dtype == np.bool_:
            np.testing.assert_array_equal(g, w, err_msg=path)
        elif g.dtype == np.int64:
            np.testing.assert_array_equal(g.astype(np.uint64), w.astype(np.uint64), err_msg=path)
        else:
            np.testing.assert_allclose(g, w, err_msg=path, **TOL)


def _cfgs(n_lights):
    kw = dict(width=W, height=H, max_depth=3, n_lights=n_lights, lobes_on=("diffuse_r",))
    return tpf.FusedConfig(**kw), jpf.FusedConfig(sky_mode=0, has_dl=False, **kw)


@pytest.fixture(scope="module")
def captured():
    """Run the port's CPU pipeline for one sample, capturing every body
    call's arguments and results, for two scenes: Cornell (two area
    lights) and Cornell without its light (no area-light block)."""
    out = {}
    for n_lights in (2, 0):
        scene = cornell_box()
        if n_lights == 0:
            scene.materials[3].emission_color = (0.0, 0.0, 0.0)
        dev = build_device_scene(scene, "cpu")
        assert dev["n_lights"] == n_lights
        cfg, _ = _cfgs(n_lights)
        cam = Camera(origin=np.asarray([0.0, 1.0, 0.6], np.float32))
        params = {"camera": cam.device_params("cpu"), "seed": 7,
                  "bg_color": np.asarray([0.4, 0.5, 0.7], np.float32)}
        sv, usv = tpf.pack_scalars(params, W * H, "cpu")
        # sample counts straddling 2**31 and 2**32 exercise the uint32 wrap
        # of sample_idx = image_idx + n_spp * n_pixels
        rng = np.random.default_rng(3)
        n_spp = torch.as_tensor(
            rng.choice([0, 5, 2**31 - 1, 2**31, 2**32 - 1], W * H).astype(np.int64))
        calls = []
        bodies = {}
        for name in ("raygen_body", "mega_body", "final_resolve_body"):
            fn = getattr(tpf, name)

            def rec(*a, _fn=fn, _name=name):
                r = _fn(*a)
                calls.append((_name, a, r))
                return r

            bodies[name] = rec
        orig = {k: getattr(tpf, k) for k in bodies}
        try:
            for k, v in bodies.items():
                setattr(tpf, k, v)
            state, sidx, rays = kernels.raygen(cfg, sv, usv, n_spp)
            from fredholm_tpu_torch.accel.dense import intersect_closest

            pending = None
            for d in range(cfg.max_depth):
                hits = intersect_closest(dev["tri_soa"], rays, rays.shape[1])
                state, rays, pending, _ = kernels.mega(
                    cfg, d, sv, usv, dev, n_spp, sidx, state, rays, pending,
                    tpf.Traced(hits))
            hits = intersect_closest(dev["tri_soa"], rays, (len(cfg.blocks) - 1) * W * H)
            kernels.final(cfg, sv, dev, state, rays, pending, tpf.Traced(hits))
        finally:
            for k, v in orig.items():
                setattr(tpf, k, v)
        out[n_lights] = calls
    return out


@pytest.mark.parametrize("n_lights", [2, 0])
def test_raygen_body_matches(captured, n_lights):
    (_, args, got), = [c for c in captured[n_lights] if c[0] == "raygen_body"]
    _, jcfg = _cfgs(n_lights)
    want = jpf.raygen_body(jcfg, *_to_jax(args[1:]))
    _compare(got, want)
    assert got["sample_idx"].max() > 2**31  # the wrap was exercised


@pytest.mark.parametrize("n_lights", [2, 0])
@pytest.mark.parametrize("d", [0, 1, 2])
def test_mega_body_matches(captured, n_lights, d):
    megas = [c for c in captured[n_lights] if c[0] == "mega_body"]
    _, args, got = megas[d]
    assert args[1] == d
    _, jcfg = _cfgs(n_lights)
    want = jpf.mega_body(jcfg, *_to_jax(args[1:]))
    _compare(got, want)
    st = got[0]
    assert st["alive"].any() and not st["alive"].all()


@pytest.fixture(scope="module")
def mostly_dead():
    """mega_body's calls at d = 1..4 of a 32x32 Cornell sample (two area
    lights, a blue sky) whose lanes are mostly dead: before the trace at
    d = 1, a numpy-seeded 35% of the lanes lose their alive flag (their ray
    still traced, so some hit) and another 35% also their ray (tmax -1, a
    miss); Russian roulette thins the rest."""
    w = h = 32
    n = w * h
    dev = build_device_scene(cornell_box(), "cpu")
    cfg = tpf.FusedConfig(w, h, 5, dev["n_lights"], ("diffuse_r",))
    cam = Camera(origin=np.asarray([0.0, 1.0, 0.6], np.float32))
    sv, usv = tpf.pack_scalars({"camera": cam.device_params("cpu"), "seed": 11,
                                "bg_color": np.asarray([0.4, 0.5, 0.7], np.float32)}, n, "cpu")
    rng = np.random.default_rng(17)
    n_spp = torch.as_tensor(rng.integers(0, 50, n).astype(np.int64))
    calls = []
    orig = tpf.mega_body

    def rec(*a):
        r = orig(*a)
        calls.append((a, r))
        return r

    from fredholm_tpu_torch.accel.dense import intersect_closest

    tpf.mega_body = rec
    try:
        state, sidx, rays = kernels.raygen(cfg, sv, usv, n_spp)
        pending = None
        for d in range(cfg.max_depth):
            if d == 1:
                kill = torch.as_tensor(rng.uniform(size=n) < 0.7)
                state = state.clone()
                state[tpf.ST_ALIVE][kill] = 0.0
                rays = rays.clone()
                rad = (len(cfg.blocks) - 1) * n
                miss = kill & torch.as_tensor(rng.uniform(size=n) < 0.5)
                rays[6, rad:][miss] = -1.0
            hits = intersect_closest(dev["tri_soa"], rays, rays.shape[1])
            state, rays, pending, _ = kernels.mega(cfg, d, sv, usv, dev, n_spp, sidx, state,
                                                   rays, pending, tpf.Traced(hits))
    finally:
        tpf.mega_body = orig
    return calls


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_mega_body_matches_on_dead_lanes(mostly_dead, d):
    """The outputs the kernel's short path must reproduce for lanes that
    shade nothing (zero contributions, tmax -1 rays with the body's
    origins and directions, the light ray's pdf, the stale state) are the
    reference's."""
    args, got = mostly_dead[d]
    assert args[1] == d
    _, jcfg = _cfgs(2)
    jcfg = jcfg._replace(max_depth=5)
    want = jpf.mega_body(jcfg, *_to_jax(args[1:]))
    _compare(got, want)
    alive_in = args[8]["alive"]
    shading = alive_in & args[9]["hit"]
    assert 0.8 < 1.0 - shading.float().mean() < 1.0
    # dead lanes emit rays with tmax -1 whose origins the body computed
    st, rays, pend, _ = got
    dead = ~shading
    for blk in ("sky", "area", "light", "rad"):
        assert (rays[blk][2][dead] == -1.0).all(), blk
    assert (rays["sky"][0].x[dead] != 0.0).any()
    assert not st["alive"][dead].any()


@pytest.mark.parametrize("n_lights", [2, 0])
def test_final_resolve_body_matches(captured, n_lights):
    (_, args, got), = [c for c in captured[n_lights] if c[0] == "final_resolve_body"]
    _, jcfg = _cfgs(n_lights)
    want = jpf.final_resolve_body(jcfg, *_to_jax(args[1:]))
    _compare(got, want)
    assert float(got.x.max()) > 0.0


def test_pack_scalars_matches():
    cam = Camera(origin=np.asarray([0.3, 1.0, 0.6], np.float32))
    from fredholm_tpu.camera import Camera as JCamera

    jcam = JCamera(origin=np.asarray([0.3, 1.0, 0.6], np.float32))
    params = {"camera": cam.device_params("cpu"), "seed": 2**32 - 5,
              "bg_color": np.asarray([0.1, 0.2, 0.3], np.float32)}
    sv, usv = tpf.pack_scalars(params, 1 << 20, "cpu")
    jsv, jusv = jpf.pack_scalars(
        {**params, "camera": jcam.device_params(), "seed": jnp.uint32(2**32 - 5),
         "bg_color": jnp.asarray(params["bg_color"])}, 1 << 20)
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jsv))
    np.testing.assert_array_equal(usv.numpy().astype(np.uint32), np.asarray(jusv))


@pytest.mark.parametrize("d", [0, 1, 4])
def test_config_draw_slots_match(d):
    for n_lights in (0, 3):
        t, j = _cfgs(n_lights)
        assert t.blocks == tuple(j.nee_blocks) + ("light", "rad")
        for slot in range(4):
            assert t.sobol_dim(d, slot) == j.sobol_dim(d, slot)
            assert t.cmj_depth(d, slot) == j.cmj_depth(d, slot)


def test_cuda_lobe_envelope_raises():
    """The CUDA kernel has every lobe of cbsdf.ALL_LOBES (bit k for lobe
    k); a name without a lobe bit (the thin film, which routes to the
    wavefront integrator) raises before any launch."""
    from fredholm_tpu_torch.fused import cbsdf

    cfg, _ = _cfgs(2)
    assert kernels._lobe_mask(cfg._replace(lobes_on=cbsdf.ALL_LOBES)) == 127
    assert kernels._lobe_mask(cfg) == 64
    assert kernels._lobe_mask(cfg._replace(lobes_on=("metal", "specular", "diffuse_r"))) == 70
    assert kernels._lobe_mask(cfg._replace(lobes_on=("coat", "diffuse_r"))) == 65
    with pytest.raises(NotImplementedError, match="lobes"):
        kernels._lobe_mask(cfg._replace(lobes_on=("specular", "thin_film", "diffuse_r")))
    # the variant fh_mega launches (csrc/shade.cu needs_full, needs_rich)
    assert kernels.mega_variant(cfg) == "plain"
    assert kernels.mega_variant(cfg._replace(lobes_on=("metal", "diffuse_r"))) == "rich"
    assert kernels.mega_variant(cfg._replace(has_dl=True)) == "rich"
    for lobe in ("coat", "transmission", "sheen", "diffuse_t"):
        assert kernels.mega_variant(cfg._replace(lobes_on=(lobe, "diffuse_r"))) == "full"
    # any texture kind takes the textured variant (csrc/shade.cu tex_mask)
    for k, kind in enumerate(tpf.TEX_KINDS):
        tex = cfg._replace(tex_kinds=(kind,))
        assert kernels.mega_variant(tex) == "tex" and kernels._tex_mask(tex) == 1 << k
    assert kernels._tex_mask(cfg._replace(tex_kinds=tpf.TEX_KINDS)) == 1023
    assert kernels._tex_mask(cfg) == 0


_CSRC = os.path.join(os.path.dirname(tpf.__file__), "..", "csrc")


def test_cuda_header_matches_python_layout():
    src = open(os.path.join(_CSRC, "common.cuh")).read()
    defs = dict(re.findall(r"#define (\w+) (-?\d+)\n", src))
    assert int(defs["GEOM_COLS"]) == GEOM_COLS
    assert int(defs["MAT_COLS"]) == tpf.MAT_COLS
    for c, name in (("C_V0", "v0"), ("C_N0", "n0"), ("C_UV0", "uv0"),
                    ("C_AREA", "area"), ("C_MAT_ID", "mat_id")):
        assert int(defs[c]) == COL[name], c
    for m in ("emission_color", "has_emission", "base_color", "diffuse",
              "diffuse_roughness", "specular", "specular_color",
              "specular_roughness", "metalness", "coat", "coat_roughness",
              "coat_color", "transmission", "transmission_color", "sheen",
              "sheen_color", "sheen_roughness", "subsurface", "subsurface_color",
              "thin_walled"):
        assert int(defs["M_" + m.upper()]) == COL[m] - GEOM_COLS, m
    from fredholm_tpu_torch.fused import cbsdf

    for k, lobe in enumerate(cbsdf.ALL_LOBES):
        assert int(defs["LOBE_" + lobe.upper()]) == 1 << k, lobe
    full = re.search(r"#define LOBES_FULL_ONLY \(([^)]*)\)", src).group(1)
    assert [x.strip() for x in full.split("|")] == \
        ["LOBE_" + lobe.upper() for lobe in kernels.FULL_LOBES]
    assert int(defs["M_TX0"]) == COL["tx_base_color"] - GEOM_COLS
    for k, kind in enumerate(tpf.TEX_KINDS):
        assert COL["tx_" + kind] - GEOM_COLS == int(defs["M_TX0"]) + int(defs["TX_COLS"]) * k
        assert int(defs["TEX_" + kind.upper()]) == 1 << k, kind
    for k in ("ST_O", "ST_D", "ST_THR", "ST_RAD", "ST_NV", "ST_ALIVE",
              "PD_SKY", "PD_AREA", "PD_TPF", "PD_PDF_L", "PD_WI_L_Y", "PD_DL",
              "AOV_POS", "AOV_NRM", "AOV_DEPTH", "AOV_TU", "AOV_TV", "AOV_ALB"):
        assert int(defs[k]) == getattr(tpf, k), k
    body = src[src.index("struct ShadeArgs {"):src.index("};", src.index("struct ShadeArgs {"))]
    fields = re.findall(r"(\w+);", body)
    assert fields == [f for f, _ in _build.ShadeArgs._fields_]


def test_build_reads_a_built_librarys_record(tmp_path, monkeypatch):
    """A library already built for these sources (by another process, as
    chip_smoke.py builds other trees) is returned without nvcc, with the
    registers and spills its build recorded beside it."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("nvcc called"))
    lib = tmp_path / f"libfh_kernels_{_build._source_hash(_build.CSRC_DIR)}.so"
    lib.write_bytes(b"")
    info = {}
    assert _build.build(_build.CSRC_DIR, info) == str(lib)
    assert info == {"seconds": 0.0}
    rec = {"k_mega_full": {"registers": 80, "spill_stores": 8, "spill_loads": 8}}
    (tmp_path / (lib.name + ".json")).write_text(json.dumps(rec))
    info = {}
    assert _build.build(_build.CSRC_DIR, info) == str(lib)
    assert info == {"seconds": 0.0, "ptxas": rec}


def test_renderer_cuda_without_card_raises():
    from fredholm_tpu_torch import Renderer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(8, 8, device="cuda")
