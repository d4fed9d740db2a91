"""The port's wavefront integrator (integrator/pt.py `render_sample`) and
its modules against the reference's, on the CPU:

- sampler draws, both modes, bit-equal to fredholm_tpu.sampling.sampler
  (the uint32 hashing is exact and the blue-noise dither and dimension
  offsets are folded in float32 as the reference folds them);
- the stacked BSDF (setup, eval, eval_pdf, sample) for every lobe and for
  the thin film, against fredholm_tpu.bsdf.bsdf: setup, eval and eval_pdf
  at 1e-5 (tests/test_torch_cbsdf.py's bar); sample()'s directions at the
  reference's own rtol 2e-4 / atol 1e-4, its f and pdf at rtol 2e-3. A
  sampled GGX half vector carries one-ulp cos/sin differences between
  torch and XLA, and at alpha 0.0025-0.004 (roughness 0.05-0.06, the
  thin_film golden's) D = 1 / (pi alpha^2 t^2) turns them into relative
  errors up to 9.5e-4 in f and pdf (measured over 20 seeds, where f
  reaches 7.5e5); every other lane agrees within 2e-4;
- two whole-slice renders, the reference on its plain path
  (use_pallas=False): all six layers at rtol = atol = 2e-4 (the bar of
  tests/test_fused_integrator.py:55-58) and n_path_vertices,
  n_lane_slots equal. (a) a Cornell box whose two blocks emit (26 area
  lights) under the blue-noise sampler and a sun: dense, B1 + B3 twins;
  (b) the thin_film golden's setup at 16x16: clustered, B4/B5/B6 twins;
- `render(1); render(1) == render(2)` on the wavefront;
- routing: the port takes the wavefront exactly where the reference's
  `_config(...).use_fused` is False, apart from its (w*h) % 128 gate.

The file holds seven tests, each looping over its cases: pytest-xdist
hands files out largest (most tests) first, and a file of few tests runs
beside the suite's longest file (tests/test_instanced.py) instead of
ahead of it.
"""

import jax.numpy as jnp
import numpy as np
import torch

from fredholm_tpu.bsdf import bsdf as jb
from fredholm_tpu.renderer import Renderer as JRenderer
from fredholm_tpu.sampling import sampler as js
from fredholm_tpu.scene.procedural import cornell_box as j_cornell
from fredholm_tpu.scene.procedural import sphere_array_test as j_spheres
from fredholm_tpu.scene.types import Material as JMaterial
from fredholm_tpu_torch import Renderer, cornell_box
from fredholm_tpu_torch.bsdf import bsdf as tb
from fredholm_tpu_torch.sampling import sampler as ts
from fredholm_tpu_torch.scene.procedural import sphere_array_test
from fredholm_tpu_torch.scene.types import Material
from test_torch_cache import release_compiled_programs  # noqa: F401 (autouse)

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

LAYERS = ("beauty", "position", "normal", "depth", "texcoord", "albedo")
N = 257
TOL = dict(rtol=1e-5, atol=1e-5)
SAMPLE_TOL = dict(rtol=2e-4, atol=1e-4)
SAMPLE_F_TOL = dict(rtol=2e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# sampler


def test_sampler_draws_bit_equal():
    rng = np.random.default_rng(3)
    width, height = 40, 25
    image_idx = rng.permutation(width * height).astype(np.uint32)
    n_spp = rng.integers(0, 1 << 20, width * height).astype(np.uint32)
    seed = 0xDEADBEEF
    for mode in ("sobol_cmj", "bluenoise"):
        sj = js.init_sampler_state(jnp.asarray(image_idx), jnp.asarray(n_spp), width * height,
                                   jnp.uint32(seed), mode=mode, width=width)
        st = ts.init_sampler_state(torch.as_tensor(image_idx.astype(np.int64)),
                                   torch.as_tensor(n_spp.astype(np.int64)), width * height,
                                   seed, mode=mode, width=width)
        for draw in ("1d", "2d", "1d", "2d", "2d", "3d", "1d", "4d", "2d") * 2:
            uj, sj = getattr(js, "sample_" + draw)(sj)
            ut, st = getattr(ts, "sample_" + draw)(st)
            np.testing.assert_array_equal(ut.numpy(), np.asarray(uj), err_msg=f"{mode} {draw}")


# ---------------------------------------------------------------------------
# BSDF

LOBE_SETS = [
    ("coat",), ("metal",), ("specular",), ("transmission",), ("sheen",), ("diffuse_t",),
    ("diffuse_r",), ("specular", "thin_film"), tb.ALL_LOBES, tb.ALL_LOBES + ("thin_film",),
]


def _bsdf_inputs(seed):
    rng = np.random.default_rng(seed)

    def unit(hemi=False):
        v = rng.normal(size=(N, 3)).astype(np.float32)
        if hemi:
            v[:, 1] = np.abs(v[:, 1]) + 1e-3
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def s(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, N).astype(np.float32)

    def c():
        return rng.uniform(0, 1, (N, 3)).astype(np.float32)

    sp = {
        "base_color": c(), "diffuse": s(), "diffuse_roughness": s(),
        "specular": s(), "specular_color": c(), "specular_roughness": s(0.05, 1.0),
        "metalness": s(), "coat": s(), "coat_roughness": s(0.05, 1.0), "coat_color": c(),
        "transmission": s(), "transmission_color": c(), "sheen": s(), "sheen_color": c(),
        "sheen_roughness": s(0.05, 1.0), "subsurface": s(), "subsurface_color": c(),
        "thin_walled": (s() > 0.5).astype(np.float32),
        # a film on about two lanes of three, 100-900 nm
        "thin_film_thickness": np.where(s() < 0.35, 0.0, s(100.0, 900.0)).astype(np.float32),
        "thin_film_ior": s(1.2, 2.0),
    }
    return {"sp": sp, "wo": unit(True), "wi": unit(), "entering": s() > 0.3, "u": s(),
            "v": rng.uniform(0, 1, (N, 2)).astype(np.float32)}


def _close(a, b, what, tol=TOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what, **tol)


def test_bsdf_matches_reference():
    x = _bsdf_inputs(17)
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "sp"}
    t = {k: torch.as_tensor(v) for k, v in x.items() if k != "sp"}
    for lobes_on in LOBE_SETS:
        tag = "+".join(lobes_on) + ": "
        ctx_j = jb.setup(j["wo"], {k: jnp.asarray(v) for k, v in x["sp"].items()},
                         j["entering"], lobes_on)
        ctx_t = tb.setup(t["wo"], {k: torch.as_tensor(v) for k, v in x["sp"].items()},
                         t["entering"], lobes_on)
        for key in ("pmf", "coat_albedo", "spec_albedo", "sheen_albedo", "coat_absorption",
                    "metal_n", "metal_k", "eta", "coat_alpha", "spec_alpha"):
            _close(ctx_t[key], ctx_j[key], tag + key)
        _close(tb.eval(ctx_t, t["wo"], t["wi"]), jb.eval(ctx_j, j["wo"], j["wi"]), tag + "eval")
        _close(tb.eval_pdf(ctx_t, t["wo"], t["wi"]), jb.eval_pdf(ctx_j, j["wo"], j["wi"]),
               tag + "eval_pdf")
        out_t = tb.sample(ctx_t, t["wo"], t["u"], t["v"])
        out_j = jb.sample(ctx_j, j["wo"], j["u"], j["v"])
        for name, a, b, tol in zip(("wi", "f", "pdf"), out_t, out_j,
                                   (SAMPLE_TOL, SAMPLE_F_TOL, SAMPLE_F_TOL)):
            _close(a, b, tag + "sample " + name, tol)


def test_helpers_off_the_path_match_reference():
    """Ported helpers the integrator does not call: the uniform disk, the
    Lambert lobe, Schlick's fresnel and the 2D blue-noise draw."""
    from fredholm_tpu.bsdf import fresnel as jf
    from fredholm_tpu.bsdf import lobes as jl
    from fredholm_tpu.sampling import bluenoise as jbn
    from fredholm_tpu.sampling import mappings as jm
    from fredholm_tpu_torch.bsdf import fresnel as tf
    from fredholm_tpu_torch.bsdf import lobes as tl
    from fredholm_tpu_torch.sampling import bluenoise as tbn
    from fredholm_tpu_torch.sampling import mappings as tm

    x = _bsdf_inputs(5)
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "sp"}
    t = {k: torch.as_tensor(v) for k, v in x.items() if k != "sp"}
    _close(tm.sample_uniform_disk(t["v"]), jm.sample_uniform_disk(j["v"]), "uniform disk")
    alb = x["sp"]["base_color"]
    for name, a, b in zip(("wi", "f", "pdf"),
                          tl.lambert_sample(torch.as_tensor(alb), t["wo"], t["v"]),
                          jl.lambert_sample(jnp.asarray(alb), j["wo"], j["v"])):
        _close(a, b, "lambert " + name)
    f0 = x["sp"]["specular_color"]
    _close(tf.fresnel_schlick(t["u"][:, None], torch.as_tensor(f0)),
           jf.fresnel_schlick(j["u"][:, None], jnp.asarray(f0)), "schlick")
    px = np.arange(N, dtype=np.int64) % 40
    py = np.arange(N, dtype=np.int64) // 40
    shift_t = tbn.bn_shift(torch.as_tensor(px), torch.as_tensor(py))
    shift_j = jbn.bn_shift(jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32))
    np.testing.assert_array_equal(shift_t.numpy(), np.asarray(shift_j))
    idx = np.arange(N, dtype=np.int64) * 7
    np.testing.assert_array_equal(
        tbn.blue_noise_2d(shift_t, torch.as_tensor(idx), 1030, 99).numpy(),
        np.asarray(jbn.blue_noise_2d(shift_j, jnp.asarray(idx, jnp.uint32), 1030,
                                     jnp.uint32(99))))


# ---------------------------------------------------------------------------
# whole-slice renders


def _many_lights_cornell(pkg_cornell, material_cls):
    """The Cornell box with both blocks emissive: 2 + 24 area lights."""
    s = pkg_cornell()
    s.materials.append(material_cls(base_color=(0.8, 0.8, 0.8), specular=0.0, emission=1.0,
                                    emission_color=(0.6, 0.4, 0.2)))
    s.material_ids = s.material_ids.copy()
    s.material_ids[12:] = len(s.materials) - 1
    return s


def _setup_a(cls, size=32):
    kw = {"device": "cpu"} if cls is Renderer else {}
    r = cls(width=size, height=size, **kw)
    r.set_scene(_many_lights_cornell(cornell_box, Material) if cls is Renderer
                else _many_lights_cornell(j_cornell, JMaterial))
    r.camera.origin = np.asarray([0.0, 1.0, 0.6], np.float32)
    r.camera._update_transform()
    r.sampler_mode = "bluenoise"
    r.set_directional_light((2.0, 1.9, 1.8), (0.35, 0.75, 0.3), angle=0.5)
    return r


def _setup_b(cls, size=16):
    """The thin_film golden's setup (tools/gen_goldens.py:197-215)."""
    kw = {"device": "cpu"} if cls is Renderer else {}
    r = cls(width=size, height=size, **kw)
    spheres, mat = (sphere_array_test, Material) if cls is Renderer else (j_spheres, JMaterial)
    r.set_scene(spheres("thin_film_thickness", [250.0, 550.0],
                        base=mat(diffuse=0.0, specular=1.0, specular_roughness=0.05),
                        spacing=1.05))
    r.camera.origin = np.asarray([0.0, 0.6, 1.8], np.float32)
    r.camera._update_transform()
    r.set_bg_color((0.9, 0.9, 0.9))
    return r


def _renders(setup, want_clustered):
    j = setup(JRenderer)
    j.use_pallas = False
    cfg = j._config(1, 3)
    assert not cfg.use_fused
    j.render(n_samples=2, max_depth=3)
    t = setup(Renderer)
    assert not t._params(3)["use_fused"]
    assert ("clusters" in t._dev) == want_clustered and t._lobes == cfg.lobes_on
    t.render(n_samples=2, max_depth=3)
    return t.layers, {k: np.asarray(v) for k, v in j.layers.items()}


def _check_slice(got, want):
    """Six layers at 2e-4 and the counters exactly."""
    for key in LAYERS:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=2e-4, atol=2e-4,
                                   err_msg=key)
    for k in ("n_path_vertices", "n_lane_slots"):
        assert float(got[k]) == float(want[k]) > 0, k


def test_many_lights_bluenoise_sun_matches_reference():
    _check_slice(*_renders(_setup_a, False))


def test_thin_film_matches_reference():
    _check_slice(*_renders(_setup_b, True))


def test_progressive_accumulation_is_exact():
    r = _setup_a(Renderer, 16)
    r.render(n_samples=1, max_depth=3)
    r.render(n_samples=1, max_depth=3)
    split = {k: v.clone() for k, v in r.layers.items()}
    r.init_render_states()
    r.render(n_samples=2, max_depth=3)
    for k in LAYERS + ("n_path_vertices", "n_lane_slots"):
        assert torch.equal(split[k], r.layers[k]), k


# ---------------------------------------------------------------------------
# routing


def _route_cases():
    def cornell(cls, mat):
        return cornell_box() if cls is Renderer else j_cornell()

    def lights(n_boxes_faces):
        def scene(cls, mat):
            s = _many_lights_cornell(cornell_box if cls is Renderer else j_cornell, mat)
            s.material_ids[12 + n_boxes_faces:] = 0
            return s
        return scene

    def spheres(cls, mat):
        fn = sphere_array_test if cls is Renderer else j_spheres
        return fn("metalness", [0.0, 1.0], spacing=1.05)

    def film(cls, mat):
        fn = sphere_array_test if cls is Renderer else j_spheres
        return fn("thin_film_thickness", [250.0], base=mat(specular=1.0))

    return {
        "default": (cornell, {}),
        "use_fused_off": (cornell, {"use_fused": False}),
        "bluenoise": (cornell, {"sampler_mode": "bluenoise"}),
        "thin_film": (film, {}),
        "16_lights": (lights(14), {}),
        "17_lights": (lights(15), {}),
        "clustered_hosek_sun": (spheres, {"hosek": True}),
        "clustered_off": (spheres, {"use_fused": False}),
    }


def test_routing_matches_reference():
    """Each case routes alike in both packages (16x16, a multiple of 128
    pixels). At 10x10 the reference's pixel-count gate sends the scene to
    its wavefront while the port keeps the fused pipeline (the two agree
    at 2e-4, tests/test_fused_integrator.py)."""
    for case, (scene_fn, opts) in _route_cases().items():
        routes = []
        for cls, mat in ((JRenderer, JMaterial), (Renderer, Material)):
            r = cls(width=16, height=16, **({"device": "cpu"} if cls is Renderer else {}))
            r.set_scene(scene_fn(cls, mat))
            for k in ("use_fused", "sampler_mode"):
                if k in opts:
                    setattr(r, k, opts[k])
            if opts.get("hosek"):
                r.set_directional_light((2.0, 1.9, 1.8), (0.35, 0.75, 0.3), angle=0.5)
                r.load_arhosek_sky(3.0, 0.3)
            routes.append(r._config(1, 3).use_fused if cls is JRenderer
                          else r._params(3)["use_fused"])
        assert routes[0] == routes[1], (case, routes)
        assert routes[1] == (case in ("default", "16_lights", "clustered_hosek_sun")), case

    j = JRenderer(width=10, height=10)
    j.set_scene(j_cornell())
    t = Renderer(10, 10, device="cpu")
    t.set_scene(cornell_box())
    assert not j._config(1, 3).use_fused and t._params(3)["use_fused"]
