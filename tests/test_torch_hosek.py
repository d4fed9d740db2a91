"""The Hosek sky, the sun and the clustered slice as a whole.

- Host: `cook_state` and the sun elevation equal the reference's; the
  scalar packing with a sun and a Hosek sky equals `pack_scalars`.
- `eval_sky_c` (Hosek) against the reference's on random directions at
  rtol 2e-6: XLA:CPU contracts the coefficient sum's products into FMAs,
  and its terms of mixed sign cancel (measured 1.27e-6). The grazing
  directions cos_g = +-1 with c8 = +-1 hit the reference's 1e-8 floor of
  mie_b, which both keep.
- The pipeline bodies of a clustered render with the sun block and the
  metal/specular lobes, replayed through the reference's bodies.
- The slice: `fredholm_tpu_torch.Renderer(device="cpu")` renders the small
  terrain under Hosek(3.0, 0.3) and the bench's sun like
  `fredholm_tpu.Renderer` on its plain path (use_pallas=False: jnp BVH
  traversal), all six layers at rtol = atol = 2e-4 and n_path_vertices
  exactly. One beauty pixel of the 256 may exceed 2e-4 (it must stay
  within 1%): at depth 3 one path's third bounce diverges, which renders
  at depth 1 and 2 do not show, so it is one ulp of a bounce direction
  (XLA:CPU's FMA contraction) choosing another triangle of the displaced
  terrain; the traces themselves agree on every ray (traversal is checked
  in test_torch_clustered.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fredholm_tpu.camera import Camera as JCamera
from fredholm_tpu.fused import pt_fused as jpf
from fredholm_tpu.fused.cvec import V3 as JV3
from fredholm_tpu.renderer import Renderer as JRenderer
from fredholm_tpu.scene.procedural import terrain as j_terrain
from fredholm_tpu.sky import hosek as jh
from fredholm_tpu_torch import Camera, Renderer, _build
from fredholm_tpu_torch.fused import pt_fused as tpf
from fredholm_tpu_torch.fused.cvec import V3
from fredholm_tpu_torch.scene.procedural import terrain
from fredholm_tpu_torch.sky import hosek as th

from test_torch_cache import (  # noqa: F401 (autouse)
    cached, release_compiled_programs)
from test_torch_shade import _compare, _to_jax

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

LAYERS = ("beauty", "position", "normal", "depth", "texcoord", "albedo")
SUN = (0.35, 0.75, 0.3)


def _sun():
    d = np.asarray(SUN, np.float32)
    return d / max(np.linalg.norm(d), 1e-12)


@pytest.mark.parametrize("turbidity,albedo", [(3.0, 0.3), (1.0, 0.0), (7.5, 1.0), (10.0, 0.5)])
def test_cook_state_matches(turbidity, albedo):
    elev = th.sun_elevation_from_direction(_sun())
    assert elev == jh.sun_elevation_from_direction(_sun())
    got = th.cook_state(turbidity, albedo, elev)
    want = jh.cook_state(turbidity, albedo, elev)
    for k in ("configs", "radiances"):
        assert got[k].dtype == np.float32
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


def _sky_scalars(sky_intensity=1.0):
    state = th.cook_state(3.0, 0.3, th.sun_elevation_from_direction(_sun()))
    params = {"camera": Camera().device_params("cpu"), "seed": 1,
              "sun_direction": _sun(), "hosek": state, "sky_intensity": sky_intensity,
              "directional_light": {"le": np.asarray([2.0, 1.9, 1.8], np.float32),
                                    "dir": _sun(), "angle": np.float32(0.5)}}
    return params, tpf.pack_scalars(params, 64, "cpu")


def test_pack_scalars_with_sky_and_sun_matches():
    params, (sv, usv) = _sky_scalars(0.05)
    jparams = {**params, "camera": JCamera().device_params(),
               "seed": jnp.uint32(1), "hosek": {k: jnp.asarray(v) for k, v in params["hosek"].items()}}
    jsv, jusv = jpf.pack_scalars(jparams, 64)
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jsv))
    np.testing.assert_array_equal(usv.numpy().astype(np.uint32), np.asarray(jusv))


def _eval_both(sv, v):
    cfg = tpf.FusedConfig(8, 8, 3, 0, ("diffuse_r",), sky_mode=tpf.SKY_HOSEK)
    jcfg = jpf.FusedConfig(8, 8, 3, jpf.SKY_HOSEK, False, 0, ("diffuse_r",))
    got = tpf.eval_sky_c(cfg, sv, V3(*torch.as_tensor(v)))
    want = jpf.eval_sky_c(jcfg, jnp.asarray(sv.numpy()), JV3(*jnp.asarray(v)))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_hosek_sky_matches_on_random_directions():
    _, (sv, _) = _sky_scalars(0.7)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, 20000)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0)
    got, want = _eval_both(sv, v)
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and g.max() > 1.0
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=0.0)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_hosek_mie_floor_at_grazing_sun(sign):
    """cos_g = +-1 with c8 = +-1 makes 1 + c8^2 - 2 c8 cos_g exactly 0; the
    floor keeps mie_m finite (2 / (1e-8 * 1e-4)) in the twin and in the
    reference."""
    params, (sv, _) = _sky_scalars()
    sv = sv.clone()
    for ch in range(3):
        sv[tpf._SV["hosek_cfg"] + 9 * ch + 8] = sign
    v = (sign * _sun())[:, None].repeat(2, axis=1).astype(np.float32)
    cos_g = float((sv[19:22].numpy() * v[:, 0]).sum())
    assert abs(cos_g) == pytest.approx(1.0, abs=1e-6)
    got, want = _eval_both(sv, v)
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.isfinite(w).all()
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=0.0)
    assert tpf._acos_poly(torch.tensor([1.0, -1.0])).tolist() == [0.0, float(np.float32(np.pi))]


@pytest.mark.parametrize("n_lights", [0, 2])
@pytest.mark.parametrize("d", [0, 1, 4])
def test_config_with_sun_matches(n_lights, d):
    t = tpf.FusedConfig(8, 8, 5, n_lights, ("diffuse_r",), sky_mode=tpf.SKY_HOSEK, has_dl=True)
    j = jpf.FusedConfig(8, 8, 5, jpf.SKY_HOSEK, True, n_lights, ("diffuse_r",))
    assert t.nee_blocks == tuple(j.nee_blocks)
    assert t.occ_blocks(True) == tuple(jpf._occ_blocks(j, True))
    assert t.occ_blocks(False) == ()
    assert t.blocks[:len(t.occ_blocks(True))] == t.occ_blocks(True)
    for slot in range(5):
        assert t.sobol_dim(d, slot) == j.sobol_dim(d, slot)
        assert t.cmj_depth(d, slot) == j.cmj_depth(d, slot)


# ---------------------------------------------------------------------------
# the slice: one port render (its body calls recorded) and one reference
# render of the small terrain under the Hosek sky and the sun


def _setup(cls, scene, **kw):
    r = cls(width=16, height=16, **kw)
    r.set_scene(scene)
    # the eye sits ~1 behind the origin, looking nearly straight down:
    # most primaries hit the 6 x 6 terrain
    r.camera.origin = np.asarray([0.0, 1.6, 0.3], np.float32)
    r.camera.look_around(0.0, 850.0)
    r.set_directional_light([2.0, 1.9, 1.8], SUN, angle=0.5)
    r.load_arhosek_sky(turbidity=3.0, albedo=0.3)
    return r


@pytest.fixture(scope="module")
def port_render():
    calls = []
    orig = {k: getattr(tpf, k) for k in ("mega_body", "final_resolve_body")}

    def recorder(name):
        def rec(*a):
            r = orig[name](*a)
            calls.append((name, a, r))
            return r
        return rec

    t = _setup(Renderer, terrain(n=48, size=6.0), device="cpu")
    _build.LAUNCHES.clear()
    try:
        for k in orig:
            setattr(tpf, k, recorder(k))
        t.render(n_samples=2, max_depth=3)
    finally:
        for k, v in orig.items():
            setattr(tpf, k, v)
    return t, calls, dict(_build.LAUNCHES)


@pytest.fixture(scope="module")
def reference_layers(tmp_path_factory):
    def render():
        j = _setup(JRenderer, j_terrain(n=48, size=6.0))
        j.use_pallas = False
        cfg = j._config(1, 3)
        assert cfg.use_fused and not cfg.use_dense and cfg.lobes_on == ("specular", "diffuse_r")
        j.render(n_samples=2, max_depth=3)
        return {k: np.asarray(v) for k, v in j.layers.items()}

    return cached(tmp_path_factory, "hosek_terrain_layers", ("terrain48", SUN, 2, 3), render)


def test_render_went_through_the_clustered_path(port_render):
    t, _, launches = port_render
    assert "clusters" in t._dev and "tri_soa" not in t._dev
    # per spp at depth 3: closest + fetch at every bounce, any-hit at
    # bounces 1-2 and the final (no emissive face: no final closest trace)
    assert launches["clustered_closest_twin"] == 2 * 3
    assert launches["slot_fetch_twin"] == 2 * 3
    assert launches["clustered_any_twin"] == 2 * 3
    assert launches["mega_twin"] == 6 and launches["final_twin"] == 2
    assert not launches.get("dense_closest_twin")
    assert (t.layers["depth"] > 0).float().mean() > 0.85


@pytest.mark.parametrize("index", range(4))
def test_bodies_match_reference(port_render, index):
    _, calls, _ = port_render
    name, args, got = calls[index if index < 3 else -1]
    cfg = args[0]
    jcfg = jpf.FusedConfig(cfg.width, cfg.height, cfg.max_depth, cfg.sky_mode,
                           cfg.has_dl, cfg.n_lights, cfg.lobes_on)
    assert cfg.has_dl and cfg.sky_mode == jpf.SKY_HOSEK
    want = getattr(jpf, name)(jcfg, *_to_jax(args[1:]))
    _compare(got, want)


@pytest.mark.parametrize("key", LAYERS)
def test_slice_matches_reference(port_render, reference_layers, key):
    got = port_render[0].layers[key].numpy()
    want = reference_layers[key]
    bad = ~np.isclose(got, want, rtol=2e-4, atol=2e-4)
    bad_px = bad.reshape(got.shape[0], -1).any(axis=1)
    assert bad_px.sum() <= (1 if key == "beauty" else 0), np.nonzero(bad_px)[0]
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-4, err_msg=key)


def test_slice_path_vertices_match(port_render, reference_layers):
    got = float(port_render[0].layers["n_path_vertices"])
    assert got == float(reference_layers["n_path_vertices"]) > 0
