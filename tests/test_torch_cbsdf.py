"""The port's component-form BSDF (all seven lobes) must match
fredholm_tpu.fused.cbsdf on random wavefronts, for each lobe set:
setup, eval and eval_pdf at rtol = atol = 1e-5. sample() draws its
microfacet directions through cos/sin, whose one-ulp differences between
torch and XLA grow at grazing angles (f reaches 1e3-1e4 there), so its
outputs are held to the bar tests/test_fused_math.py sets between the
reference's own two BSDF forms (rtol 2e-4, atol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fredholm_tpu.fused import cbsdf as jb
from fredholm_tpu.fused.cvec import V3 as JV3
from fredholm_tpu_torch.fused import cbsdf as tb
from fredholm_tpu_torch.fused.cvec import V3 as TV3
from test_torch_cache import release_compiled_programs  # noqa: F401 (autouse)

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

N = 257
TOL = dict(rtol=1e-5, atol=1e-5)
SAMPLE_TOL = dict(rtol=2e-4, atol=1e-4)

LOBE_SETS = [
    ("diffuse_r",),
    ("specular", "diffuse_r"),
    ("coat",), ("metal",), ("specular",), ("transmission",), ("sheen",),
    ("diffuse_t",),
    tb.ALL_LOBES,
]


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def unit(hemi=False):
        v = rng.normal(size=(3, N)).astype(np.float32)
        if hemi:
            v[1] = np.abs(v[1]) + 1e-3
        return v / np.linalg.norm(v, axis=0)

    def s(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, N).astype(np.float32)

    def c():
        return rng.uniform(0, 1, (3, N)).astype(np.float32)

    sp = {
        "base_color": c(), "diffuse": s(), "diffuse_roughness": s(),
        "specular": s(), "specular_color": c(),
        "specular_roughness": s(0.05, 1.0), "metalness": s(), "coat": s(),
        "coat_roughness": s(0.05, 1.0), "coat_color": c(),
        "transmission": s(), "transmission_color": c(), "sheen": s(),
        "sheen_color": c(), "sheen_roughness": s(0.05, 1.0),
        "subsurface": s(),
        "subsurface_color": c(),
        "thin_walled": (s() > 0.5).astype(np.float32),
    }
    return {
        "sp": sp, "wo": unit(True), "wi": unit(), "entering": s() > 0.3,
        "u": s(), "v0": s(), "v1": s(),
    }


def _jax(x):
    if isinstance(x, np.ndarray) and x.ndim == 2:
        return JV3(*map(jnp.asarray, x))
    return jnp.asarray(x)


def _torch(x):
    if isinstance(x, np.ndarray) and x.ndim == 2:
        return TV3(*map(torch.as_tensor, x))
    return torch.as_tensor(x)


def _close(a, b, what, tol=TOL):
    if isinstance(a, tuple):
        for k, (ai, bi) in enumerate(zip(a, b)):
            _close(ai, bi, f"{what}[{k}]", tol)
        return
    np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what, **tol)


@pytest.mark.parametrize("lobes_on", LOBE_SETS, ids=lambda ls: "+".join(ls))
def test_setup_eval_pdf_sample_match(lobes_on):
    x = _inputs(7)
    ctx_j = jb.setup(_jax(x["wo"]), {k: _jax(v) for k, v in x["sp"].items()},
                     jnp.asarray(x["entering"]), lobes_on)
    ctx_t = tb.setup(_torch(x["wo"]), {k: _torch(v) for k, v in x["sp"].items()},
                     torch.as_tensor(x["entering"]), lobes_on)
    for key in ("pmf", "coat_albedo", "spec_albedo", "sheen_albedo",
                "coat_absorption", "metal_n", "metal_k", "eta"):
        _close(ctx_t[key], ctx_j[key], key)

    wo_t, wi_t = _torch(x["wo"]), _torch(x["wi"])
    wo_j, wi_j = _jax(x["wo"]), _jax(x["wi"])
    _close(tb.eval(ctx_t, wo_t, wi_t), jb.eval(ctx_j, wo_j, wi_j), "eval")
    _close(tb.eval_pdf(ctx_t, wo_t, wi_t), jb.eval_pdf(ctx_j, wo_j, wi_j), "eval_pdf")

    out_t = tb.sample(ctx_t, wo_t, *(_torch(x[k]) for k in ("u", "v0", "v1")))
    out_j = jb.sample(ctx_j, wo_j, *(_jax(x[k]) for k in ("u", "v0", "v1")))
    for name, a, b in zip(("wi", "f", "pdf"), out_t, out_j):
        _close(a, b, "sample " + name, SAMPLE_TOL)


def test_lut_fetches_match():
    x = _inputs(8)
    rough = x["sp"]["specular_roughness"]
    f0 = np.full(N, 0.04, np.float32)
    np.testing.assert_allclose(
        tb.compute_directional_albedo_reflection(
            _torch(x["wo"]), _torch(rough), _torch(f0)).numpy(),
        np.asarray(jb.compute_directional_albedo_reflection(
            _jax(x["wo"]), _jax(rough), _jax(f0))), **TOL)
    np.testing.assert_allclose(
        tb.compute_directional_albedo_sheen(_torch(x["wo"]), _torch(rough)).numpy(),
        np.asarray(jb.compute_directional_albedo_sheen(_jax(x["wo"]), _jax(rough))),
        **TOL)


def test_luts_are_the_reference_assets():
    from fredholm_tpu.bsdf import lut as jlut
    from fredholm_tpu_torch.bsdf import lut as tlut

    np.testing.assert_array_equal(tlut.reflection_lut_np(), jlut.reflection_lut_np())
    np.testing.assert_array_equal(tlut.sheen_lut_np(), jlut.sheen_lut_np())
