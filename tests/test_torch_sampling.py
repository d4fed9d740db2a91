"""The port's uint32 hashing, Sobol, CMJ and sample mappings must match
fredholm_tpu bit for bit (integers) and to 1e-7 (floats), including
index values at the int32/uint32 boundaries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fredholm_tpu.core import rng as jrng
from fredholm_tpu.fused import cmappings as jmap
from fredholm_tpu.sampling import cmj as jcmj
from fredholm_tpu.sampling import sobol as jsobol
from fredholm_tpu_torch.core import rng as trng
from fredholm_tpu_torch.fused import cmappings as tmap
from fredholm_tpu_torch.sampling import cmj as tcmj
from fredholm_tpu_torch.sampling import sobol as tsobol
from test_torch_cache import release_compiled_programs  # noqa: F401 (autouse)

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

EDGES = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0xDEADBEEF, 12345]


def _u32(seed, n=509):
    vals = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    return np.concatenate([np.asarray(EDGES, np.uint64), vals]).astype(np.uint32)


def _j(x):
    return jnp.asarray(x, jnp.uint32)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.uint32).astype(np.int64))


def _eq_u32(t_out, j_out):
    np.testing.assert_array_equal(
        t_out.numpy().astype(np.uint64), np.asarray(j_out).astype(np.uint64)
    )


@pytest.mark.parametrize("name", [
    "xxhash32", "reverse_bits", "uint_to_unit_float",
])
def test_rng_unary(name):
    x = _u32(1)
    out_t = getattr(trng, name)(_t(x))
    out_j = getattr(jrng, name)(_j(x))
    if out_t.dtype == torch.float32:
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0, atol=1e-7)
        assert out_t.max() < 1.0
    else:
        _eq_u32(out_t, out_j)


@pytest.mark.parametrize("name", [
    "laine_karras_permutation", "hash_combine", "nested_uniform_scramble_base2",
])
def test_rng_binary(name):
    x, s = _u32(2), _u32(3)
    _eq_u32(getattr(trng, name)(_t(x), _t(s)), getattr(jrng, name)(_j(x), _j(s)))


def test_rotl_and_xxhash32_4():
    x, y, z, w = (_u32(k) for k in (4, 5, 6, 7))
    for r in (1, 13, 17, 31):
        _eq_u32(trng._rotl(_t(x), r), jrng._rotl(_j(x), r))
    _eq_u32(trng.xxhash32_4(_t(x), _t(y), _t(z), _t(w)),
            jrng.xxhash32_4(_j(x), _j(y), _j(z), _j(w)))


def test_mul32_wraps_like_uint32():
    a, b = _u32(8), _u32(9)
    _eq_u32(trng.mul32(_t(a), _t(b)), _j(a) * _j(b))


@pytest.mark.parametrize("dim", [0, 1, 5, 31, 127, 128, 300])
def test_sobol(dim):
    idx, seed = _u32(10), _u32(11)
    _eq_u32(tsobol.sobol_uint(_t(idx), dim), jsobol.sobol_uint(_j(idx), dim))
    np.testing.assert_allclose(
        tsobol.sobol_owen_float(_t(idx), dim, _t(seed)).numpy(),
        np.asarray(jsobol.sobol_owen_float(_j(idx), dim, _j(seed))),
        rtol=0, atol=1e-7,
    )


@pytest.mark.parametrize("l", [4, 16])
def test_cmj_permute_and_randfloat(l):
    i, p = _u32(12), _u32(13)
    _eq_u32(tcmj.cmj_permute_pow2(_t(i), l, _t(p)), jcmj.cmj_permute_pow2(_j(i), l, _j(p)))
    np.testing.assert_allclose(
        tcmj.cmj_randfloat(_t(i), _t(p)).numpy(),
        np.asarray(jcmj.cmj_randfloat(_j(i), _j(p))), rtol=0, atol=1e-7,
    )


@pytest.mark.parametrize("depth", [0, 1, 7, 40])
def test_draw_cmj_2d_and_sobol_1d(depth):
    n_spp, image_idx, seed = _u32(14), _u32(15), _u32(16)
    fx_t, fy_t = tmap.draw_cmj_2d(_t(n_spp), _t(image_idx), depth, _t(seed))
    fx_j, fy_j = jmap.draw_cmj_2d(_j(n_spp), _j(image_idx), depth, _j(seed))
    np.testing.assert_allclose(fx_t.numpy(), np.asarray(fx_j), rtol=0, atol=1e-7)
    np.testing.assert_allclose(fy_t.numpy(), np.asarray(fy_j), rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        tmap.draw_sobol_1d(_t(image_idx), depth, _t(seed)).numpy(),
        np.asarray(jmap.draw_sobol_1d(_j(image_idx), depth, _j(seed))),
        rtol=0, atol=1e-7,
    )


def _unit_pairs(seed, n=1021):
    u = np.random.default_rng(seed).uniform(0, 1, (2, n)).astype(np.float32)
    u[:, :4] = [[0.5, 0.0, 0.999999, 0.5], [0.5, 0.0, 0.25, 0.999999]]
    return u


def test_disk_hemisphere_triangle():
    u0, u1 = _unit_pairs(17)
    tx, ty = tmap.sample_concentric_disk(torch.as_tensor(u0), torch.as_tensor(u1))
    jx, jy = jmap.sample_concentric_disk(jnp.asarray(u0), jnp.asarray(u1))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-7)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-7)
    th = tmap.sample_cosine_weighted_hemisphere(torch.as_tensor(u0), torch.as_tensor(u1))
    jh = jmap.sample_cosine_weighted_hemisphere(jnp.asarray(u0), jnp.asarray(u1))
    np.testing.assert_allclose(th.x.numpy(), np.asarray(jh.x), rtol=0, atol=1e-7)
    np.testing.assert_allclose(th.z.numpy(), np.asarray(jh.z), rtol=0, atol=1e-7)
    # y = sqrt(1 - x^2 - z^2) scales a one-ulp cos/sin difference by
    # 1/(2y) near the rim; y^2 is a difference of O(1) terms, each carrying
    # one ulp (6e-8) of that difference, so it is held to 3e-7
    np.testing.assert_allclose(th.y.numpy() ** 2, np.asarray(jh.y) ** 2, rtol=0, atol=3e-7)
    for a, b in zip(tmap.sample_triangle(torch.as_tensor(u0), torch.as_tensor(u1)),
                    jmap.sample_triangle(jnp.asarray(u0), jnp.asarray(u1))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)


def test_vndf():
    from fredholm_tpu.fused.cvec import V3 as JV3
    from fredholm_tpu_torch.fused.cvec import V3 as TV3

    rng = np.random.default_rng(18)
    wo = rng.normal(size=(3, 1021)).astype(np.float32)
    wo[1] = np.abs(wo[1]) + 1e-3
    wo /= np.linalg.norm(wo, axis=0)
    ax, ay = rng.uniform(0.01, 1.0, (2, 1021)).astype(np.float32)
    u0, u1 = _unit_pairs(19)
    out_t = tmap.sample_vndf(TV3(*map(torch.as_tensor, wo)), torch.as_tensor(ax),
                             torch.as_tensor(ay), torch.as_tensor(u0), torch.as_tensor(u1))
    out_j = jmap.sample_vndf(JV3(*map(jnp.asarray, wo)), jnp.asarray(ax),
                             jnp.asarray(ay), jnp.asarray(u0), jnp.asarray(u1))
    # composite of cos/sin, three sqrt and two normalizes: one-ulp trig
    # differences between torch and XLA grow to a few 1e-7 here
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)
