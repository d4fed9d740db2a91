"""The port's FMA-chain probe (P1) against the reference's Pallas kernel
(tools/probe_bf16.py `make_fma_kernel`, interpret mode), at the
reference's tile shapes: [8, 128] float32 and [16, 128] bfloat16.

Both bit-equal. The twin rounds each step once, as the card's fmaf and
__hfma2 do, and XLA:CPU contracts the interpreted kernel's a * c + d into
one FMA. In bfloat16 the reference's C rounds to 1 and D is below half an
ulp, so only the seeds and the sum are seen there; the twin's rounding
(`fma_rn`) is checked on its own, and a bit-equal check is shown to see
one missing step of the chain, with the reference's constants in float32
and BF16_MOVE in bfloat16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fredholm_tpu_torch import _build
from fredholm_tpu_torch.tools import probe_bf16 as probe
from test_torch_cache import release_compiled_programs  # noqa: F401 (autouse)

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    # the reference tool points JAX's compile cache at a fixed directory
    # when imported; keep the suite's own
    cache = jax.config.jax_compilation_cache_dir
    from tools import probe_bf16 as ref

    jax.config.update("jax_compilation_cache_dir", cache)
    return ref


@pytest.mark.parametrize("dtype, rows", [("float32", 8), ("bfloat16", 16)])
def test_fma_chain_twin_matches_reference(reference, dtype, rows):
    assert (reference.UNROLL, reference.CHAINS, reference.INNER) == \
        (probe.UNROLL, probe.CHAINS, probe.INNER)
    x = np.random.default_rng(0).uniform(-2.0, 2.0, (rows, 128)).astype(np.float32)
    want = reference.make_fma_kernel(getattr(jnp, dtype), rows)(
        jnp.asarray(x, getattr(jnp, dtype)))
    want = np.asarray(want.astype(jnp.float32))
    _build.LAUNCHES.clear()
    got = probe.fma_chain(torch.tensor(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (rows, 128)
    assert _build.LAUNCHES == {"probe_fma_twin": 1}
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert probe.FLOPS_PER_ELEMENT == 2 * (512 + 7 * 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fma_rn_rounds_once(dtype):
    """fma_rn against a * c + d computed exactly and rounded once: in
    long double for float32 (the product takes 48 bits, the sum fits the
    64-bit significand at these magnitudes), in float32 for bfloat16 (the
    exact value fits 24 bits for |a| in [1, 16) and d = 2^-10, so its
    round-to-nearest-even to bfloat16 is the one rounding)."""
    rng = np.random.default_rng(3)
    tdt = getattr(torch, dtype)
    if dtype == "float32":
        a = rng.uniform(-9.0, 9.0, 100_000).astype(np.float32)
        c, d = np.float32(probe.C), np.float32(probe.D)
        want = (np.longdouble(a) * np.longdouble(c) + np.longdouble(d)).astype(np.float32)
        want = torch.tensor(want)
    else:
        a = torch.tensor(rng.uniform(1.0, 16.0, 100_000) * rng.choice([-1.0, 1.0], 100_000),
                         dtype=torch.float32).to(tdt).float().numpy()
        c, d = probe.BF16_MOVE
        exact = a.astype(np.float64) * c + d
        assert np.array_equal(exact.astype(np.float32).astype(np.float64), exact)
        want = torch.tensor(exact.astype(np.float32)).to(tdt)
    got = probe.fma_rn(torch.tensor(a).to(tdt), float(c), float(d))
    assert got.dtype == tdt
    assert torch.equal(got, want)
    # two roundings (product, then sum) differ from one on some lanes
    two = torch.tensor(a).to(tdt) * torch.tensor(float(c), dtype=tdt) + \
        torch.tensor(float(d), dtype=tdt)
    assert not torch.equal(two, want)


@pytest.mark.parametrize("dtype, c, d", [("float32", probe.C, probe.D),
                                         ("bfloat16", *probe.BF16_MOVE)])
def test_bit_equal_check_sees_one_step(dtype, c, d):
    """Every step moves the chains: the chain one step short differs from
    the full one on most lanes, so a kernel that drops a step (or the
    loop's tail) fails the bit-equal check of chip_smoke.py."""
    x = probe.fma_inputs(16, getattr(torch, dtype), "cpu")
    full = probe.fma_chain_twin(x, c, d)
    for steps, share in ((probe.STEPS - 1, 0.85), (probe.STEPS - (probe.INNER - 1), 0.99)):
        short = probe.fma_chain_twin(x, c, d, steps)
        assert (short != full).float().mean().item() >= share, steps
