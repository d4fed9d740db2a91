"""Integer hashing primitives over uint32 values held in int64 tensors.

Port of fredholm_tpu/core/rng.py. PyTorch has no usable uint32 arithmetic
(CPU uint32 supports only `*` and `^`), so every uint32 value in this
package lives in an int64 tensor in [0, 2**32) and each operation masks
back to 32 bits. Right shifts of non-negative int64 are logical, which is
what uint32 `>>` is. Products are split into 16-bit halves so no
intermediate leaves int64's range. Results are bit-identical to the
reference's jnp.uint32 arithmetic (and to CUDA's `uint32_t`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MASK = 0xFFFFFFFF

_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393


def u32(x):
    """An integer tensor -> int64 tensor holding its uint32 bits; a Python
    int -> its uint32 bits as a Python int (scalar hashing stays on the
    host, where it launches nothing)."""
    if not isinstance(x, torch.Tensor):
        return int(x) & MASK
    return x.to(torch.int64) & MASK


def mul32(a, b):
    """a * b mod 2**32 for uint32 values (tensors or ints) without
    overflowing int64: (a_lo * b) + ((a_hi * b) << 16), both < 2**49."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def _avalanche(h):
    h = mul32(h ^ (h >> 15), _P2)
    h = mul32(h ^ (h >> 13), _P3)
    return h ^ (h >> 16)


def xxhash32(p):
    """xxhash32 of a single uint32 (shared.h:282-291)."""
    h = (u32(p) + _P5) & MASK
    h = mul32(_rotl(h, 17), _P4)
    return _avalanche(h)


def xxhash32_4(x, y, z, w):
    """xxhash32 of a uint4 (shared.h:306-319)."""
    h = (u32(w) + _P5 + mul32(u32(x), _P3)) & MASK
    h = mul32(_rotl(h, 17), _P4)
    h = (h + mul32(u32(y), _P3)) & MASK
    h = mul32(_rotl(h, 17), _P4)
    h = (h + mul32(u32(z), _P3)) & MASK
    h = mul32(_rotl(h, 17), _P4)
    return _avalanche(h)


def uint_to_unit_float(u):
    """uint32 -> float32 in [0, 1) from the TOP 24 bits (rng.py:65)."""
    return (u32(u) >> 8).to(torch.float32) * (1.0 / 16777216.0)


# Whole-word bit work goes through a [..., 32] plane of 0/1 bits and a
# float64 product with powers of two: a few wide ops rather than a few dozen
# narrow ones (each op is a launch). float64 holds every uint32 exactly.


@functools.lru_cache(maxsize=None)
def pow2(device: torch.device, reverse: bool = False) -> torch.Tensor:
    """[32] float64 on `device`: 2^k at index k (2^(31 - k) if reverse)."""
    k = np.arange(32)
    return torch.as_tensor(np.ldexp(1.0, 31 - k if reverse else k), device=device)


def bits32(x):
    """The 32 bits of uint32 values x [...] as float64 0/1 [..., 32], bit k
    at index k."""
    k = torch.arange(32, dtype=torch.int64, device=x.device)
    return ((x[..., None] >> k) & 1).to(torch.float64)


def reverse_bits(x):
    """Bit reversal of uint32 (sobol.cu:10697-10704): bit k moves to bit
    31 - k."""
    x = u32(x)
    return (bits32(x) @ pow2(x.device, reverse=True)).to(torch.int64)


def laine_karras_permutation(x, seed):
    """Hash-based Owen scrambling permutation (sobol.cu:10706-10715)."""
    x = (u32(x) + u32(seed)) & MASK
    x = x ^ mul32(x, 0x6C50B47C)
    x = x ^ mul32(x, 0xB82F1E52)
    x = x ^ mul32(x, 0xC7AFE638)
    x = x ^ mul32(x, 0x8D22F6E6)
    return x


def hash_combine(seed, v):
    """boost-style hash combine (sobol.cu:10717-10721)."""
    seed = u32(seed)
    v = u32(v)
    return seed ^ ((v + ((seed << 6) & MASK) + (seed >> 2)) & MASK)


def nested_uniform_scramble_base2(x, seed):
    """Owen scrambling of a base-2 radical-inverse point
    (Laine & Karras; sobol.cu:10724-10731)."""
    return reverse_bits(laine_karras_permutation(reverse_bits(x), seed))
