"""Owen-scrambled Sobol sampler over uint32 values in int64 tensors.

Port of fredholm_tpu/sampling/sobol.py (sobol.cu:10661-10742). The
direction-number matrices are the reference's assets/sobol_matrices.npy
([128, 32] uint32), read by path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..assets import asset_path
from ..core.rng import (bits32, hash_combine, nested_uniform_scramble_base2, pow2, u32,
                        uint_to_unit_float)


@functools.lru_cache(maxsize=1)
def sobol_matrices() -> np.ndarray:
    """[SOBOL_DIMS, 32] uint32 direction numbers (host array)."""
    return np.load(asset_path("sobol_matrices.npy"))


@functools.lru_cache(maxsize=None)
def _matrix_bits(dims: tuple, device: torch.device) -> torch.Tensor:
    """[32, 32 * len(dims)] float64 on `device`: entry (k, 32 i + j) is bit
    j of direction number k of dimension dims[i]."""
    mats = sobol_matrices()
    rows = mats[np.asarray(dims) % mats.shape[0]].astype(np.int64)  # [D, 32]
    bits = (rows.T[:, :, None] >> np.arange(32)) & 1                # [32, D, 32]
    return torch.as_tensor(bits.reshape(32, -1).astype(np.float64), device=device)


def _dims(dimension):
    """(dims tuple, whether one int was given)."""
    if isinstance(dimension, (tuple, list)):
        return tuple(int(d) for d in dimension), False
    return (int(dimension),), True


def sobol_uint(index, dimension, scramble=0):
    """XOR-scrambled Sobol sample as uint32 (sobol.cu:10661-10671): the
    XOR of the direction numbers the index's set bits select.

    index: uint32 values in an int64 tensor [...]; dimension: a Python int
    (returns [...]) or a sequence of D of them (returns [..., D], one pass
    for all). Bit j of that XOR is the parity of a 0/1 matrix product,
    which float64 computes exactly (the sums are at most 32)."""
    dims, one = _dims(dimension)
    index = u32(index)
    ones = bits32(index) @ _matrix_bits(dims, index.device)
    word = torch.remainder(ones, 2.0).unflatten(-1, (len(dims), 32)) @ pow2(index.device)
    word = word.to(torch.int64) ^ u32(scramble)
    return word[..., 0] if one else word


def sobol_owen_float(index, dimension, seed):
    """Owen-scrambled Sobol in [0,1) (sobol.cu:10733-10742): the index and
    the output digits are both Laine-Karras scrambled; the per-dimension
    seed is hash_combine(seed, dimension). dimension: a Python int, or a
    sequence of them for one draw each along a new last axis."""
    dims, one = _dims(dimension)
    seed = u32(seed)
    shuffled = nested_uniform_scramble_base2(index, seed)
    raw = sobol_uint(shuffled, dims)
    dim_seeds = [hash_combine(seed, d % (1 << 32)) for d in dims]
    if isinstance(seed, torch.Tensor):
        dim_seeds = torch.stack(dim_seeds, dim=-1)
    else:
        dim_seeds = torch.tensor(dim_seeds, dtype=torch.int64, device=raw.device)
    u = uint_to_unit_float(nested_uniform_scramble_base2(raw, dim_seeds))
    return u[..., 0] if one else u
