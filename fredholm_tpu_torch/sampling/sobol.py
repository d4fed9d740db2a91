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
from ..core.rng import hash_combine, nested_uniform_scramble_base2, u32, uint_to_unit_float


@functools.lru_cache(maxsize=1)
def sobol_matrices() -> np.ndarray:
    """[SOBOL_DIMS, 32] uint32 direction numbers (host array)."""
    return np.load(asset_path("sobol_matrices.npy"))


def sobol_uint(index, dimension: int, scramble=0):
    """XOR-scrambled Sobol sample as uint32 (sobol.cu:10661-10671).

    index: uint32 values in an int64 tensor; dimension: python int."""
    mats = sobol_matrices()
    row = mats[int(dimension) % mats.shape[0]]
    index = u32(index)
    result = torch.zeros_like(index) + u32(scramble, index.device)
    for k in range(mats.shape[1]):
        bit = (index >> k) & 1
        result = result ^ (bit * int(row[k]))
    return result


def sobol_owen_float(index, dimension: int, seed):
    """Owen-scrambled Sobol in [0,1) (sobol.cu:10733-10742): the index and
    the output digits are both Laine-Karras scrambled; the per-dimension
    seed is hash_combine(seed, dimension)."""
    seed = u32(seed, index.device)
    shuffled = nested_uniform_scramble_base2(index, seed)
    raw = sobol_uint(shuffled, dimension)
    dim_u32 = int(dimension) % (1 << 32)
    scrambled = nested_uniform_scramble_base2(raw, hash_combine(seed, dim_u32))
    return uint_to_unit_float(scrambled)
