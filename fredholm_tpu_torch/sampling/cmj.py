"""Correlated multi-jittered sampling (Kensler 2013) over uint32 values in
int64 tensors. Port of fredholm_tpu/sampling/cmj.py (cmj.cu)."""

from __future__ import annotations

import torch

from ..core.rng import MASK, mul32, u32

CMJ_M = 4
CMJ_N = 4


def cmj_permute_pow2(i, l: int, p):
    """Kensler permute for power-of-two l (single pass; cmj.cu:12-43)."""
    assert l & (l - 1) == 0
    w = l - 1
    i = u32(i)
    p = u32(p)
    i = i ^ p
    i = mul32(i, 0xE170893D)
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = mul32(i, 0x0929EB3F)
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = mul32(i, 1 | (p >> 27))
    i = mul32(i, 0x6935FA69)
    i = i ^ ((i & w) >> 11)
    i = mul32(i, 0x74DCB303)
    i = i ^ ((i & w) >> 2)
    i = mul32(i, 0x9E501CC3)
    i = i ^ ((i & w) >> 2)
    i = mul32(i, 0xC860A3DF)
    i = i & w
    i = i ^ (i >> 5)
    return ((i + p) & MASK) % l


def cmj_randfloat(i, p):
    """Hash-based jitter float in [0,1) from the top 24 bits
    (cmj.cu:45-58; see core/rng.uint_to_unit_float)."""
    i = u32(i)
    p = u32(p)
    i = i ^ p
    i = i ^ (i >> 17)
    i = i ^ (i >> 10)
    i = mul32(i, 0xB36534E5)
    i = i ^ (i >> 12)
    i = i ^ (i >> 21)
    i = mul32(i, 0x93FC4795)
    i = i ^ 0xDF6E307F
    i = i ^ (i >> 17)
    i = mul32(i, 1 | (p >> 18))
    return (i >> 8).to(torch.float32) * (1.0 / 16777216.0)
