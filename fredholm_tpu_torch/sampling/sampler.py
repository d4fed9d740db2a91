"""Wavefront sampler state (port of fredholm_tpu/sampling/sampler.py).

The reference's SamplerState (sampling.cu:19-45, shared.h:66-96): 1D
draws from Owen-scrambled Sobol, 2D draws from CMJ. The sequence counters
are uniform across the wavefront (every lane draws in the same order), so
here they are Python ints and the Sobol matrix row of a draw is a host
constant; per-lane fields are uint32 values in int64 tensors
(core/rng.py).

Mode "bluenoise" makes every draw a screen-space blue-noise dithered
Owen-Sobol point (sampling/bluenoise.py); its state carries `bn_shift`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.rng import MASK, mul32, u32, xxhash32
from ..fused.cmappings import draw_cmj_2d
from .bluenoise import blue_noise_1d, bn_shift
from .sobol import sobol_owen_float

MODE_DEFAULT = "sobol_cmj"
MODE_BLUENOISE = "bluenoise"

# 2D blue-noise draws use a dimension band disjoint from the 1D counter
_BN_2D_DIM_BASE = 1 << 10


def init_sampler_state(image_idx, n_spp, n_pixels: int, seed,
                       mode: str = MODE_DEFAULT, width: int = 0) -> Dict:
    """init_sampler_state (pt.cu:378-399). image_idx [N] flat pixel index
    and n_spp [N] the per-pixel sample count (uint32 values in int64),
    n_pixels = width * height, seed a uint32; bluenoise mode needs the
    image width to recover pixel coordinates."""
    image_idx = u32(image_idx)
    n_spp = u32(n_spp)
    seed_hash = int(xxhash32(torch.tensor(int(seed) % (1 << 32))))
    state = {
        "sobol_index": (image_idx + mul32(n_spp, n_pixels % (1 << 32))) & MASK,
        "sobol_dim": 1,
        "sobol_seed": seed_hash,
        "cmj_n_spp": n_spp,
        "cmj_image_idx": image_idx,
        "cmj_depth": 0,
        "cmj_scramble": seed_hash,
    }
    if mode == MODE_BLUENOISE:
        if width <= 0:
            raise ValueError("bluenoise mode needs the image width")
        state["bn_shift"] = bn_shift(image_idx % width, image_idx // width)
    elif mode != MODE_DEFAULT:
        raise ValueError(f"unknown sampler mode {mode!r}")
    return state


def sample_1d_n(state: Dict, k: int) -> Tuple[torch.Tensor, Dict]:
    """The next k Owen-Sobol 1D draws (sampling.cu:19-22) in one pass, as
    [..., k] (dithered in bluenoise mode); the same values k sample_1d
    calls give."""
    dims = tuple(range(state["sobol_dim"], state["sobol_dim"] + k))
    if "bn_shift" in state:
        u = blue_noise_1d(state["bn_shift"], state["cmj_n_spp"], dims, state["sobol_seed"])
    else:
        u = sobol_owen_float(state["sobol_index"], dims, state["sobol_seed"])
    return u, {**state, "sobol_dim": state["sobol_dim"] + k}


def sample_2d_n(state: Dict, k: int) -> Tuple[torch.Tensor, Dict]:
    """The next k CMJ 2D draws (sampling.cu:24-29) in one pass, as
    [..., k, 2] (dithered Sobol pairs in bluenoise mode); the same values
    k sample_2d calls give."""
    depths = range(state["cmj_depth"], state["cmj_depth"] + k)
    if "bn_shift" in state:
        dims = tuple(_BN_2D_DIM_BASE + 2 * c + j for c in depths for j in (0, 1))
        u = blue_noise_1d(state["bn_shift"], state["cmj_n_spp"], dims,
                          state["cmj_scramble"]).unflatten(-1, (k, 2))
    else:
        n_spp = state["cmj_n_spp"]
        depth = torch.tensor(list(depths), dtype=torch.int64, device=n_spp.device)
        u = torch.stack(draw_cmj_2d(n_spp[..., None], state["cmj_image_idx"][..., None], depth,
                                    state["cmj_scramble"]), dim=-1)
    return u, {**state, "cmj_depth": state["cmj_depth"] + k}


def sample_1d(state: Dict) -> Tuple[torch.Tensor, Dict]:
    """Owen-Sobol 1D draw (sampling.cu:19-22); dithered in bluenoise mode."""
    u, state = sample_1d_n(state, 1)
    return u[..., 0], state


def sample_2d(state: Dict) -> Tuple[torch.Tensor, Dict]:
    """CMJ 2D draw (sampling.cu:24-29) as [..., 2]; a dithered Sobol pair
    in bluenoise mode."""
    u, state = sample_2d_n(state, 1)
    return u[..., 0, :], state


def sample_3d(state: Dict) -> Tuple[torch.Tensor, Dict]:
    """CMJ 3D draw (sampling.cu:31-37)."""
    u, state = sample_2d_n(state, 2)
    return torch.cat([u[..., 0, :], u[..., 1, :1]], dim=-1), state


def sample_4d(state: Dict) -> Tuple[torch.Tensor, Dict]:
    """CMJ 4D draw (sampling.cu:39-45)."""
    u, state = sample_2d_n(state, 2)
    return u.flatten(-2), state
