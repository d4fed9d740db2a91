"""Wavefront compaction around the fused pipeline's traces (port of
fredholm_tpu/experimental/compact.py).

Live lanes (tmax > 0) move to the front of a trace's rays and dead lanes
to the back, each keeping its order; the trace runs on the packed rays
and its results return to the original lane order. A lane's hit does not
depend on the other lanes, so compact -> trace -> restore gives the same
bits as tracing in place.

The permutation is a stable binary partition from one int32 cumsum, no
sort: dest[i] is lane i's place among its class (live first), which is
both the scatter index that packs the rays and the gather index that
restores the results. The int planes (prim, inst, slot) move as int32:
the reference carries them in float32 rows, a TPU gather workaround.

Gate: FREDHOLM_COMPACT = "0" (off, the default) | "1" (every scene) |
"auto" (clustered scenes only); the Renderer reads it into its params
(renderer.py:533).
"""

from __future__ import annotations

import os
from typing import Dict

import torch

ENV = "FREDHOLM_COMPACT"
MODES = ("0", "1", "auto")


def mode() -> str:
    """The gate's value (compact.py:43-44)."""
    m = os.environ.get(ENV, "0")
    if m not in MODES:
        raise ValueError(f"{ENV} must be one of {MODES}, got {m!r}")
    return m


def enabled(m: str, dense: bool) -> bool:
    """Whether traces compact under mode m on a dense or clustered scene
    (compact.py:45-51)."""
    if m not in MODES:
        raise ValueError(f"compaction mode must be one of {MODES}, got {m!r}")
    return m == "1" or (m == "auto" and not dense)


def partition_dest(alive: torch.Tensor) -> torch.Tensor:
    """Stable binary-partition destinations, int32 [M]: live lanes keep
    their order at the front, dead lanes theirs at the back."""
    a = alive.to(torch.int32)
    ca = torch.cumsum(a, 0, dtype=torch.int32)
    cd = torch.cumsum(1 - a, 0, dtype=torch.int32)
    return torch.where(alive, ca - 1, ca[-1] + cd - 1)


def compact_rays(dest: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """The [7, M] rays in live-first order: out[:, dest[i]] = rays[:, i]."""
    out = torch.empty_like(rays)
    out[:, dest.long()] = rays
    return out


def uncompact_hits(dest: torch.Tensor, res: Dict) -> Dict:
    """A closest-hit result back in the original lane order."""
    idx = dest.long()
    return {k: v[idx] for k, v in res.items()}


def uncompact_occ(dest: torch.Tensor, occluded: torch.Tensor) -> torch.Tensor:
    """An any-hit result back in the original lane order."""
    return occluded[dest.long()]
