"""Lane counts of mega's full and textured variants.

What `chip_smoke.py` [20] prints about `k_mega_full` (csrc/shade.cu) at
transmission_rough's d = 1, and [23] about `k_mega_tex` on the texture
setups, computed with the stage twins' own code from the inputs the
kernel gets:

- `shading_lanes`: the lanes that shade bounce d (alive, and their ray
  hit): past d = 0, those the variant queues for its shading pass; its
  floor pass runs the others with `alive` false at compile time.
- `eval_lobes`: each lane's `BsdfFull::eval_lobes`, the lobes of
  `lobes_on` whose guard holds (cbsdf._lobe_evals), from the twin's
  setup of the lane's hit.
- `warp_lobe_stats`: over warps of 32 lanes in lane order, how many
  distinct `eval_lobes` sets a warp's shading lanes have, and how many
  lobes their union holds: the branches `bsdf_eval` runs for that warp.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..fused import cbsdf
from ..fused import pt_fused as pf
from ..fused.cvec import V3, cross, dot, normalize


def shading_lanes(cfg: pf.FusedConfig, state: torch.Tensor, tr: pf.Traced, n: int,
                  d: int) -> torch.Tensor:
    """[n] bool: the lanes that shade bounce d, alive in `state` (packed
    [ST_ROWS, n]) with a hit in the radiance block (csrc/shade.cu
    `shades`)."""
    j = (0 if d == 0 else cfg.blocks.index("rad")) - tr.n_occ(n)
    return (state[pf.ST_ALIVE] != 0.0) & (tr.hits["prim"][j * n:(j + 1) * n] >= 0)


def eval_lobes(cfg: pf.FusedConfig, tables: Dict, state: torch.Tensor, tr: pf.Traced,
               n: int, d: int) -> torch.Tensor:
    """[n] int64: bit k set where lobe cbsdf.ALL_LOBES[k] is in
    cfg.lobes_on and its guard holds at the lane's hit, the guards of
    cbsdf._lobe_evals on the twin's setup (csrc/common.cuh
    `bsdf_setup_full`, `eval_lobes`). The guards do not read wo."""
    _, rattr = tr.closest(0 if d == 0 else cfg.blocks.index("rad"), n, tables, cfg)
    fv0, fv1, fv2 = (pf._attr3(rattr, k) for k in ("v0", "v1", "v2"))
    n_g = normalize(cross(fv1 - fv0, fv2 - fv0), eps=1e-20)
    direction = V3(*(state[pf.ST_D + c] for c in range(3)))
    entering = dot(-direction, n_g) > 0.0
    one = torch.ones_like(direction.x)
    ctx = cbsdf.setup(V3(0.0 * one, one, 0.0 * one), pf._shading_params_from_attr(rattr),
                      entering, cfg.lobes_on)
    sp = ctx["sp"]
    guards = {
        "coat": sp["coat"] * ctx["coat_lum"] > 0.0,
        "metal": sp["metalness"] > 0.0,
        "specular": sp["specular"] * ctx["spec_lum"] > 0.0,
        "transmission": sp["transmission"] > 0.0,
        "sheen": sp["sheen"] * ctx["sheen_lum"] > 0.0,
        "diffuse_t": sp["subsurface"] * sp["thin_walled"] > 0.0,
        "diffuse_r": sp["diffuse"] > 0.0,
    }
    bits = torch.zeros(n, dtype=torch.int64, device=state.device)
    for k, lobe in enumerate(cbsdf.ALL_LOBES):
        if lobe in cfg.lobes_on:
            bits |= guards[lobe].to(torch.int64) << k
    return bits


def warp_lobe_stats(bits: torch.Tensor, shading: torch.Tensor, warp: int = 32) -> Dict:
    """Over warps of `warp` lanes in lane order (the last one padded with
    lanes that shade nothing): the warps holding a shading lane, their
    shading lanes, the distinct `bits` sets among those lanes, and the
    lobe count of the sets' union (means over those warps, and maxima)."""
    pad = (-bits.numel()) % warp
    b = torch.cat([bits, bits.new_zeros(pad)]).view(-1, warp)
    s = torch.cat([shading, shading.new_zeros(pad)]).view(-1, warp)
    seen = torch.zeros(b.shape[0], 1 << len(cbsdf.ALL_LOBES), dtype=torch.bool,
                       device=b.device)
    rows = torch.arange(b.shape[0], device=b.device)[:, None].expand_as(b)
    seen[rows[s], b[s]] = True
    union = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    for k in range(len(cbsdf.ALL_LOBES)):
        union += ((((b >> k) & 1) != 0) & s).any(1).to(torch.int64)
    live = s.any(1)
    n_live = max(int(live.sum()), 1)
    distinct = seen.sum(1)
    return {
        "warps": int(b.shape[0]),
        "warps_shading": int(live.sum()),
        "shading_lanes": int(s.sum()),
        "lanes_per_warp_mean": float(s.sum(1)[live].sum()) / n_live,
        "distinct_sets_mean": float(distinct[live].sum()) / n_live,
        "distinct_sets_max": int(distinct.max()),
        "union_lobes_mean": float(union[live].sum()) / n_live,
        "union_lobes_max": int(union.max()),
        "sets": {int(v): int((b[s] == v).sum()) for v in torch.unique(b[s]).tolist()},
    }
