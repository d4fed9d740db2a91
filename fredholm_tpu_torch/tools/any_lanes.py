"""Lane counts of the dense any-hit kernel B3.

What `chip_smoke.py` [12] prints about `k_dense_any` (csrc/dense_any.cu)
at each bounce of the wavefront metric, from the triangle tests each lane
takes (accel/dense.py `intersect_any_twin`, stats "lanes"):

- `warp_slots`: the lane slots a schedule of the sweep runs. A warp of 32
  lanes runs as many tests as its slowest lane, so a warp costs 32 slots a
  test of that lane. Schedules: lanes in launch order (the one-thread-a-ray
  design); each block of 256 packing its live lanes (B1's design); and, in
  a block with more than `pack_above` live lanes, packing those still
  searching again after their first `first` tests (the kernel's).
- `bounce_stats`: a bounce's live share, each NEE block's occluded share
  and tests per live lane, and the slots of the three schedules.
- `by_area`: the triangles in the order of their area, largest first: an
  order of the sweep in which large occluders come first.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..accel import dense

# csrc/dense_any.cu kBlock, kPackAbove, kFirst
BLOCK = 256
PACK_ABOVE = 128
FIRST = 8


def _warp_tops(tests: torch.Tensor, left: torch.Tensor, run: torch.Tensor,
               block: int) -> torch.Tensor:
    """Each warp's largest `run` over the lanes of `left`, packed in lane
    order within each block, 32 to a warp."""
    lane = torch.arange(tests.shape[0], device=tests.device)
    before = torch.cumsum(left.to(torch.int64), 0) - left.to(torch.int64)
    blk = lane[left] // block
    pos = before[left] - before[blk * block]
    key = blk * (block // 32) + pos // 32
    n_keys = (tests.shape[0] + block - 1) // block * (block // 32)
    return torch.zeros(n_keys, dtype=torch.int64, device=tests.device).scatter_reduce(
        0, key, run[left], "amax")


def warp_slots(tests: torch.Tensor, block: int = BLOCK, first: Optional[int] = None,
               pack_above: int = 0, packed: bool = True) -> Tuple[int, int]:
    """(slots, warps) of the sweep of lanes with `tests` (int64 [m], 0 on
    a dead lane): slots = 32 x the tests of each warp's slowest lane,
    summed over the warps that run; warps = how many run (a warp packed
    again counts again). packed False: warps are lanes 32k..32k+31 in
    launch order. packed True: each block's live lanes are packed in lane
    order, 32 to a warp; with `first`, a block with more than `pack_above`
    live lanes runs `first` tests, packs the lanes with tests left again,
    and runs them to the end."""
    if not packed:
        pad = (-tests.shape[0]) % 32
        top = torch.nn.functional.pad(tests, (0, pad)).view(-1, 32).amax(dim=1)
        return 32 * int(top.sum()), int((top > 0).sum())
    live = tests > 0
    tops = [_warp_tops(tests, live, tests, block)]
    if first is not None:
        blk = torch.arange(tests.shape[0], device=tests.device) // block
        again = (torch.bincount(blk[live], minlength=int(blk[-1]) + 1) > pack_above)[blk]
        tops = [_warp_tops(tests, live, torch.where(again, torch.clamp(tests, max=first), tests),
                           block),
                _warp_tops(tests, again & (tests > first), tests - first, block)]
    return sum(32 * int(t.sum()) for t in tops), sum(int((t > 0).sum()) for t in tops)


def bounce_stats(tri: torch.Tensor, rays: torch.Tensor,
                 blocks: Sequence[str]) -> Tuple[torch.Tensor, Dict]:
    """(occluded [m], stats) of the rays [7, m] of one any-hit trace, made
    of len(blocks) equal NEE blocks (the wavefront's order: sun, sky,
    area), against tri [9, F], from the twin."""
    m = rays.shape[1]
    st = {"tri": 0}
    occ = dense.intersect_any_twin(tri, rays, m, st)
    tests = st["lanes"]
    live = rays[6, :m] > 0.0
    n_live = int(live.sum())
    n = m // len(blocks)
    out = {"rays": m, "live": n_live / m, "tests": st["tri"],
           "tests_per_live": st["tri"] / max(n_live, 1), "blocks": {}}
    for b, name in enumerate(blocks):
        lv = live[b * n:(b + 1) * n]
        k = max(int(lv.sum()), 1)
        out["blocks"][name] = {
            "occluded": int(occ[b * n:(b + 1) * n][lv].sum()) / k,
            "tests_per_live": int(tests[b * n:(b + 1) * n].sum()) / k}
    schedules = {"launch order": warp_slots(tests, packed=False),
                 "packed": warp_slots(tests),
                 "kernel": warp_slots(tests, first=FIRST, pack_above=PACK_ABOVE)}
    out["slots_per_test"] = {k: s / max(st["tri"], 1) for k, (s, _) in schedules.items()}
    # a warp's largest count, over the warps that run once
    out["warp_max_mean"] = {k: s / 32 / max(w, 1) for k, (s, w) in schedules.items()
                            if k in ("launch order", "packed")}
    return occ, out


def by_area(tri: torch.Tensor) -> torch.Tensor:
    """tri [9, F] (rows v0, e1, e2) with its columns in the order of their
    area, largest first (ties in index order)."""
    area = torch.linalg.norm(torch.cross(tri[3:6].T, tri[6:9].T, dim=1), dim=1)
    order = torch.sort(-area, stable=True).indices
    return tri[:, order].contiguous()
