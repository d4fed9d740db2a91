"""Binned-SAH BVH builder (host numpy).

Port of the numpy path of fredholm_tpu/accel/bvh.py:65-230
(`build_bvh(..., prefer_native=False, thread=False)`): the same binning,
split rule and node numbering, so its output is byte-equal to the
reference's numpy builder. The port traverses through the cluster
hierarchy (accel/cluster.py) only, so it builds no skip-link threadings,
and it cannot load the reference's native builder, whose output differs
from the numpy builder's (tests/test_torch_clustered.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

N_BINS = 16
LEAF_SIZE = 4


@dataclasses.dataclass
class BVH:
    """Flattened BVH in SoA layout.

    bounds_min/max: [n, 3] float32; left/right: [n] int32 child ids (-1
    for leaves); leaf_start/leaf_count: [n] int32 ranges into prim_order;
    axis: [n] int32 split axis; prim_order: [F] int32 triangle order
    (leaf ranges are contiguous in it)."""

    bounds_min: np.ndarray
    bounds_max: np.ndarray
    left: np.ndarray
    right: np.ndarray
    leaf_start: np.ndarray
    leaf_count: np.ndarray
    axis: np.ndarray
    prim_order: np.ndarray

    @property
    def n_nodes(self) -> int:
        return int(self.bounds_min.shape[0])


def _sah_split(lo, hi, c, count):
    """Best (axis, bin) of the binned SAH over all three axes, or (-1, -1)
    when every centroid coincides; also returns the bin indices."""
    c_min = c.min(axis=0)
    c_max = c.max(axis=0)
    extent = c_max - c_min
    best_cost = np.inf
    best_axis = -1
    best_split = -1
    scale = np.where(extent > 0.0, N_BINS / np.maximum(extent, 1e-30), 0.0)
    bin_idx_all = np.minimum(((c - c_min) * scale).astype(np.int32), N_BINS - 1)
    for ax in range(3):
        if extent[ax] <= 0.0:
            continue
        b = bin_idx_all[:, ax]
        counts = np.bincount(b, minlength=N_BINS)
        bl = np.full((N_BINS, 3), np.inf, np.float32)
        bh = np.full((N_BINS, 3), -np.inf, np.float32)
        np.minimum.at(bl, b, lo)
        np.maximum.at(bh, b, hi)
        cl = np.minimum.accumulate(bl, axis=0)
        ch = np.maximum.accumulate(bh, axis=0)
        cr_l = np.minimum.accumulate(bl[::-1], axis=0)[::-1]
        cr_h = np.maximum.accumulate(bh[::-1], axis=0)[::-1]
        n_l = np.cumsum(counts)
        n_r = count - n_l

        def area(lo_, hi_):
            d = np.maximum(hi_ - lo_, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        # split after bin s (s in [0, N_BINS-2])
        cost = area(cl[:-1], ch[:-1]) * n_l[:-1] + area(cr_l[1:], cr_h[1:]) * n_r[:-1]
        cost = np.where((n_l[:-1] == 0) | (n_r[:-1] == 0), np.inf, cost)
        s = int(np.argmin(cost))
        if cost[s] < best_cost:
            best_cost = cost[s]
            best_axis = ax
            best_split = s
    return best_axis, best_split, bin_idx_all


def build_bvh(tri_lo: np.ndarray, tri_hi: np.ndarray, leaf_size: int = LEAF_SIZE) -> BVH:
    """Build from per-triangle AABBs [F, 3] (float32)."""
    f = tri_lo.shape[0]
    if f <= 0:
        raise ValueError("build_bvh needs at least one triangle")
    centroid = 0.5 * (tri_lo + tri_hi)
    order = np.arange(f, dtype=np.int64)
    bounds_min, bounds_max = [], []
    lefts, rights, leaf_starts, leaf_counts, axes = [], [], [], [], []

    def new_node():
        for lst, v in ((bounds_min, None), (bounds_max, None), (lefts, -1),
                       (rights, -1), (leaf_starts, 0), (leaf_counts, 0), (axes, 0)):
            lst.append(v)
        return len(lefts) - 1

    # explicit stack of (node_id, start, end) over `order`
    stack = [(new_node(), 0, f)]
    while stack:
        node, start, end = stack.pop()
        idx = order[start:end]
        lo = tri_lo[idx]
        hi = tri_hi[idx]
        bounds_min[node] = lo.min(axis=0)
        bounds_max[node] = hi.max(axis=0)
        count = end - start
        if count <= leaf_size:
            leaf_starts[node] = start
            leaf_counts[node] = count
            continue

        best_axis, best_split, bin_idx_all = _sah_split(lo, hi, centroid[idx], count)
        mid = start + count // 2  # coincident centroids: median split
        if best_axis >= 0:
            go_left = bin_idx_all[:, best_axis] <= best_split
            n_left = int(go_left.sum())
            if 0 < n_left < count:
                # stable partition of the order slice
                order[start:end] = np.concatenate([idx[go_left], idx[~go_left]])
                mid = start + n_left

        axes[node] = best_axis if best_axis >= 0 else 0
        left = new_node()
        right = new_node()
        lefts[node] = left
        rights[node] = right
        stack.append((right, mid, end))
        stack.append((left, start, mid))

    return BVH(
        bounds_min=np.stack(bounds_min).astype(np.float32),
        bounds_max=np.stack(bounds_max).astype(np.float32),
        left=np.asarray(lefts, np.int32),
        right=np.asarray(rights, np.int32),
        leaf_start=np.asarray(leaf_starts, np.int32),
        leaf_count=np.asarray(leaf_counts, np.int32),
        axis=np.asarray(axes, np.int32),
        prim_order=order.astype(np.int32),
    )
