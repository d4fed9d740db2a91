"""Triangle cluster hierarchy (host numpy).

Port of fredholm_tpu/accel/cluster.py:33-545: the SAH BVH is cut into

  instance  ->  supercluster (<= 128 clusters)  ->  cluster (<= 128 tris)
            ->  16-triangle group

and laid out as flat tables the clustered traversal kernels walk
(accel/clustered.py, csrc/clustered.cu). The tables are byte-equal to
the reference's for the same BVH, so hit slots (cid * 128 + k) mean the
same in both packages. The refit cache of the reference is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .bvh import BVH

CLUSTER_SIZE = 128
# blocks rows: v0.xyz, e1.xyz, e2.xyz, prim id, then rows 10-15 hold the
# 16-triangle group AABBs (component c of group g at [10 + c, cid*128 + g])
TRI_COMPONENTS = 16
TRI_GROUP = 16
N_TRI_GROUPS = CLUSTER_SIZE // TRI_GROUP
# member clusters of a supercluster sit in one 128-column group of cl_meta
SC_GROUP = 128
SC_TARGET_MEMBERS = 32
# cl_meta rows: lo.xyz (0-2), hi.xyz (3-5), tri count (6), cluster id (7)
CL_META_ROWS = 8
# visit orders: axis * 2 + sign
N_ORDERS = 6
# consecutive superclusters of a visit order that share one region AABB
# (the reference's default FREDHOLM_TRAV_REG)
REG_SIZE = 4


@dataclasses.dataclass
class Hierarchy:
    """One BLAS: superclusters over clusters over a contiguous tri order.

    sc_aabb [6, S] f32; sc_mcount [S] i32; sc_order / sc_key [6, S]
    front-to-back visit orders and their sorted keys; cl_meta [8, S*128]
    f32 member AABBs, counts and cluster ids; blocks [16, K*128] f32
    triangle SoA; reg_aabb [6, 6*R] region unions; root_lo/hi [3]."""

    sc_aabb: np.ndarray
    sc_mcount: np.ndarray
    sc_order: np.ndarray
    sc_key: np.ndarray
    cl_meta: np.ndarray
    blocks: np.ndarray
    root_lo: np.ndarray
    root_hi: np.ndarray
    reg_aabb: np.ndarray

    @property
    def n_superclusters(self) -> int:
        return int(self.sc_mcount.shape[0])

    @property
    def n_clusters(self) -> int:
        return int(self.blocks.shape[1] // CLUSTER_SIZE)


def _subtree_ranges(bvh: BVH):
    """Per-node (prim count, prim range start, cluster count), filled by
    one reverse sweep (children have larger ids than parents)."""
    n = bvh.n_nodes
    counts = np.zeros(n, np.int64)
    starts = np.zeros(n, np.int64)
    n_cl = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        if bvh.left[i] < 0:
            counts[i] = bvh.leaf_count[i]
            starts[i] = bvh.leaf_start[i]
            n_cl[i] = 1
        else:
            l, r = bvh.left[i], bvh.right[i]
            counts[i] = counts[l] + counts[r]
            starts[i] = min(starts[l], starts[r])
            n_cl[i] = 1 if counts[i] <= CLUSTER_SIZE else n_cl[l] + n_cl[r]
    return counts, starts, n_cl


def _cut(bvh: BVH, root: int, keep) -> List[int]:
    """DFS cut of `root`'s subtree at the first nodes where keep(node)."""
    out: List[int] = []
    stack = [root]
    while stack:
        node = stack.pop()
        if keep(node) or bvh.left[node] < 0:
            out.append(node)
        else:
            stack.append(int(bvh.right[node]))
            stack.append(int(bvh.left[node]))
    return out


def extract_hierarchy(bvh: BVH, tri_v0, tri_e1, tri_e2, prim_ids=None) -> Hierarchy:
    """Cut the BVH into superclusters and clusters; prim_ids maps a local
    triangle index to the id recorded in blocks row 9 (default: itself)."""
    counts, starts, n_cl = _subtree_ranges(bvh)
    sc_nodes = _cut(bvh, 0, lambda node: n_cl[node] <= SC_TARGET_MEMBERS)

    s = len(sc_nodes)
    sc_aabb = np.zeros((6, s), np.float32)
    sc_mcount = np.zeros((s,), np.int32)
    cl_meta = np.zeros((CL_META_ROWS, s * SC_GROUP), np.float32)
    # empty member slots must fail every slab test
    cl_meta[0:3, :] = 1e30
    cl_meta[3:6, :] = -1e30

    cluster_nodes: List[int] = []
    for si, node in enumerate(sc_nodes):
        sc_aabb[0:3, si] = bvh.bounds_min[node]
        sc_aabb[3:6, si] = bvh.bounds_max[node]
        members = _cut(bvh, node, lambda m: counts[m] <= CLUSTER_SIZE)
        assert len(members) <= SC_GROUP
        sc_mcount[si] = len(members)
        base = si * SC_GROUP
        for j, m in enumerate(members):
            cl_meta[0:3, base + j] = bvh.bounds_min[m]
            cl_meta[3:6, base + j] = bvh.bounds_max[m]
            cl_meta[6, base + j] = counts[m]
            cl_meta[7, base + j] = len(cluster_nodes)
            cluster_nodes.append(m)

    k = len(cluster_nodes)
    perm = np.full((k * CLUSTER_SIZE,), -1, np.int64)
    for ci, node in enumerate(cluster_nodes):
        st, c = int(starts[node]), int(counts[node])
        perm[ci * CLUSTER_SIZE: ci * CLUSTER_SIZE + c] = bvh.prim_order[st:st + c]

    sc_order, sc_key = _direction_orders(sc_aabb)
    return Hierarchy(
        sc_aabb=sc_aabb,
        sc_mcount=sc_mcount,
        sc_order=sc_order,
        sc_key=sc_key,
        cl_meta=cl_meta,
        blocks=_fill_blocks(perm, tri_v0, tri_e1, tri_e2, prim_ids),
        root_lo=bvh.bounds_min[0].astype(np.float32).copy(),
        root_hi=bvh.bounds_max[0].astype(np.float32).copy(),
        reg_aabb=_region_tables(sc_aabb, sc_order),
    )


def _fill_blocks(perm, tri_v0, tri_e1, tri_e2, prim_ids=None) -> np.ndarray:
    """[16, n_slots] triangle-block SoA from the slot -> prim permutation
    (-1 pads): triangles, prim ids, and the 16-triangle group AABBs."""
    if prim_ids is None:
        prim_ids = np.arange(tri_v0.shape[0], dtype=np.int64)
    n_slots = perm.shape[0]
    blocks = np.zeros((TRI_COMPONENTS, n_slots), np.float32)
    filled = perm >= 0
    p = np.where(filled, perm, 0)
    v0 = tri_v0[p].astype(np.float32)
    e1c = tri_e1[p].astype(np.float32)
    e2c = tri_e2[p].astype(np.float32)
    m = filled[None, :]
    blocks[0:3] = np.where(m, v0.T, 0.0)
    blocks[3:6] = np.where(m, e1c.T, 0.0)
    blocks[6:9] = np.where(m, e2c.T, 0.0)
    blocks[9] = np.where(filled, prim_ids[p].astype(np.float32), -1.0)
    # padded slots contribute (+big, -big) so empty groups fail every slab
    lo3 = np.minimum(np.minimum(v0, v0 + e1c), v0 + e2c)
    hi3 = np.maximum(np.maximum(v0, v0 + e1c), v0 + e2c)
    lo3 = np.where(filled[:, None], lo3, 1e30)
    hi3 = np.where(filled[:, None], hi3, -1e30)
    n_groups = n_slots // TRI_GROUP
    glo = lo3.reshape(n_groups, TRI_GROUP, 3).min(axis=1)
    ghi = hi3.reshape(n_groups, TRI_GROUP, 3).max(axis=1)
    k = n_slots // CLUSTER_SIZE
    cols = (np.arange(k)[:, None] * CLUSTER_SIZE + np.arange(N_TRI_GROUPS)).ravel()
    blocks[10:13, :] = 1e30
    blocks[13:16, :] = -1e30
    blocks[10:13, cols] = glo.reshape(k * N_TRI_GROUPS, 3).T
    blocks[13:16, cols] = ghi.reshape(k * N_TRI_GROUPS, 3).T
    return blocks


def _direction_orders(sc_aabb: np.ndarray):
    """Front-to-back supercluster visit orders per direction class
    (key = lo[axis] for sign 0, -hi[axis] for sign 1; stable sort)."""
    s = sc_aabb.shape[1]
    sc_order = np.zeros((N_ORDERS, s), np.int32)
    sc_key = np.zeros((N_ORDERS, s), np.float32)
    for axis in range(3):
        for sign in range(2):
            o = axis * 2 + sign
            key = sc_aabb[axis] if sign == 0 else -sc_aabb[3 + axis]
            order = np.argsort(key, kind="stable").astype(np.int32)
            sc_order[o] = order
            sc_key[o] = key[order]
    return sc_order, sc_key


def n_regions(n_sc: int) -> int:
    return -(-n_sc // REG_SIZE)


def _region_tables(sc_aabb: np.ndarray, sc_order: np.ndarray) -> np.ndarray:
    """Union AABBs over REG_SIZE runs of each visit order; (order o,
    region r) at column o * R + r of a [6, N_ORDERS * R] table."""
    s = sc_aabb.shape[1]
    r = n_regions(s)
    reg = np.zeros((6, N_ORDERS * r), np.float32)
    pad = r * REG_SIZE - s
    for o in range(N_ORDERS):
        ids = sc_order[o]
        plo = np.concatenate([sc_aabb[0:3][:, ids], np.full((3, pad), 1e30, np.float32)],
                             axis=1).reshape(3, r, REG_SIZE)
        phi = np.concatenate([sc_aabb[3:6][:, ids], np.full((3, pad), -1e30, np.float32)],
                             axis=1).reshape(3, r, REG_SIZE)
        reg[0:3, o * r:(o + 1) * r] = plo.min(axis=2)
        reg[3:6, o * r:(o + 1) * r] = phi.max(axis=2)
    return reg


def _transform_aabb(lo: np.ndarray, hi: np.ndarray, m4: np.ndarray):
    """World AABB of an object-space AABB under an affine transform."""
    pts = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
        np.float32,
    )
    m4 = np.asarray(m4, np.float32)
    w = pts @ m4[:3, :3].T + m4[:3, 3]
    return w.min(axis=0), w.max(axis=0)


@dataclasses.dataclass
class TLAS:
    """Concatenated BLAS tables plus the instance table: inst_aabb [6, I]
    world AABBs, inst_minv [12, I] world -> object affine rows, inst_sc
    [3, I] int32 (supercluster base, count, region base)."""

    sc_aabb: np.ndarray
    sc_mcount: np.ndarray
    sc_order: np.ndarray
    sc_key: np.ndarray
    cl_meta: np.ndarray
    blocks: np.ndarray
    inst_aabb: np.ndarray
    inst_minv: np.ndarray
    inst_sc: np.ndarray
    inst_identity: bool
    reg_aabb: np.ndarray

    @property
    def n_instances(self) -> int:
        return int(self.inst_aabb.shape[1])

    @property
    def n_superclusters(self) -> int:
        return int(self.sc_mcount.shape[0])


def _bases(blas_list: Sequence[Hierarchy]):
    """Each BLAS's first supercluster, cluster and region in the TLAS."""
    nb = len(blas_list)
    sc_base = np.zeros(nb, np.int64)
    cl_base = np.zeros(nb, np.int64)
    reg_base = np.zeros(nb, np.int64)
    for b in range(1, nb):
        sc_base[b] = sc_base[b - 1] + blas_list[b - 1].n_superclusters
        cl_base[b] = cl_base[b - 1] + blas_list[b - 1].n_clusters
        reg_base[b] = reg_base[b - 1] + n_regions(blas_list[b - 1].n_superclusters)
    return sc_base, cl_base, reg_base


def _instance_arrays(blas_list: Sequence[Hierarchy],
                     instances: Sequence[Tuple[int, np.ndarray]]):
    """The TLAS's per-instance arrays (inst_aabb, inst_minv, inst_sc) and
    whether every transform is the identity (cluster.py:463-481)."""
    sc_base, _, reg_base = _bases(blas_list)
    n_i = len(instances)
    inst_aabb = np.zeros((6, n_i), np.float32)
    inst_minv = np.zeros((12, n_i), np.float32)
    inst_sc = np.zeros((3, n_i), np.int32)
    identity = True
    for i, (b, m4) in enumerate(instances):
        h = blas_list[b]
        m4 = np.asarray(m4, np.float32)
        lo, hi = _transform_aabb(h.root_lo, h.root_hi, m4)
        inst_aabb[0:3, i] = lo
        inst_aabb[3:6, i] = hi
        inst_minv[:, i] = np.linalg.inv(m4)[:3, :].reshape(-1)
        inst_sc[:, i] = (sc_base[b], h.n_superclusters, reg_base[b])
        if not np.allclose(m4, np.eye(4), atol=1e-7):
            identity = False
    return inst_aabb, inst_minv, inst_sc, identity


def build_tlas(blas_list: Sequence[Hierarchy],
               instances: Sequence[Tuple[int, np.ndarray]]) -> TLAS:
    """instances: (blas index, object-to-world 4x4) pairs."""
    assert blas_list and instances
    sc_base, cl_base, reg_base = _bases(blas_list)

    metas = []
    for b, h in enumerate(blas_list):
        m = h.cl_meta.copy()
        m[7, :] += np.float32(cl_base[b])
        metas.append(m)
    r_total = int(reg_base[-1]) + n_regions(blas_list[-1].n_superclusters)
    reg_aabb = np.zeros((6, N_ORDERS * r_total), np.float32)
    for o in range(N_ORDERS):
        off = 0
        for h in blas_list:
            rb = n_regions(h.n_superclusters)
            reg_aabb[:, o * r_total + off:o * r_total + off + rb] = \
                h.reg_aabb[:, o * rb:(o + 1) * rb]
            off += rb

    inst_aabb, inst_minv, inst_sc, identity = _instance_arrays(blas_list, instances)
    return TLAS(
        sc_aabb=np.concatenate([h.sc_aabb for h in blas_list], axis=1),
        sc_mcount=np.concatenate([h.sc_mcount for h in blas_list]),
        sc_order=np.concatenate(
            [h.sc_order + np.int32(sc_base[b]) for b, h in enumerate(blas_list)], axis=1),
        sc_key=np.concatenate([h.sc_key for h in blas_list], axis=1),
        cl_meta=np.concatenate(metas, axis=1),
        blocks=np.concatenate([h.blocks for h in blas_list], axis=1),
        inst_aabb=inst_aabb,
        inst_minv=inst_minv,
        inst_sc=inst_sc,
        inst_identity=identity,
        reg_aabb=reg_aabb,
    )


def update_tlas_instances(tlas: TLAS, blas_list: Sequence[Hierarchy],
                          instances: Sequence[Tuple[int, np.ndarray]]) -> TLAS:
    """O(I) instance move (cluster.py:498-545): a TLAS with new
    per-instance arrays over the same geometry tables (shared, not
    copied). accel/clustered.py `move_instances` then refreshes only the
    instance entries and the root box of the prepared tables."""
    assert len(instances) == tlas.n_instances
    inst_aabb, inst_minv, inst_sc, identity = _instance_arrays(blas_list, instances)
    return dataclasses.replace(tlas, inst_aabb=inst_aabb, inst_minv=inst_minv, inst_sc=inst_sc,
                               inst_identity=identity)
