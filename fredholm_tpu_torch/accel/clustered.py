"""Clustered closest-hit and any-hit traversal (scenes above 1024 faces).

Wrappers of the CUDA kernels in csrc/clustered.cu (the port of
fredholm_tpu/accel/pallas_clustered.py `_make_kernel`, closest and
any-hit) and their plain PyTorch twins. Both walk the hierarchy of the
reference's tables (accel/cluster.py):

  instance AABB -> supercluster AABB -> member-cluster AABB (cl_meta)
    -> 16-triangle group AABB (blocks rows 10-15) -> triangles

with the reference's slab test, its root-box clamp of the initial best t
and its Moller-Trumbore test. Each ray visits an instance's
superclusters front to back in the visit order of its own direction
class (`sc_order`, `sc_key`: dominant axis and sign of its object-space
direction) and leaves the instance at the first order position whose key
bound lies beyond its best t. The bound is computed as the slab test
computes that box's entry along the axis, so it only skips boxes whose
slab gate would fail: the exit changes no result. The twin walks each
ray as one lane would; the kernels walk it with a whole warp and give
the same bits.

Contract, independent of visit order: closest hit is the valid hit below
the lane's root-clamped tmax with the smallest (t, inst, slot), compared
in that order; any-hit is whether such a hit exists. The slab gate is
inclusive (tn <= best t), so it never prunes a box that holds a tied
lower (inst, slot).

Rays are a [7, M] float32 view (rows ox, oy, oz, dx, dy, dz, tmax; unit
column stride). Closest returns {t, prim, u, v, inst, slot} with prim =
-1, slot = -1, u = v = 0, inst = 0 and t = tmax on a miss or a dead lane
(tmax <= 0). Any-hit returns a bool [M]. The wrappers run the twins for
CPU tensors only; for CUDA tensors they launch a kernel or raise.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .. import _build
from .cluster import CLUSTER_SIZE, N_ORDERS, N_TRI_GROUPS, SC_GROUP, TLAS, TRI_GROUP
from .dense import moller_trumbore

# the reference's supercluster ceiling for the clustered path
# (fredholm_tpu/renderer.py:509)
MAX_SUPERCLUSTERS = 4096
# slots are int32 ids; keep them exact in the float32 planes they meet
MAX_SLOTS = 1 << 24

# the reference's gate of the ray-resident traversal (experimental/resident.py)
RESIDENT_ENV = "FREDHOLM_TRAV_RESIDENT"

# the reference-layout tables (pallas_clustered.py:129-168): the twins,
# B7 and the bounds read them
_TABLE_KEYS = ("root_aabb", "sc_aabb", "sc_mcount", "sc_order", "sc_key", "cl_meta",
               "blocks", "inst_aabb", "inst_minv", "inst_sc")
# the kernels' records (built from those tables by `card_records`): a box
# is two float4s (lo.xyz + a word, hi.xyz + a word), a triangle three
_RECORD_KEYS = ("inst_rec", "inst_xf", "sc_rec", "cl_rec", "grp_rec", "tri_rec")
_INT_KEYS = ("sc_mcount", "sc_order", "inst_sc")

# rays a block of csrc/clustered.cu (kBlock)
BLOCK = 256


def stage_bytes(c: Dict) -> int:
    """The shared memory a block of the staged kernels takes for the
    tables c (supercluster and member-cluster records, the visit orders
    and keys), 0 where they do not fit and the kernels read them from
    global memory. The kernel library decides (csrc/clustered.cu)."""
    return int(_build.lib().fh_clustered_stage_bytes(c["sc_rec"].shape[0],
                                                     c["cl_rec"].shape[0]))


def _box_records(lo: np.ndarray, w0: np.ndarray, hi: np.ndarray, w1: np.ndarray) -> np.ndarray:
    """[N, 8] float32 records lo.xyz, w0, hi.xyz, w1 from [3, N] corners
    and [N] words (int32 words keep their bits)."""
    n = lo.shape[1]
    rec = np.zeros((n, 8), np.float32)
    rec[:, 0:3] = lo.T
    rec[:, 4:7] = hi.T
    for col, w in ((3, w0), (7, w1)):
        rec[:, col] = w.view(np.float32) if w.dtype == np.int32 else w
    return rec


def card_records(tlas: TLAS) -> Dict[str, np.ndarray]:
    """The kernels' records, holding the reference's table entries byte for
    byte (int32 entries as their bits):

    inst_rec [I, 8]  inst_aabb lo, inst_sc[0] (supercluster base), hi,
                     inst_sc[1] (count)
    inst_xf  [I, 12] inst_minv, one row of 12 an instance
    sc_rec   [S, 8]  sc_aabb lo, sc_mcount, hi, the index in cl_rec of its
                     first member
    cl_rec   [C, 8]  the members of every supercluster in turn: cl_meta
                     lo, count (row 6), hi, cluster id (row 7)
    grp_rec  [C*8, 8]   the 16-triangle group boxes (blocks rows 10-15),
                     words 0
    tri_rec  [C*128, 12] v0 (rows 0-2), prim (row 9), e1, 0, e2, 0
    """
    n_sc = tlas.sc_mcount.shape[0]
    mcount = tlas.sc_mcount.astype(np.int32)
    first = (np.cumsum(mcount) - mcount).astype(np.int32)
    cols = np.concatenate([s * SC_GROUP + np.arange(mcount[s]) for s in range(n_sc)])
    cl = tlas.cl_meta[:, cols]
    blocks = tlas.blocks
    n_slots = blocks.shape[1]
    gcols = (np.arange(n_slots // CLUSTER_SIZE)[:, None] * CLUSTER_SIZE
             + np.arange(N_TRI_GROUPS)).ravel()
    zeros = np.zeros(gcols.shape[0], np.float32)
    tri = np.zeros((n_slots, 12), np.float32)
    tri[:, 0:3] = blocks[0:3].T
    tri[:, 3] = blocks[9]
    tri[:, 4:7] = blocks[3:6].T
    tri[:, 8:11] = blocks[6:9].T
    return {
        **_instance_records(tlas),
        "sc_rec": _box_records(tlas.sc_aabb[0:3], mcount, tlas.sc_aabb[3:6], first),
        "cl_rec": _box_records(cl[0:3], cl[6], cl[3:6], cl[7]),
        "grp_rec": _box_records(blocks[10:13, gcols], zeros, blocks[13:16, gcols], zeros),
        "tri_rec": tri,
    }


def _instance_records(tlas: TLAS) -> Dict[str, np.ndarray]:
    """inst_rec and inst_xf of `card_records`."""
    return {
        "inst_rec": _box_records(tlas.inst_aabb[0:3], tlas.inst_sc[0].astype(np.int32),
                                 tlas.inst_aabb[3:6], tlas.inst_sc[1].astype(np.int32)),
        "inst_xf": np.ascontiguousarray(tlas.inst_minv.T, dtype=np.float32),
    }


def _root_aabb(inst_aabb: np.ndarray) -> np.ndarray:
    """World-space union of the instance AABBs: every lane's initial best t
    clamps to its exit distance from this box."""
    root = np.zeros((6, 8), np.float32)
    root[0:3, 0] = np.asarray(inst_aabb[0:3]).min(axis=1)
    root[3:6, 0] = np.asarray(inst_aabb[3:6]).max(axis=1)
    return root


def move_instances(c: Dict, tlas: TLAS) -> Dict:
    """Prepared tables c with the instance entries of tlas (a TLAS over the
    same geometry, accel/cluster.py `update_tlas_instances`): inst_aabb,
    inst_minv, inst_sc, their records, the root box and the identity flag
    are uploaded anew; every other table is c's own tensor."""
    device = c["inst_rec"].device
    tables = {"root_aabb": _root_aabb(tlas.inst_aabb), "inst_aabb": tlas.inst_aabb,
              "inst_minv": tlas.inst_minv, "inst_sc": tlas.inst_sc, **_instance_records(tlas)}
    out = dict(c)
    out.update({k: torch.tensor(np.ascontiguousarray(v), device=device)
                for k, v in tables.items()})
    _check_tables(out)
    out["identity"] = bool(tlas.inst_identity)
    return out


def prepare_clustered(tlas: TLAS, device) -> Dict:
    """The TLAS tables as tensors on `device` (pallas_clustered.py:129-168),
    the kernels' records (`card_records`), and the host facts the wrappers
    need."""
    if tlas.n_superclusters > MAX_SUPERCLUSTERS:
        raise NotImplementedError(
            f"{tlas.n_superclusters} superclusters > {MAX_SUPERCLUSTERS}: the "
            "reference leaves the clustered path there, and so does the port")
    if tlas.blocks.shape[1] > MAX_SLOTS:
        raise NotImplementedError(f"more than {MAX_SLOTS} triangle slots")
    tables = {"root_aabb": _root_aabb(tlas.inst_aabb),
              **{k: getattr(tlas, k) for k in _TABLE_KEYS[1:]}, **card_records(tlas)}
    out = {k: torch.tensor(np.ascontiguousarray(v), device=device) for k, v in tables.items()}
    _check_tables(out)
    out["identity"] = bool(tlas.inst_identity)
    out["n_instances"] = tlas.n_instances
    if tlas.n_instances == 1 and os.environ.get(RESIDENT_ENV, "0") == "1":
        # single-instance scenes also carry the ray-resident traversal's
        # dense-by-cid tables (pallas_clustered.py:141-147), only when its
        # gate is on
        from ..experimental.resident import prepare_resident

        out.update(prepare_resident(tlas, device))
    return out


# ---------------------------------------------------------------------------
# plain twins


def _inv_dir(d):
    eps = 1e-12
    return 1.0 / torch.where(torch.abs(d) < eps, torch.where(d < 0, -eps, eps), d)


def _slab_t(box, o, inv):
    """Slab entry and exit distances (tn, tf) of rays (origins o, inverse
    directions inv; 3 tensors each) against box (lo.xyz, hi.xyz), in the
    evaluation order of pallas_clustered `_slab`; lanes broadcast against
    boxes."""
    t1 = [(box[k] - o[k]) * inv[k] for k in range(3)]
    t2 = [(box[3 + k] - o[k]) * inv[k] for k in range(3)]
    tn = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]), torch.minimum(t1[1], t2[1])),
                       torch.minimum(t1[2], t2[2]))
    tf = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]), torch.maximum(t1[1], t2[1])),
                       torch.maximum(t1[2], t2[2]))
    return tn, tf


def _slab(box, o, inv, t_best):
    """pallas_clustered `_slab`: the box gate of lanes with running best t."""
    tn, tf = _slab_t(box, o, inv)
    return (tn <= tf) & (tf >= 0.0) & (tn <= t_best)


def order_class(d):
    """A ray's visit order (axis * 2 + sign) from its direction d (a triple
    of tensors): the dominant axis, x before y before z on equal
    magnitudes (pallas_clustered.py:568-586, per ray), and whether d runs
    down it."""
    a = [torch.abs(x) for x in d]
    ax = torch.where((a[0] >= a[1]) & (a[0] >= a[2]), 0, torch.where(a[1] >= a[2], 1, 2))
    dax = torch.where(ax == 0, d[0], torch.where(ax == 1, d[1], d[2]))
    return 2 * ax + (dax < 0.0).to(ax.dtype)


def walk_cluster(blocks, base: int, cnt: int, o, d, inv, entry_t, any_hit: bool,
                 count: bool = False, tie_ok=None):
    """The kernels' walk of one cluster's 16-triangle groups (triangle
    columns base.. of `blocks`, cnt of them) for L lanes: origins o,
    directions d, inverse directions inv (triples of [L]), running best t
    entry_t [L]; tie_ok [L] (closest hit; default none): the lane's best
    hit so far has a higher (inst, slot) than this cluster's, so a hit at
    exactly entry_t wins. Each group is gated by its box against the best
    t the earlier groups left, its triangles by the (t, slot) rule. The
    cluster's 128 triangles are tested at once and the walk replayed in
    group order, which gives the sequential result exactly.

    Returns (res, walk). res: the closest hit's (win, t, u, v), each [L],
    win the lane's winning triangle in the cluster (-1: none); any-hit: a
    bool [L], the lane is occluded. walk (count=True, else None): the
    group box tests "grp" and triangle tests "tri" the kernel takes (any
    hit: up to each lane's first hit), and masks "grp_read" [8] and
    "tri_read" [128] of the boxes and triangles tested."""
    dev = entry_t.device
    g_idx = torch.arange(N_TRI_GROUPS, device=dev)
    k_idx = torch.arange(CLUSTER_SIZE, device=dev)
    n_grp = min(N_TRI_GROUPS, -(-cnt // TRI_GROUP))
    # the cluster's 8 group boxes against its lanes: [L, 8]
    tn, tf = _slab_t(blocks[10:16, None, base:base + N_TRI_GROUPS],
                     [x[:, None] for x in o], [x[:, None] for x in inv])
    t, u, v, valid = moller_trumbore(blocks[0:9, None, base:base + CLUSTER_SIZE], o, d)
    below = t < entry_t[:, None]
    if tie_ok is not None:
        below |= tie_ok[:, None] & (t == entry_t[:, None])
    ok = valid & below & (k_idx < cnt)
    gt = torch.where(ok, t, torch.inf).view(-1, N_TRI_GROUPS, TRI_GROUP)
    # per group: its first minimum (the sequential (t, slot) rule)
    g_t, g_k = torch.min(gt, dim=2)
    exists = g_idx * TRI_GROUP < cnt
    walk = None
    if any_hit:
        gate = (tn <= tf) & (tf >= 0.0) & (tn <= entry_t[:, None]) & exists
        hitg = gate & (g_t < entry_t[:, None])
        has = hitg.any(dim=1)
        if count:
            # the kernel stops at its first hit: groups up to the first hit
            # group fg, triangles of fg up to its first hit
            fg = torch.where(has, hitg.to(torch.int8).argmax(dim=1), N_TRI_GROUPS)
            ok3 = ok.view(-1, N_TRI_GROUPS, TRI_GROUP)
            first_k = ok3.to(torch.int8).argmax(dim=2)
            walked = gate & (g_idx[None] < fg[:, None])
            tris = walked[:, :, None] & (k_idx < cnt).view(1, N_TRI_GROUPS, TRI_GROUP)
            tris |= ((g_idx[None] == fg[:, None])[:, :, None]
                     & (k_idx[:TRI_GROUP] <= first_k[:, :, None]))
            walk = {"grp": int(torch.clamp(fg + 1, max=n_grp).sum()), "tri": int(tris.sum()),
                    "grp_read": (g_idx[None] <= fg[:, None]).any(dim=0) & exists,
                    "tri_read": tris.any(dim=0).view(-1)}
        return has, walk
    cur = entry_t
    cur_tie = tie_ok if tie_ok is not None else torch.zeros_like(entry_t, dtype=torch.bool)
    win = torch.full_like(g_k, -1)[:, 0]
    n_tri = 0
    tri_read = torch.zeros(CLUSTER_SIZE, dtype=torch.bool, device=dev)
    for gi in range(n_grp):
        gate = (tn[:, gi] <= tf[:, gi]) & (tf[:, gi] >= 0.0) & (tn[:, gi] <= cur)
        if count and bool(gate.any()):
            k0, k1 = gi * TRI_GROUP, min(cnt, (gi + 1) * TRI_GROUP)
            n_tri += int(gate.sum()) * (k1 - k0)
            tri_read[k0:k1] = True
        better = gate & ((g_t[:, gi] < cur) | (cur_tie & (g_t[:, gi] == cur)))
        cur = torch.where(better, g_t[:, gi], cur)
        cur_tie = cur_tie & ~better
        win = torch.where(better, gi * TRI_GROUP + g_k[:, gi], win)
    if count:
        walk = {"grp": entry_t.numel() * n_grp, "tri": n_tri, "grp_read": g_idx < n_grp,
                "tri_read": tri_read}
    kk = torch.clamp(win, min=0)[:, None]
    return (win, cur, torch.gather(u, 1, kk)[:, 0], torch.gather(v, 1, kk)[:, 0]), walk


def _traverse_twin(c: Dict, rays: torch.Tensor, any_hit: bool, stats=None, order="ray",
                   early_exit: bool = True) -> Dict:
    """Per-lane traversal of the tables, vectorised over lanes; each level
    gates with the lane's running best t, as the kernels do. order: "ray"
    (each lane its own direction class: the kernels' walk), "table" (the
    superclusters in table order, no exit: the walk of the kernels before
    the front-to-back redesign) or a class 0-5 for every lane; early_exit:
    the key-bound exit of ordered walks. The result does not depend on
    either. A cluster's 128 triangles are tested at once and the kernel's
    walk over its 8 groups replayed in order (`walk_cluster`)."""
    dev = rays.device
    m = rays.shape[1]
    wo = [rays[k].clone() for k in range(3)]
    wd = [rays[k].clone() for k in range(3, 6)]
    tmax = rays[6].clone()
    alive = tmax > 0.0
    winv = [_inv_dir(x) for x in wd]
    root = c["root_aabb"][:, 0]
    best_t = tmax.clone()
    # root-box exit clamp (pallas_clustered.py:303-321)
    rtn, rtf = _slab_t(root, wo, winv)
    hit_root = (rtn <= rtf) & (rtf >= 0.0)
    clamp = torch.where(hit_root, rtf * 1.0001 + 1e-4, 0.0)
    best_t = torch.where(alive, torch.minimum(best_t, clamp), best_t)

    prim = torch.full((m,), -1, dtype=torch.int32, device=dev)
    slot = torch.full((m,), -1, dtype=torch.int32, device=dev)
    inst = torch.zeros((m,), dtype=torch.int32, device=dev)
    bu = torch.zeros((m,), dtype=torch.float32, device=dev)
    bv = torch.zeros((m,), dtype=torch.float32, device=dev)
    occ = torch.zeros((m,), dtype=torch.bool, device=dev)
    exited = torch.zeros((m,), dtype=torch.bool, device=dev)

    blocks = c["blocks"]
    cl_meta = c["cl_meta"].cpu().numpy()  # host copies drive the loops
    sc_mcount = c["sc_mcount"].cpu().numpy()
    sc_order = c["sc_order"].cpu().numpy()
    sc_key = c["sc_key"]
    inst_sc = c["inst_sc"].cpu().numpy()
    identity = c["identity"]
    n_sc = sc_mcount.shape[0]

    # with stats: the tests taken, and a mask per table of the entries read
    n_slots = blocks.shape[1]
    if stats is not None:
        stats.setdefault("key", 0)
        sizes = {"sc_aabb": n_sc, "sc_mcount": n_sc, "sc_order": N_ORDERS * n_sc,
                 "sc_key": N_ORDERS * n_sc, "cl_box": cl_meta.shape[1],
                 "cl_ref": cl_meta.shape[1], "grp_box": n_slots, "tri": n_slots,
                 "prim": n_slots}
        read = stats.setdefault("read", {})
        for k, n in sizes.items():
            read.setdefault(k, torch.zeros(n, dtype=torch.bool, device=dev))

    def count(key, n):
        if stats is not None:
            stats[key] += int(n)

    def mark(key, idx):
        if stats is not None:
            read[key][idx] = True

    def active(lanes):
        lanes = lanes[~exited[lanes]]
        return lanes[~occ[lanes]] if any_hit else lanes

    def visit_sc(i, s, lanes, o, d, inv):
        """Supercluster s of instance i for lanes that reached it."""
        count("slab", lanes.numel())
        mark("sc_aabb", s)
        sc_lanes = lanes[_slab(c["sc_aabb"][:, s], [x[lanes] for x in o],
                               [x[lanes] for x in inv], best_t[lanes])]
        if sc_lanes.numel():
            mark("sc_mcount", s)
        for j in range(int(sc_mcount[s])):
            col = s * SC_GROUP + j
            lanes = active(sc_lanes)
            if lanes.numel() == 0:
                break
            count("slab", lanes.numel())
            mark("cl_box", col)
            lanes = lanes[_slab(c["cl_meta"][:, col], [x[lanes] for x in o],
                                [x[lanes] for x in inv], best_t[lanes])]
            if lanes.numel() == 0:
                continue
            mark("cl_ref", col)
            cnt = int(cl_meta[6, col])
            base = int(cl_meta[7, col]) * CLUSTER_SIZE
            tie_ok = None
            if not any_hit:
                ls, li = slot[lanes], inst[lanes]
                tie_ok = (ls >= 0) & ((i < li) | ((i == li) & (base < ls)))
            res, walk = walk_cluster(blocks, base, cnt, [x[lanes] for x in o],
                                     [x[lanes] for x in d], [x[lanes] for x in inv],
                                     best_t[lanes], any_hit, stats is not None, tie_ok)
            if walk is not None:
                count("slab", walk["grp"])
                count("tri", walk["tri"])
                mark("grp_box", base + torch.nonzero(walk["grp_read"]).flatten())
                mark("tri", base + torch.nonzero(walk["tri_read"]).flatten())
            if any_hit:
                occ[lanes] = res
                continue
            win, t_w, u_w, v_w = res
            hit = win >= 0
            hl, kk = lanes[hit], win[hit]
            best_t[hl] = t_w[hit]
            slot[hl] = (base + kk).to(torch.int32)
            prim[hl] = blocks[9, base + kk].to(torch.int32)
            bu[hl] = u_w[hit]
            bv[hl] = v_w[hit]
            inst[hl] = i

    for i in range(inst_sc.shape[1]):
        exited[:] = False
        lanes = active(torch.nonzero(alive, as_tuple=True)[0])
        count("slab", lanes.numel())
        g = _slab(c["inst_aabb"][:, i], [x[lanes] for x in wo], [x[lanes] for x in winv],
                  best_t[lanes])
        lanes = lanes[g]
        if lanes.numel() == 0:
            continue
        if identity:
            o, d, inv = wo, wd, winv
        else:
            mi = c["inst_minv"][:, i]
            o = [mi[4 * r] * wo[0] + mi[4 * r + 1] * wo[1] + mi[4 * r + 2] * wo[2]
                 + mi[4 * r + 3] for r in range(3)]
            d = [mi[4 * r] * wd[0] + mi[4 * r + 1] * wd[1] + mi[4 * r + 2] * wd[2]
                 for r in range(3)]
            inv = [_inv_dir(x) for x in d]
        sc_lo, sc_n = int(inst_sc[0, i]), int(inst_sc[1, i])
        if order == "table":
            for s in range(sc_lo, sc_lo + sc_n):
                ln = active(lanes)
                if ln.numel() == 0:
                    break
                visit_sc(i, s, ln, o, d, inv)
            continue
        cls = order_class(d) if order == "ray" else torch.full_like(alive, int(order),
                                                                    dtype=torch.int64)
        for oc in range(N_ORDERS):
            g_lanes = lanes[cls[lanes] == oc]
            if g_lanes.numel() == 0:
                continue
            # the lane's coordinates along the order's axis, flipped with
            # its sign: the key bound (key - o') * inv' is the slab entry
            # along that axis of the box the key comes from, exactly
            ax, neg = divmod(oc, 2)
            op, ip, dp = (-x[ax] if neg else x[ax] for x in (o, inv, d))
            exit_ok = dp > 1e-7
            for k in range(sc_n):
                ln = active(g_lanes)
                if ln.numel() == 0:
                    break
                col = sc_lo + k
                if early_exit:
                    count("key", ln.numel())
                    mark("sc_key", oc * n_sc + col)
                    out = exit_ok[ln] & ((sc_key[oc, col] - op[ln]) * ip[ln] > best_t[ln])
                    exited[ln[out]] = True
                    ln = ln[~out]
                    if ln.numel() == 0:
                        continue
                mark("sc_order", oc * n_sc + col)
                visit_sc(i, int(sc_order[oc, col]), ln, o, d, inv)
    if stats is not None:
        # the kernel reads row 9 (prim) of each lane's final slot; every
        # alive lane reads the root box and the instance rows, the other
        # tables once per entry read
        mark("prim", slot[slot >= 0].long())
        rows = {"sc_aabb": 6, "sc_mcount": 1, "sc_order": 1, "sc_key": 1, "cl_box": 6,
                "cl_ref": 2, "grp_box": 6, "tri": 9, "prim": 1}
        inst_rows = 6 + 2 + (0 if identity else 12)
        stats["table_bytes"] = 4 * (6 + inst_rows * inst_sc.shape[1] + sum(
            r * int(read[k].sum()) for k, r in rows.items()))
    if any_hit:
        return {"occluded": occ}
    miss = prim < 0
    return {"t": torch.where(miss, tmax, best_t), "prim": prim, "u": bu, "v": bv,
            "inst": inst, "slot": slot}


def intersect_closest_twin(c: Dict, rays: torch.Tensor, stats=None, order="ray",
                           early_exit: bool = True) -> Dict:
    """Plain PyTorch clustered closest hit; same contract as the kernels.
    stats (a dict with "slab" and "tri" counters), when given, receives
    the slab, triangle and key-bound ("key") tests the walk's lanes take,
    "read" (a mask per table of the entries they read) and "table_bytes"
    (the bytes of those entries, each counted once). order, early_exit:
    as `_traverse_twin`; the defaults are the kernels' walk."""
    _build.LAUNCHES["clustered_closest_twin"] += 1
    return _traverse_twin(c, rays, False, stats, order, early_exit)


def intersect_any_twin(c: Dict, rays: torch.Tensor, stats=None, order="ray",
                       early_exit: bool = True) -> torch.Tensor:
    """Plain PyTorch clustered any-hit: bool [M]; stats as for the
    closest hit, counting only the tests before each lane's first hit."""
    _build.LAUNCHES["clustered_any_twin"] += 1
    return _traverse_twin(c, rays, True, stats, order, early_exit)["occluded"]


# ---------------------------------------------------------------------------
# wrappers

def _check_tables(c: Dict) -> None:
    """The tables' dtypes, layout, shapes and device, once, when they are
    prepared (the wrappers then check only the rays)."""
    dev = c["tri_rec"].device
    for k in _TABLE_KEYS + _RECORD_KEYS:
        t = c[k]
        want = torch.int32 if k in _INT_KEYS else torch.float32
        if t.dtype != want or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"table {k} must be contiguous {want} on {dev}")
    if c["blocks"].shape[0] != 16 or c["cl_meta"].shape[0] != 8:
        raise ValueError("blocks must be [16, K*128] and cl_meta [8, S*128]")
    n_sc, n_cl = c["sc_rec"].shape[0], c["cl_rec"].shape[0]
    shapes = {"sc_order": (N_ORDERS, n_sc), "sc_key": (N_ORDERS, n_sc),
              "inst_rec": (c["inst_xf"].shape[0], 8), "inst_xf": (c["inst_xf"].shape[0], 12),
              "sc_rec": (n_sc, 8), "cl_rec": (n_cl, 8), "grp_rec": (n_cl * N_TRI_GROUPS, 8),
              "tri_rec": (n_cl * CLUSTER_SIZE, 12)}
    for k, shape in shapes.items():
        if tuple(c[k].shape) != shape:
            raise ValueError(f"table {k} must be {shape}, got {tuple(c[k].shape)}")


def _check(c: Dict, rays: torch.Tensor) -> None:
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7:
        raise ValueError(f"rays must be [7, M] float32, got {tuple(rays.shape)} {rays.dtype}")
    if rays.shape[1] < 1 or rays.stride(1) != 1:
        raise ValueError("rays must hold at least one ray, with unit column stride")
    if c["tri_rec"].device != rays.device:
        raise ValueError(f"the tables lie on {c['tri_rec'].device}, the rays on {rays.device}")


def _launch(fn_name: str, count_name: str, c: Dict, rays, outs, staged: bool) -> None:
    lib = _build.lib()
    m = rays.shape[1]
    ptrs = [outs.get(k) for k in ("t", "prim", "u", "v", "inst", "slot", "occluded")]
    ptrs = [p.data_ptr() if p is not None else None for p in ptrs]
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    err = getattr(lib, fn_name)(
        rays.data_ptr(), rays.stride(0), m, c["root_aabb"].data_ptr(),
        c["inst_rec"].data_ptr(), c["inst_xf"].data_ptr(), c["inst_rec"].shape[0],
        int(c["identity"]), c["sc_rec"].data_ptr(), c["sc_order"].data_ptr(),
        c["sc_key"].data_ptr(), c["sc_rec"].shape[0], c["cl_rec"].data_ptr(),
        c["grp_rec"].data_ptr(), c["tri_rec"].data_ptr(), c["cl_rec"].shape[0],
        int(staged), *ptrs, stream,
    )
    _build.check(err, count_name)
    _build.LAUNCHES[count_name] += 1


def intersect_closest_clustered(c: Dict, rays: torch.Tensor, staged: bool = True) -> Dict:
    """Closest hit of every ray of the [7, M] view `rays` through the
    clustered tables `c` (prepare_clustered). Returns {t f32, prim i32,
    u f32, v f32, inst i32, slot i32}, each [M]. staged: stage the top
    levels in shared memory where they fit (`stage_bytes`); False reads
    them from global memory."""
    _check(c, rays)
    if rays.device.type == "cpu":
        return intersect_closest_twin(c, rays)
    if rays.device.type != "cuda":
        raise NotImplementedError(f"no clustered kernel for device {rays.device}")
    m = rays.shape[1]
    f32, i32 = torch.float32, torch.int32
    outs = {k: torch.empty(m, dtype=dt, device=rays.device)
            for k, dt in (("t", f32), ("prim", i32), ("u", f32), ("v", f32),
                          ("inst", i32), ("slot", i32))}
    _launch("fh_clustered_closest", "clustered_closest", c, rays, outs, staged)
    return outs


def intersect_any_clustered(c: Dict, rays: torch.Tensor, staged: bool = True) -> torch.Tensor:
    """Occlusion of every ray of the [7, M] view `rays`: bool [M]; staged
    as for the closest hit."""
    _check(c, rays)
    if rays.device.type == "cpu":
        return intersect_any_twin(c, rays)
    if rays.device.type != "cuda":
        raise NotImplementedError(f"no clustered kernel for device {rays.device}")
    occ = torch.empty(rays.shape[1], dtype=torch.bool, device=rays.device)
    _launch("fh_clustered_any", "clustered_any", c, rays, {"occluded": occ}, staged)
    return occ
