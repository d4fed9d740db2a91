"""Ray-resident, geometry-streamed traversal for incoherent dispatches
(port of fredholm_tpu/experimental/pallas_resident.py, kernel B7).

The clustered traversal (accel/clustered.py, B4/B5) walks the hierarchy
per ray. This one inverts the loops: the rays of a block stay resident,
and the geometry streams over them once, in cluster-id (cid) order, which
is the supercluster build order and so spatially coherent:

  meta chunks of CHUNK cids -> pages of P_CL clusters (page box gate) ->
    cluster box gate -> 16-triangle group box gate -> triangles

Every gate tests the lane's own slab against its running best t, after
the root-box exit clamp of the initial best t; triangles use the
Moller-Trumbore test and the strict `t < best` rule, so on exactly equal
t the first triangle in cid order wins. Any-hit stops a lane at its first
occluder. Only identity single-instance scenes carry the tables; the
reference routes the fused pipeline's incoherent traces here when
FREDHOLM_TRAV_RESIDENT=1 (`routes`, integrator/pt.py:98-114).

A ray's result depends on no other ray, so the port's kernel keeps the
walk's order and gates but not its loops: one warp walks one ray, a
level's records at once, each candidate tested again in turn
(csrc/resident.cu has the design). The twins follow the loops above.

Tables (prepare_resident, pallas_resident.py:67-102):
  res_meta   [16, K_pad] float32, dense by cid, K_pad a multiple of CHUNK:
             rows 0-5 the cluster box (lo.xyz, hi.xyz), row 6 its
             triangle count, rows 8-13 the page box (the union of the
             page's P_CL cluster boxes) at the page's first column.
  res_blocks the triangle blocks [16, K*128] padded to whole pages, only
             when K % P_CL != 0; else the blocks are shared.
The twins read these. The kernel reads port-only records of the same
floats (16-byte loads, `resident_records`), and B4/B5's group and
triangle records (accel/clustered.py `card_records`):
  res_page   [n_pages, 1 + P_CL, 8]: the page box (lo.xyz, 0, hi.xyz, 0),
             then each of its clusters' (lo.xyz, triangle count, hi.xyz,
             0), from res_meta byte for byte
  res_span   [n_spans, 8]: the union of SPAN consecutive page boxes, the
             kernel's gate ahead of them (the union's slab test passes
             wherever a member's does, so it skips only pages that the
             lane's own page test would)

Contract: rays are a [7, M] float32 view (rows ox, oy, oz, dx, dy, dz,
tmax; unit column stride). Closest returns {t, prim, u, v, inst, hit},
with no hit slot: prim = -1, u = v = 0 and t = tmax on a miss or a dead
lane (tmax <= 0), inst = 0. Any-hit returns a bool [M]. The wrappers run
the twins for CPU tensors only; for CUDA tensors they launch the kernel
in csrc/resident.cu or raise.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import _build
from ..accel.cluster import CLUSTER_SIZE, SC_GROUP
from ..accel.clustered import RESIDENT_ENV, _inv_dir, _slab, _slab_t, walk_cluster

P_CL = 4      # clusters per page: the page layout; results do not depend on it
CHUNK = 128   # K_pad is a multiple of it (the reference's meta chunk)
SPAN = 8      # pages a span record covers (csrc/resident.cu kSpan)
RES_BLOCK = 256  # rays a block of csrc/resident.cu holds (kBlock), 8 tiles of 32
TILE = 32        # rays a tile: block b holds tiles b, b + n_blocks, ... (kernel)


def routes(c: Dict, coherent: bool) -> bool:
    """Whether a dispatch takes this traversal (pt.py:98-114): an
    incoherent one, on an identity scene that carries the resident
    tables. The gate is read once, where the tables are built
    (accel/clustered.py `prepare_clustered`)."""
    return not coherent and c["identity"] and "res_meta" in c


def prepare_resident(tlas, device) -> Dict:
    """The dense-by-cid meta table, and the page-padded triangle blocks
    when the cluster count is not a whole number of pages (module
    docstring), as tensors on `device`."""
    k_total = int(tlas.blocks.shape[1] // CLUSTER_SIZE)
    k_pad = -(-k_total // CHUNK) * CHUNK
    meta = np.zeros((16, k_pad), np.float32)
    meta[0:3] = 1e30
    meta[3:6] = -1e30
    meta[8:11] = 1e30
    meta[11:14] = -1e30
    for s in range(tlas.sc_aabb.shape[1]):
        base = s * SC_GROUP
        mc = int(tlas.sc_mcount[s])
        cids = tlas.cl_meta[7, base:base + mc].astype(np.int64)
        meta[0:7, cids] = tlas.cl_meta[0:7, base:base + mc]
    lo = meta[0:3, :].reshape(3, -1, P_CL)
    hi = meta[3:6, :].reshape(3, -1, P_CL)
    first = np.arange(0, k_pad, P_CL)
    meta[8:11, first] = lo.min(2)
    meta[11:14, first] = hi.max(2)
    out = {"res_meta": torch.tensor(meta, device=device)}
    if k_total % P_CL:
        pad = (-k_total % P_CL) * CLUSTER_SIZE
        blocks = np.pad(np.asarray(tlas.blocks), ((0, 0), (0, pad)))
        out["res_blocks"] = torch.tensor(blocks, device=device)
    n_pages = -(-k_total // P_CL)
    out.update({k: torch.tensor(v, device=device)
                for k, v in resident_records(meta, n_pages).items()})
    return out


def resident_records(meta: np.ndarray, n_pages: int) -> Dict[str, np.ndarray]:
    """The kernel's page and span records (module docstring) from the
    [16, K_pad] meta table: its floats, regrouped."""
    first = np.arange(n_pages) * P_CL
    cl = meta[:, :n_pages * P_CL].reshape(16, n_pages, P_CL)
    page = np.zeros((n_pages, 1 + P_CL, 8), np.float32)
    page[:, 0, 0:3] = meta[8:11, first].T
    page[:, 0, 4:7] = meta[11:14, first].T
    page[:, 1:, 0:3] = cl[0:3].transpose(1, 2, 0)
    page[:, 1:, 3] = cl[6]
    page[:, 1:, 4:7] = cl[3:6].transpose(1, 2, 0)
    n_spans = -(-n_pages // SPAN)
    span = np.zeros((n_spans, 8), np.float32)
    for s in range(n_spans):
        boxes = page[s * SPAN:(s + 1) * SPAN, 0]
        span[s, 0:3] = boxes[:, 0:3].min(0)
        span[s, 4:7] = boxes[:, 4:7].max(0)
    return {"res_page": page, "res_span": span}


def _n_pages(c: Dict) -> int:
    return -(-(c["blocks"].shape[1] // CLUSTER_SIZE) // P_CL)


# ---------------------------------------------------------------------------
# plain twin


def _sweep_twin(c: Dict, rays: torch.Tensor, any_hit: bool, stats=None) -> Dict:
    """The kernel's sweep, vectorised over lanes: pages in cid order, each
    gated per lane by its box against the lane's running best t, then its
    clusters, their groups and triangles (accel/clustered.py
    `walk_cluster`, the walk B4's twin replays)."""
    dev = rays.device
    m = rays.shape[1]
    o = [rays[k] for k in range(3)]
    d = [rays[k] for k in range(3, 6)]
    tmax = rays[6]
    alive = tmax > 0.0
    inv = [_inv_dir(x) for x in d]
    # root-box exit clamp (pallas_resident.py:127-150)
    rtn, rtf = _slab_t(c["root_aabb"][:, 0], o, inv)
    clamp = torch.where((rtn <= rtf) & (rtf >= 0.0), rtf * 1.0001 + 1e-4, 0.0)
    best_t = torch.where(alive, torch.minimum(tmax, clamp), tmax)

    prim = torch.full((m,), -1, dtype=torch.int32, device=dev)
    slot = torch.full((m,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((m,), dtype=torch.float32, device=dev)
    bv = torch.zeros((m,), dtype=torch.float32, device=dev)
    occ = torch.zeros((m,), dtype=torch.bool, device=dev)
    meta = c["res_meta"]
    blocks = c.get("res_blocks", c["blocks"])
    counts = meta[6].cpu().numpy()  # the host copy drives the loops
    n_pages = _n_pages(c)
    # with stats: the pages any lane wants, and a mask per table of the
    # entries the lanes' tests read
    page_read = torch.zeros(n_pages, dtype=torch.bool, device=dev)
    if stats is not None:
        for k in ("page", "cluster", "group", "tri", "span", "page_in_span"):
            stats.setdefault(k, 0)
        n_cl = n_pages * P_CL
        sizes = {"page_box": n_pages, "cl_count": n_cl, "cl_box": n_cl,
                 "grp_box": n_cl * CLUSTER_SIZE, "tri": n_cl * CLUSTER_SIZE,
                 "prim": n_cl * CLUSTER_SIZE, "span_box": -(-n_pages // SPAN),
                 "page_box_in_span": n_pages}
        read = stats.setdefault("read", {})
        for k, n in sizes.items():
            read.setdefault(k, torch.zeros(n, dtype=torch.bool, device=dev))
        span = c["res_span"]
        # per lane: the pages it wants and the clusters it walks
        lane_pages = torch.zeros(m, dtype=torch.int64, device=dev)
        lane_clusters = torch.zeros(m, dtype=torch.int64, device=dev)

    def count(key, n):
        if stats is not None:
            stats[key] += int(n)

    def mark(key, idx):
        if stats is not None:
            read[key][idx] = True

    lanes_alive = torch.nonzero(alive, as_tuple=True)[0]
    for p in range(n_pages):
        c0 = p * P_CL
        lanes = lanes_alive[~occ[lanes_alive]] if any_hit else lanes_alive
        if stats is not None:
            # the span gate ahead of its pages (the kernel's): its lanes'
            # slab tests at the span's turn, and the page tests of the
            # lanes it passes; it changes no result (res_span, module
            # docstring), so the walk below gates every page as before
            if p % SPAN == 0:
                box = torch.cat([span[p // SPAN, 0:3], span[p // SPAN, 4:7]])
                count("span", lanes.numel())
                if lanes.numel():
                    mark("span_box", p // SPAN)
                in_span = torch.zeros(m, dtype=torch.bool, device=dev)
                in_span[lanes[_slab(box, [x[lanes] for x in o], [x[lanes] for x in inv],
                                    best_t[lanes])]] = True
            n_in = int(in_span[lanes].sum())
            count("page_in_span", n_in)
            if n_in:
                mark("page_box_in_span", p)
        count("page", lanes.numel())
        if lanes.numel():
            mark("page_box", p)
        lanes = lanes[_slab(meta[8:14, c0], [x[lanes] for x in o], [x[lanes] for x in inv],
                            best_t[lanes])]
        if lanes.numel() == 0:
            continue
        if stats is not None:
            page_read[p] = True
            lane_pages[lanes] += 1
        for cid in range(c0, c0 + P_CL):
            mark("cl_count", cid)
            cnt = int(counts[cid])
            if cnt <= 0:
                continue
            ln = lanes[~occ[lanes]] if any_hit else lanes
            count("cluster", ln.numel())
            if ln.numel():
                mark("cl_box", cid)
            ln = ln[_slab(meta[0:6, cid], [x[ln] for x in o], [x[ln] for x in inv], best_t[ln])]
            if ln.numel() == 0:
                continue
            if stats is not None:
                lane_clusters[ln] += 1
            base = cid * CLUSTER_SIZE
            res, walk = walk_cluster(blocks, base, cnt, [x[ln] for x in o], [x[ln] for x in d],
                                     [x[ln] for x in inv], best_t[ln], any_hit,
                                     stats is not None)
            if walk is not None:
                count("group", walk["grp"])
                count("tri", walk["tri"])
                mark("grp_box", base + torch.nonzero(walk["grp_read"]).flatten())
                mark("tri", base + torch.nonzero(walk["tri_read"]).flatten())
            if any_hit:
                occ[ln] = res
                continue
            win, t_w, u_w, v_w = res
            hit = win >= 0
            hl, kk = ln[hit], win[hit]
            best_t[hl] = t_w[hit]
            slot[hl] = base + kk
            prim[hl] = blocks[9, base + kk].to(torch.int32)
            bu[hl] = u_w[hit]
            bv[hl] = v_w[hit]
    if stats is not None:
        stats["pages"] = stats.get("pages", 0) + int(page_read.sum())
        # per block of the kernel (its tiles of TILE rays, every
        # n_blocks-th): the sums of its lanes' counts
        n_blocks = -(-m // RES_BLOCK)
        blk = (torch.arange(m, device=dev) // TILE) % n_blocks
        stats["per_lane"] = {"pages": lane_pages, "clusters": lane_clusters}
        stats["per_block"] = {k: torch.zeros(n_blocks, dtype=torch.int64, device=dev)
                              .index_add_(0, blk, v) for k, v in stats["per_lane"].items()}
        # the kernel reads row 9 (prim) of each lane's final hit; every
        # alive lane reads the root box, the tables once per entry read
        mark("prim", slot[slot >= 0])
        rows = {"page_box": 6, "cl_count": 1, "cl_box": 6, "grp_box": 6, "tri": 9, "prim": 1}
        stats["table_bytes"] = 4 * (6 + sum(r * int(read[k].sum()) for k, r in rows.items()))
        # the same with the span gate: span boxes, and the page boxes only
        # where a lane's span passed
        rows.pop("page_box")
        rows.update(span_box=6, page_box_in_span=6)
        stats["span_table_bytes"] = 4 * (6 + sum(r * int(read[k].sum())
                                                 for k, r in rows.items()))
    if any_hit:
        return {"occluded": occ}
    miss = prim < 0
    return {"t": torch.where(miss, tmax, best_t), "prim": prim, "u": bu, "v": bv,
            "inst": torch.zeros((m,), dtype=torch.int32, device=dev), "hit": ~miss}


def intersect_closest_twin(c: Dict, rays: torch.Tensor, stats=None) -> Dict:
    """Plain PyTorch B7 closest hit; same contract as the kernel. stats (a
    dict), when given, receives the page, cluster and group slab tests
    and the triangle tests of the walk ("page": every live lane tests
    every page box; "cluster", "group", "tri"), the same walk's tests with
    the kernel's span gate ahead of the pages ("span": each live lane
    tests each span box; "page_in_span": the page tests of the lanes
    whose span passes), per lane ("per_lane": {"pages": the pages whose
    box passes its gate, "clusters": the clusters it walks}, each int64
    [M]) and their sums per block of the kernel ("per_block", each
    [n_blocks]), the distinct pages wanted ("pages"), "read" (a mask per
    table of the entries the lanes' tests read: span, page and cluster
    boxes, cluster counts, group boxes, triangles, and the prim row at
    each lane's final hit), "table_bytes" (those entries' bytes, each
    read once, with every tested page box and the root box) and
    "span_table_bytes" (the same with the span boxes, and the page boxes
    of passing spans only)."""
    _build.LAUNCHES["resident_closest_twin"] += 1
    return _sweep_twin(c, rays, False, stats)


def intersect_any_twin(c: Dict, rays: torch.Tensor, stats=None) -> torch.Tensor:
    """Plain PyTorch B7 any-hit: bool [M]; stats as for the closest hit,
    counting only the tests up to each lane's first occluder."""
    _build.LAUNCHES["resident_any_twin"] += 1
    return _sweep_twin(c, rays, True, stats)["occluded"]


# ---------------------------------------------------------------------------
# wrappers


def _check(c: Dict, rays: torch.Tensor) -> None:
    """The rays, and that the tables are there and on their device. The
    tables are checked where they are made: prepare_resident builds its
    records from res_meta, whose shapes follow from the TLAS, and
    prepare_clustered checks B4/B5's records (accel/clustered.py
    `_check_tables`), as B4/B5's wrappers do."""
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7:
        raise ValueError(f"rays must be [7, M] float32, got {tuple(rays.shape)} {rays.dtype}")
    if rays.shape[1] < 1 or rays.stride(1) != 1:
        raise ValueError("rays must hold at least one ray, with unit column stride")
    if "res_page" not in c:
        raise ValueError("no resident tables: the scene was built with the gate off "
                         f"({RESIDENT_ENV}) or has more than one instance")
    if c["res_page"].device != rays.device:
        raise ValueError(f"the tables lie on {c['res_page'].device}, the rays on {rays.device}")


def _launch(fn_name: str, count_name: str, c: Dict, rays, outs) -> None:
    lib = _build.lib()
    ptrs = [outs.get(k) for k in ("t", "prim", "u", "v", "occluded")]
    ptrs = [p.data_ptr() if p is not None else None for p in ptrs]
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    err = getattr(lib, fn_name)(
        rays.data_ptr(), rays.stride(0), rays.shape[1], c["root_aabb"].data_ptr(),
        c["res_span"].data_ptr(), c["res_page"].data_ptr(), c["res_page"].shape[0],
        c["grp_rec"].data_ptr(), c["tri_rec"].data_ptr(), *ptrs, stream,
    )
    _build.check(err, count_name)
    _build.LAUNCHES[count_name] += 1


def intersect_closest_resident(c: Dict, rays: torch.Tensor) -> Dict:
    """Closest hit of every ray of the [7, M] view `rays` through the
    resident tables of `c` (prepare_clustered with the gate on). Returns
    {t f32, prim i32, u f32, v f32, inst i32, hit bool}, each [M]."""
    _check(c, rays)
    if rays.device.type == "cpu":
        return intersect_closest_twin(c, rays)
    if rays.device.type != "cuda":
        raise NotImplementedError(f"no resident kernel for device {rays.device}")
    m = rays.shape[1]
    f32 = torch.float32
    outs = {k: torch.empty(m, dtype=dt, device=rays.device)
            for k, dt in (("t", f32), ("prim", torch.int32), ("u", f32), ("v", f32))}
    _launch("fh_resident_closest", "resident_closest", c, rays, outs)
    return {**outs, "inst": torch.zeros(m, dtype=torch.int32, device=rays.device),
            "hit": outs["prim"] >= 0}


def intersect_any_resident(c: Dict, rays: torch.Tensor) -> torch.Tensor:
    """Occlusion of every ray of the [7, M] view `rays`: bool [M]."""
    _check(c, rays)
    if rays.device.type == "cpu":
        return intersect_any_twin(c, rays)
    if rays.device.type != "cuda":
        raise NotImplementedError(f"no resident kernel for device {rays.device}")
    occ = torch.empty(rays.shape[1], dtype=torch.bool, device=rays.device)
    _launch("fh_resident_any", "resident_any", c, rays, {"occluded": occ})
    return occ
