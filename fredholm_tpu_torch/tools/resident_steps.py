"""The steps chip_smoke.py [13] takes to measure the ray-resident
traversal (B7) on the card.

On the hosek sweep (bench.py metric 2's scene, 512x288) with
FREDHOLM_TRAV_RESIDENT=1: the rays of B7's traces at metric 2's d = 1
(the closest block and the three occlusion blocks) and the primaries
(`gate_on_bounce`); inputs that isolate the kernel's fixed costs
(`floor_inputs`); a small mesh on which the kernel's in-turn group test
decides results (`retest_case`); the twins' counts with their spread over
lanes and over the kernel's blocks (`twin_stats`); each tree's B7 held
bit-equal to the twins (`hold_equal`), called through `tree_calls`.
chip_smoke.py times the calls in turns (`time_turns`) and prints what
these return.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# the kernel entry of the page-streaming csrc/resident.cu (the first port
# of this kernel: a block of 256 rays streaming every page through shared
# memory), as nvcc mangles it: its table arguments are res_meta and the
# triangle blocks. Only for timing this tree's B7 against such a tree.
STREAMING_B7_SIGNATURE = "PKfxiS2_S2_iiS2_xPfPiS3_S3_Ph"


def takes_streaming_args(ptxas: dict) -> bool:
    """Whether a library's B7 (from its build's ptxas record) takes the
    page-streaming design's arguments."""
    return any("k_resident" in k and k.endswith(STREAMING_B7_SIGNATURE) for k in ptxas)


def streaming_call(handle, c, rays, any_hit):
    """B7 of a library built from the page-streaming design: the same
    outputs as the wrappers in experimental/resident.py."""
    from fredholm_tpu_torch import _build
    from fredholm_tpu_torch.experimental import resident

    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = handle.fh_resident_any if any_hit else handle.fh_resident_closest
    fn.argtypes = [vp, ll, i, vp, vp, i, i, vp, ll, vp, vp, vp, vp, vp, vp]
    resident._check(c, rays)
    m, dev = rays.shape[1], rays.device
    blocks, meta = c.get("res_blocks", c["blocks"]), c["res_meta"]
    if any_hit:
        outs = {"occluded": torch.empty(m, dtype=torch.bool, device=dev)}
    else:
        outs = {k: torch.empty(m, dtype=dt, device=dev) for k, dt in (
            ("t", torch.float32), ("prim", torch.int32), ("u", torch.float32),
            ("v", torch.float32))}
    ptrs = [outs[k].data_ptr() if k in outs else None
            for k in ("t", "prim", "u", "v", "occluded")]
    err = fn(rays.data_ptr(), rays.stride(0), m, c["root_aabb"].data_ptr(), meta.data_ptr(),
             meta.shape[1], resident._n_pages(c), blocks.data_ptr(), blocks.shape[1], *ptrs,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "the page-streaming resident kernel")
    if any_hit:
        return outs["occluded"]
    return {**outs, "inst": torch.zeros(m, dtype=torch.int32, device=dev),
            "hit": outs["prim"] >= 0}


def tree_calls(trees: dict, infos: dict):
    """{tree: call(c, rays, any_hit)}: B7's wrappers under each tree's
    library (`trees`: {name: library}; `infos`: {name: its build record}),
    through the page-streaming design's arguments where the build says
    so."""
    from fredholm_tpu_torch import _build
    from fredholm_tpu_torch.experimental import resident

    def wrapper(handle):
        def call(c, rays, any_hit):
            with _build.using(handle):
                return (resident.intersect_any_resident if any_hit else
                        resident.intersect_closest_resident)(c, rays)
        return call

    out = {}
    for name, handle in trees.items():
        if takes_streaming_args(infos.get(name, {}).get("ptxas", {})):
            out[name] = (lambda h: lambda c, rays, any_hit:
                         streaming_call(h, c, rays, any_hit))(handle)
        else:
            out[name] = wrapper(handle)
    return out


def spread(x: torch.Tensor) -> dict:
    """A per-block (or per-lane) count's sum and distribution over the
    blocks (lanes) that count anything."""
    x = x.double()
    nz = x[x > 0]
    if nz.numel() == 0:
        return {"sum": 0, "units": int(x.numel()), "nonzero": 0}
    q = torch.quantile(nz, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=x.device))
    return {"sum": int(x.sum()), "units": int(x.numel()), "nonzero": int(nz.numel()),
            "mean": float(nz.mean()), "q50": float(q[0]), "q90": float(q[1]),
            "q99": float(q[2]), "max": int(nz.max())}


def twin_stats(c, rays, any_hit):
    """The twin's counts on `rays` (experimental/resident.py
    `intersect_closest_twin`), with the spread of the pages and clusters
    over lanes and over the kernel's blocks."""
    from fredholm_tpu_torch.experimental import resident

    st = {}
    (resident.intersect_any_twin if any_hit else resident.intersect_closest_twin)(c, rays, st)
    st["spread"] = {f"{unit} {k}": spread(st[f"per_{unit}"][k])
                    for unit in ("block", "lane") for k in ("pages", "clusters")}
    return st


def floor_inputs(c, rad, st_closest):
    """Inputs that isolate the kernel's fixed costs, from the d = 1 closest
    rays and their twin counts: every lane dead; one live ray in each
    RES_BLOCK that misses the root box (every span box tested, nothing
    walked); the RES_BLOCK rays that want the most pages, every other lane
    dead; and those rays made to miss."""
    from fredholm_tpu_torch.experimental import resident

    dead = rad.clone()
    dead[6] = -1.0
    miss_o = c["root_aabb"][0:3, 0:1] - 1000.0

    def miss(rays, cols):
        rays[0:3, cols] = miss_o
        rays[3:6, cols] = -(3.0 ** -0.5)
        return rays

    lone = dead.clone()
    first = torch.arange(0, lone.shape[1], resident.RES_BLOCK, device=rad.device)
    miss(lone, first)
    lone[6, first] = 1e9
    pages = st_closest["per_lane"]["pages"]
    heavy = torch.topk(pages, resident.RES_BLOCK).indices
    one = dead.clone()
    one[:, heavy] = rad[:, heavy]
    return {
        "all lanes dead": dead,
        f"one missing ray in each {resident.RES_BLOCK} ({first.numel()} rays)": lone,
        f"the {resident.RES_BLOCK} rays that want the most pages alone "
        f"({int(pages[heavy].min())}-{int(pages[heavy].max())} pages a ray)": one,
        "those rays made to miss": miss(one.clone(), heavy),
    }


def retest_case(device):
    """(tables, rays): a mesh and rays on which the kernel's in-turn group
    test decides results. Two coplanar layers at z = 0.3 in one cluster:
    16 triangles tiling [0, 2]^2 (one group, vertices off the float grid)
    and a large triangle over them whose 15 companions lie at x < -4 (the
    earlier group in slot order); 1,024 rays from above hit both layers
    at t equal to a few ulps. On some lanes a tiling triangle's t is below
    the large one's, but its group box's entry lies beyond that t: after
    the hit in the earlier group, the walk in turn skips the group, so a
    test at once at the cluster's best t alone would take the wrong
    triangle (tests/test_torch_resident.py counts these lanes)."""
    from fredholm_tpu_torch.accel.bvh import build_bvh
    from fredholm_tpu_torch.accel.cluster import build_tlas, extract_hierarchy
    from fredholm_tpu_torch.accel.clustered import prepare_clustered
    from fredholm_tpu_torch.experimental.resident import prepare_resident

    rng = np.random.default_rng(0)
    gx, gy = np.meshgrid(np.linspace(0, 2, 5), np.linspace(0, 2, 3), indexing="ij")
    g = np.stack([gx, gy], -1) + rng.uniform(-0.05, 0.05, (5, 3, 2)) + 0.0123
    tris = []
    for i in range(4):
        for j in range(2):
            a, b, c_, d = g[i, j], g[i + 1, j], g[i + 1, j + 1], g[i, j + 1]
            tris += [(a, b, c_), (a, c_, d)]
    tris.append(([-6.1, -0.07], [1.53, -0.05], [1.57, 1.61]))
    for i in range(15):
        x0 = -4.03 - 0.31 * i
        tris.append(([x0, 0.01], [x0 + 0.29, 0.02], [x0, 1.03]))
    v = np.asarray([[(p[0], p[1], 0.3) for p in t] for t in tris], np.float32)
    v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    tlas = build_tlas([extract_hierarchy(build_bvh(lo, hi), v0, e1, e2)],
                      [(0, np.eye(4, dtype=np.float32))])
    c = {**prepare_clustered(tlas, device), **prepare_resident(tlas, device)}
    n = 1024
    rng = np.random.default_rng(1)
    at = np.stack([rng.uniform(0.3, 1.4, n), rng.uniform(0.1, 0.9, n), np.full(n, 0.3)], 1)
    o = at + np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(0.5, 3, n)], 1)
    d = (at - o) / np.linalg.norm(at - o, axis=1, keepdims=True)
    rays = np.concatenate([o.T, d.T, np.full((1, n), 1e9)])
    return c, torch.tensor(np.ascontiguousarray(rays, np.float32), device=device)


def hold_equal(tag, calls, c, inputs):
    """Every tree's B7 bit-equal to the twins on every input (NaN-free
    outputs: exact equality). Returns {input: {tree: what was measured}}:
    closest, the largest |B7 - twin| over t, u and v; any-hit, the share
    of lanes whose occlusion differs."""
    from fredholm_tpu_torch.experimental import resident

    out = {}
    for name, (rays, any_hit) in inputs.items():
        if any_hit:
            want = resident.intersect_any_twin(c, rays)
        else:
            want = resident.intersect_closest_twin(c, rays)
        out[name] = {}
        for tree, call in calls.items():
            got = call(c, rays, any_hit)
            if any_hit:
                bad = int((got != want).sum())
                out[name][tree] = bad / rays.shape[1]
            else:
                bad = sum(int((got[k] != want[k]).sum()) for k in ("t", "prim", "u", "v", "hit"))
                out[name][tree] = max((got[k] - want[k]).abs().max().item()
                                      for k in ("t", "u", "v"))
            if bad:
                raise AssertionError(f"{tag} {name}: B7 of {tree} differs from the twin on {bad} "
                                     "values")
        print(f"{tag} {name}: {rays.shape[1]} rays, {int((rays[6] > 0).sum())} live; B7 of "
              f"{len(calls)} tree(s) bit-equal to the twin", flush=True)
    return out


def gate_on_bounce(r, dev):
    """The gate-on sweep renderer's d = 1 closest and occlusion rays and
    its primaries, stage by stage as render_sample_fused runs them."""
    from fredholm_tpu_torch.fused import kernels
    from fredholm_tpu_torch.fused import pt_fused as pf

    ns = r.width * r.height
    p = r._params(5)
    cfg = pf.make_config(r._dev, p)
    sv, usv = pf.pack_scalars(p, ns, dev)
    n_spp = torch.full((ns,), 3, dtype=torch.int64, device=dev)
    st, si, r0 = kernels.raygen(cfg, sv, usv, n_spp)
    tr0 = pf.trace_stage(cfg, r._dev, r0, ns, 1, 0, coherent=True)
    _, r1, _, _ = kernels.mega(cfg, 0, sv, usv, r._dev, n_spp, si, st, r0, None, tr0)
    n_occ = len(cfg.occ_blocks(True))
    nb = len(cfg.blocks)
    return r1[:, n_occ * ns:nb * ns], r1[:, :n_occ * ns], r0
