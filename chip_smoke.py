#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fredholm_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py
(`--against CSRC_DIR`, which may repeat, also times other trees' B1 and
mega kernels in turns with this tree's: phases 1, 5 and 9, in phase 20
mega's full variant and in phase 23 its textured one, of the trees that
have them. A tree's
kernels take this tree's launch-argument struct, csrc/common.cuh
`ShadeArgs`: an older tree's copy needs its struct brought level first)

Phases, each printing before the next; any failure raises and the script
exits non-zero without the final `ok` line:

0. the card's name and power limit (nvidia-smi); no CUDA device -> error
1. build the CUDA kernels from csrc/ (nvcc), print build time and spills
2. dense closest-hit kernel (B1) vs its twin, bit-equal (t, u, v, prim):
   Cornell with 4 x 512^2 rays from a real raygen + first bounce, a
   1024-triangle soup with 2^20 rays (dead lanes and rays at shared edges
   included), the bounce buffer with every lane dead and with one live
   lane a block, and coplanar copies of one triangle (an exact equal-t tie)
3. shading kernels vs their twins on the same inputs: raygen, mega at
   each d = 0..4 of metric 1, final resolve
4. the Cornell golden (64^2, 32 spp, depth 4) rendered through
   Renderer(device="cuda") and scored against tests/golden/cornell.npz
5. metric 1: Cornell 512^2, 16 spp, depth 5 after 2 warm-up spp, with the
   launch counts of that run, the device's busy share and time by kernel
   (torch.profiler), and per-kernel times vs the plain twins; then
   B1 and mega at each d = 0..4 of metric 1 (CUDA events and CUDA-graph
   replays, each buffer's live share, both terms of each bound) beside
   the times of the designs they replaced, and in turns with the kernels
   of each tree given by --against, their outputs held equal first (also
   mega at metric 2's d = 1, in phase 9)
6. the kernel table, the card line, then {"ok": true, "device": ...}
   (printed last, after phases 7-23)
7. the hosek-sweep scene (bench.py metric 2, 96,770 triangles) uploaded
   through Renderer(device="cuda"); the clustered closest-hit / any-hit
   kernels bit-equal to their twins in both kept variants (top levels
   staged in shared memory, and read from global memory: t, u, v, prim,
   inst, slot, the occlusion masks; every slot names its prim) at the
   hosek-sweep shapes (512x288 primaries, one bounce's closest and
   occlusion blocks) and on a two-instance non-identity TLAS with 2^18
   rays; the slot fetch bit-equal to its twin; the shading kernels vs
   their twins on the sweep's planes (Hosek sky, sun block, metal/specular
   lobes, split occlusion, slot planes)
8. the goldens terrain_cluster, hosek_sun and metal_row through
   Renderer(device="cuda"), scored against tests/golden/*.npz
9. metric 2: the hosek sweep at 512x288, 8 spp, depth 5 after 2 warm-up
   spp (bench.py:170-182), with its launch counts, and per-kernel times
   vs the plain twins at its shapes, beside each kernel's bound, and the
   device's busy share from torch.profiler; B4/B5's bounds counted with
   the front-to-back walk and with the PR-4 table-order walk, and both
   variants timed in turns (CUDA events around the wrapper, and CUDA-graph
   replays) at the d = 1 blocks, the primaries and two floors (all lanes
   dead; one live lane a block), beside the PR-4 design's times
10. the dense any-hit kernel (B3) vs its twin, bit-equal masks: the
    1024-triangle soup of [2] (2^20 rays, dead lanes included) and the
    concatenated NEE rays of a real wavefront bounce of metric 1's scene
11. the wavefront integrator's goldens through Renderer(device="cuda"):
    cornell with use_fused = False (dense, B1 + B3) and thin_film at its
    committed setup (clustered, B4/B5/B6)
12. the wavefront metric: metric 1's scene and camera at 512x512, 16 x
    render(1) after 2 warm-up spp, depth 5, sampler_mode "bluenoise",
    with its launch counts (B1 160, B3 80, twins 0), the profiler's busy
    share and top kernels, and B3's time vs its twin beside its bound
13. the ray-resident traversal (B7, FREDHOLM_TRAV_RESIDENT=1) at metric
    2's bounce shapes, on a gate-on sweep's d = 1 rays (the closest block,
    147,456 rays, and the occlusion blocks, 442,368): bit-equal to its
    twins; hit and occlusion masks equal to B4/B5's on the same rays, prim
    differing only at near-ties; B7 and B4/B5 timed in turns beside their
    bounds, and B7's fixed cost (every page walked, none staged)
14. the goldens terrain_cluster, hosek_sun and metal_row with the gate on,
    and metal_row with FREDHOLM_COMPACT=1 as well; B7 launched, twins 0
15. the resident metric: metric 2 with the gate on, with its launches per
    spp (B4 1, B7 closest 4, B7 any 5, B5 0, B6 1) and busy share
16. the FMA probe (P1) vs its twin, bit-equal, at the reference's tile
    shapes ([8,128] float32, [16,128] bfloat16) and on the [65536,128]
    inputs the rates are timed on (bfloat16 also with constants that move
    every step), then the card's float32/bfloat16 FMA and memory-stream
    rates
17. wavefront compaction A/B: metric 2 with the gate off and on, each
    with FREDHOLM_COMPACT 0 and 1, in turns 0, 1, 1, 0
18. mega's full variant (all seven lobes: coat, transmission, sheen and
    diffuse_t beside metal, specular and diffuse_r) vs its twins: its
    ptxas line, then compare_stages at each d of four goldens' setups
    (tools/gen_goldens.py) at 512x512 with the golden's scene, camera,
    sky, sun and depth: clear_coat (coat), sheen (sheen, sun block),
    transmission_rough (transmission, depth 6, lanes shading from inside
    the spheres counted) and diffuse_transmission (diffuse_t, sun)
19. the nine goldens the port gained (furnace, thinlens, metal_rough_grid
    and the six lobe goldens: clear_coat, sheen, transmission,
    transmission_rough, spec_transmission, diffuse_transmission) through
    Renderer(device="cuda"), scored against tests/golden/*.npz; the lobe
    goldens launch only the full variant, the others never; furnace's
    image mean within 1% of 0.5
20. the lobe metrics: the six lobe goldens' setups at 512x512 and their
    depth, 8 x render(1) after 2 warm-up spp, with launch counts (and for
    spec_transmission the profiler's busy share and top kernels); then the
    full variant at transmission_rough's d = 1 vs its twin (CUDA events
    and a graph replay) beside both terms of its bound, and in turns with
    the full variant of each --against tree that has one
21. mega's textured variant (k_mega_tex) and the final resolve's textured
    instance vs their twins: the ptxas line, then compare_stages at each d
    of the three texture goldens' setups (texture: a base-color checker;
    normalmap: a tangent-space normal map, the sun; emission_texture: an
    emission-textured panel, its two faces the area lights) at 512x512
22. the goldens texture, normalmap and emission_texture through
    Renderer(device="cuda"), scored against tests/golden/*.npz; each
    launches the textured variant at every bounce and no twin
23. the texture metrics: the three setups at 512x512 and their depth, 8 x
    render(1) after 2 warm-up spp, with launch counts and for texture the
    profiler's busy share and top kernels; then the textured variant at
    texture's d = 1 vs its twin (CUDA events and a graph replay) beside
    both terms of its bound, and in turns with the textured variant of
    each --against tree that has one
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel-vs-twin tolerances. The kernels build with -fmad=false and no fast
# math, but sin/cos/tan/exp/sqrt differ by a few ulp between nvcc's device
# library and the torch ops the twins run, and a few ulp can flip a branch
# (RR, a shared quad edge), so masks are compared by agreement fraction and
# values only on lanes whose masks agree.
MASK_AGREE_MIN = 0.999
VALUE_RTOL = 1e-4
VALUE_ATOL = 1e-4
VALUE_AGREE_MIN = 0.999
TIE_REL = 1e-6

# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# float operations a test takes: ray-box slab (6 sub, 6 mul, 9 min/max),
# Moller-Trumbore (cross products, dots, one divide, compares)
SLAB_OPS = 21
TRI_OPS = 40
# a key-bound test of the front-to-back walk (sub, mul, compare)
KEY_OPS = 3
# B4 and B5 at metric 2's d = 1 blocks in the PR-4 design (PR 4 run 5)
PR4_MS = {"B4": 0.3564, "B5": 0.3281}
# B1 and mega at metric 1's d = 0..4 (and mega at metric 2's d = 1) in the
# designs their redesign replaced (commit 5297889), (CUDA graph, CUDA
# events) ms: tools/shade_steps.py at commit 4f5d229, 3 pairs in turns
# with the redesign on "NVIDIA H100 80GB HBM3, 700.00 W"
REPLACED_MS = {
    "B1": [(0.0293, 0.0319), (0.0796, 0.0832), (0.0834, 0.0863), (0.0824, 0.0852),
           (0.0797, 0.0838)],
    "mega": [(0.0679, 0.0717), (0.0896, 0.0877), (0.0839, 0.0874), (0.0834, 0.0873),
             (0.0812, 0.0852)],
    "mega metric 2 d=1": (0.0885, 0.0915),
}
# float operations a lane of each shading stage takes (counted from the
# bodies, hashing included, a transcendental as one; all are bound by their
# bytes). mega_full: mega's 1500, plus ~470 in each of its three BSDF
# evaluations (the coat, transmission and sheen lobes), ~140 in the setup
# (their albedo fetches, the seven-lobe layer chain) and ~200 in the two
# samplers
# mega_tex: mega_full's, plus ~150 a texel tap (addressing, four texels
# unpacked and sRGB-decoded, the bilinear blend): one tap a lane on the
# texture setup it is timed on
STAGE_OPS = {"raygen": 300, "mega": 1500, "mega_full": 3300, "mega_tex": 3450,
             "final_resolve": 150}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def nbytes(*ts) -> int:
    """Bytes of the given tensors (None and non-tensors count 0)."""
    import torch

    total = 0
    for t in ts:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def bound(n_bytes: float, n_ops: float):
    """(least ms, what sets it) from the bytes moved and float ops done."""
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_o = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def mega_bytes(cfg, pf, kernels, d, n, tr, tables, sv, usv):
    """Bytes k_mega (csrc/shade.cu) moves at bounce d over n lanes, each
    input read once and each output written once. A lane reads its sample
    index and n_spp (8 B each) and its state rows; at d = 0 the radiance
    block's prim, u, v and t; at d > 0 the pending rows its variant reads,
    the occlusion of each NEE block and of the light block (a bool from an
    any-hit trace, else the closest hit's prim), the light block's
    direction (with area lights also its origin, u, v and geometry), and
    the radiance block's prim, u and v. A hit's geometry is 25 slot-fetch
    planes at d = 0, 19 after (20 for the light block), or on a dense
    scene the fused_table, read once like the material, light, Sobol,
    GGX reflection (coat, specular) and sheen tables and the scalars, and
    (a textured config) the texel run atlas, each once. It writes every
    state, pending and ray row, and at d = 0 the AOVs."""
    geom = tr.geom is not None
    lane = 16 + 4 * pf.ST_ROWS
    if d == 0:
        lane += 16 + (4 * 25 if geom else 0)
    else:
        n_nee = len(cfg.nee_blocks)  # the light block follows them
        lane += 4 * (3 * n_nee + 5)  # their contributions, tpf, pdf_l, wi_l.y
        lane += sum(1 if b < tr.n_occ(n) else 4 for b in range(n_nee + 1))
        lane += 12
        if cfg.has_area:
            lane += 12 + 8 + (4 * 20 if geom else 0)
        lane += 12 + (4 * 19 if geom else 0)
    written = 4 * (pf.ST_ROWS + pf.PD_ROWS + pf.RAY_ROWS * len(cfg.blocks)
                   + (pf.AOV_ROWS if d == 0 else 0))
    dev = sv.device
    consts = [tables["fused_mat_table"], kernels._sobol_device(dev), sv, usv]
    consts += [tables["fused_table"]] if not geom else []
    consts += [tables["light_table"]] if cfg.has_area else []
    consts += [kernels._lut_device(dev)] if {"coat", "specular"} & set(cfg.lobes_on) else []
    consts += [kernels._sheen_lut_device(dev)] if "sheen" in cfg.lobes_on else []
    consts += [tables["tex_runs"]] if cfg.tex_kinds else []
    return n * (lane + written) + nbytes(*consts)


def check_dense(name, dense, tri, rays, tag="[2]"):
    """B1 against its twin on the same rays, bit for bit: t, u, v and
    prim. Returns the largest absolute difference (measured)."""
    import torch

    m = rays.shape[1]
    kern = dense.intersect_closest(tri, rays, m)
    twin = dense.intersect_closest_twin(tri, rays, m)
    torch.cuda.synchronize()
    diff = {k: int((kern[k].view(torch.int32) != twin[k].view(torch.int32)).sum())
            for k in ("t", "u", "v", "prim")}
    err = max((kern[k].double() - twin[k].double()).abs().max().item()
              for k in ("t", "u", "v", "prim"))
    print(f"{tag} {name}: rays={m} live={int((rays[6] > 0).sum())} "
          f"hits={int((kern['prim'] >= 0).sum())} lanes differing from the twin "
          f"{json.dumps(diff)}")
    if any(diff.values()):
        raise AssertionError(f"{name}: B1 differs from its twin")
    return err


def compare_planes(name, kern, twin, mask_rows=(), tag="[3]"):
    """Packed planes [R, M]: mask rows (x > 0) by lane agreement, then all
    rows on agreeing lanes within rtol/atol. Returns max |error| there."""
    import torch

    if kern.dtype != torch.float32:
        eq = (kern == twin).float().mean().item()
        print(f"{tag} {name}: exact-equal fraction={eq:.7f}")
        if eq != 1.0:
            raise AssertionError(f"{name}: integer planes differ")
        return 0.0
    lanes = torch.ones(kern.shape[-1], dtype=torch.bool, device=kern.device)
    for r in mask_rows:
        lanes &= (kern[r] > 0) == (twin[r] > 0)
    mask_agree = lanes.float().mean().item()
    close = torch.isclose(kern, twin, rtol=VALUE_RTOL, atol=VALUE_ATOL, equal_nan=True)
    lane_ok = close.all(dim=0) & lanes
    value_agree = lane_ok.float().sum().item() / max(lanes.float().sum().item(), 1.0)
    diff = torch.where(lanes[None] & torch.isfinite(kern) & torch.isfinite(twin),
                       (kern - twin).abs(), torch.zeros_like(kern))
    err = diff.max().item()
    rel = (diff / twin.abs().clamp(min=1.0)).max().item()
    print(f"{tag} {name}: mask agreement={mask_agree:.7f} value agreement="
          f"{value_agree:.7f} max|err| on agreeing lanes={err:.3g} (relative {rel:.3g})")
    if mask_agree < MASK_AGREE_MIN or value_agree < VALUE_AGREE_MIN:
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    return err


def compare_stages(tag, cfg, pf, kernels, sv, usv, dev, n_spp, trace_fn, depths=(0, 1)):
    """raygen, mega at each d of depths (0, 1, ...) and final, kernel vs
    twin on the same inputs; trace_fn(rays, d) gives a stage's Traced
    (kernel traces). Returns {kernel name: max error}."""
    n = cfg.width * cfg.height
    k_st, k_si, k_r = kernels.raygen(cfg, sv, usv, n_spp)
    t_st, t_si, t_r = pf.raygen_twin(cfg, sv, usv, n_spp)
    res = {"raygen": max(compare_planes("raygen state", k_st, t_st, [pf.ST_ALIVE], tag),
                         compare_planes("raygen sample_idx", k_si, t_si, tag=tag),
                         compare_planes("raygen rays", k_r, t_r, [6], tag))}
    e = []
    st_in, r_in, pend = k_st, k_r, None
    for d in depths:
        tr = trace_fn(r_in, d)
        ko = kernels.mega(cfg, d, sv, usv, dev, n_spp, k_si, st_in, r_in, pend, tr)
        to = pf.mega_twin(cfg, d, sv, usv, dev, n_spp, k_si, st_in, r_in, pend, tr)
        e.append(compare_planes(f"mega d={d} state", ko[0], to[0], [pf.ST_ALIVE], tag))
        for b, blk in enumerate(cfg.blocks):
            e.append(compare_planes(f"mega d={d} rays[{blk}]", ko[1][:, b * n:(b + 1) * n],
                                    to[1][:, b * n:(b + 1) * n], [6], tag))
        e.append(compare_planes(f"mega d={d} pending", ko[2], to[2], tag=tag))
        if d == 0:
            e.append(compare_planes("mega d=0 aov", ko[3], to[3], tag=tag))
        print(f"{tag} mega d={d}: max|err| {max(e[-len(cfg.blocks) - 2 - (d == 0):]):.3g}")
        st_in, r_in, pend = ko[0], ko[1], ko[2]
    res["mega"] = max(e)
    tr = trace_fn(r_in, -1)
    k_rad = kernels.final(cfg, sv, dev, st_in, r_in, pend, tr)
    t_rad = pf.final_twin(cfg, sv, dev, st_in, r_in, pend, tr)
    res["final_resolve"] = compare_planes("final radiance", k_rad, t_rad, tag=tag)
    return res


def soup(n_tris: int, n_rays: int, seed: int, device):
    """Random triangle soup with shared edges, plus rays at random points,
    at shared-edge midpoints, and dead lanes (tmax <= 0)."""
    import torch

    rng = np.random.default_rng(seed)
    n_q = n_tris // 2  # quads split on a shared diagonal
    c = rng.uniform(-4, 4, (n_q, 1, 3))
    ax = rng.normal(size=(n_q, 2, 3)) * 0.5
    p0 = c[:, 0]
    p1 = c[:, 0] + ax[:, 0]
    p2 = c[:, 0] + ax[:, 0] + ax[:, 1]
    p3 = c[:, 0] + ax[:, 1]
    tris = np.concatenate([np.stack([p0, p1, p2], 1), np.stack([p0, p2, p3], 1)])
    tris = tris.astype(np.float32)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    tri = np.concatenate([v0.T, e1.T, e2.T]).astype(np.float32)

    k = rng.integers(0, n_tris, n_rays)
    bary = rng.dirichlet([1, 1, 1], n_rays)
    target = np.einsum("nk,nkc->nc", bary, tris[k])
    edge = rng.uniform(size=n_rays) < 0.1  # aim at shared diagonals
    q = k % n_q
    target[edge] = 0.5 * (p0[q[edge]] + p2[q[edge]])
    o = rng.uniform(-6, 6, (n_rays, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n_rays, 1e9, np.float32)
    tmax[rng.uniform(size=n_rays) < 0.1] = -1.0
    tmax[rng.uniform(size=n_rays) < 0.02] = 0.0
    rays = np.concatenate([o.T, d.T, tmax[None]]).astype(np.float32)
    return (torch.as_tensor(np.ascontiguousarray(tri), device=device),
            torch.as_tensor(np.ascontiguousarray(rays), device=device))


def instanced_case(n_rays: int, device):
    """Two non-identity instances of one sphere BLAS (tests/test_bvh.py:
    219-275) and rays toward them, with dead lanes and finite tmax."""
    import torch

    from fredholm_tpu_torch.accel.bvh import build_bvh
    from fredholm_tpu_torch.accel.cluster import build_tlas, extract_hierarchy
    from fredholm_tpu_torch.accel.clustered import prepare_clustered
    from fredholm_tpu_torch.scene.procedural import uv_sphere

    v, _, _, f = uv_sphere([0, 0, 0], 1.0, n_theta=32, n_phi=64)
    v0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - v0
    e2 = v[f[:, 2]] - v0
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    h = extract_hierarchy(build_bvh(lo, hi), v0, e1, e2)
    m_a = np.eye(4, dtype=np.float32)
    m_a[:3, 3] = [-1.6, 0.0, 0.0]
    m_b = np.diag([0.5, 0.5, 0.5, 1.0]).astype(np.float32)
    m_b[:3, 3] = [1.6, 0.3, 0.0]
    tlas = build_tlas([h], [(0, m_a), (0, m_b)])
    assert not tlas.inst_identity
    rng = np.random.default_rng(5)
    o = rng.normal(size=(n_rays, 3)).astype(np.float32)
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.8
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n_rays, 1e9, np.float32)
    tmax[rng.uniform(size=n_rays) < 0.1] = -1.0
    short = rng.uniform(size=n_rays) < 0.1
    tmax[short] = rng.uniform(0.5, 4.0, short.sum()).astype(np.float32)
    rays = np.concatenate([o.T, d.T, tmax[None]]).astype(np.float32)
    return (prepare_clustered(tlas, device), np.asarray(tlas.blocks[9]),
            torch.as_tensor(np.ascontiguousarray(rays), device=device))


HIT_KEYS = ("t", "prim", "u", "v", "inst", "slot")


def clustered_variants(clustered, c):
    """The kept B4/B5 kernels for the tables c: staged (where the top
    levels fit in shared memory) and global."""
    return (True, False) if clustered.stage_bytes(c) else (False,)


def check_clustered(tag, name, clustered, c, rays, row9=None, any_hit=False):
    """B4 (or B5) against its twin on the same rays, bit for bit, in every
    kept variant: t, u, v, prim, inst and slot (the mask on any-hit); every
    hit's slot names its prim (blocks row 9). Returns the twin's result and
    the largest absolute difference from it over every variant and value
    (the masks as 0 and 1)."""
    import torch

    twin = (clustered.intersect_any_twin if any_hit else clustered.intersect_closest_twin)(
        c, rays)
    worst = 0.0
    for staged in clustered_variants(clustered, c):
        fn = clustered.intersect_any_clustered if any_hit else \
            clustered.intersect_closest_clustered
        got = fn(c, rays, staged=staged)
        torch.cuda.synchronize()
        variant = "staged" if staged else "global"
        if any_hit:
            n_diff = int((got != twin).sum())
            worst = max(worst, float(n_diff > 0))
            print(f"{tag} {name} ({variant}): rays={rays.shape[1]} occluded={int(got.sum())} "
                  f"lanes differing from the twin={n_diff}")
            if n_diff:
                raise AssertionError(f"{name} ({variant}): B5 differs from its twin")
            continue
        diff = {k: int((got[k].view(torch.int32) != twin[k].view(torch.int32)).sum())
                for k in HIT_KEYS}
        worst = max([worst] + [(got[k].double() - twin[k].double()).abs().max().item()
                               for k in HIT_KEYS])
        hit = got["prim"] >= 0
        print(f"{tag} {name} ({variant}): rays={rays.shape[1]} hits={int(hit.sum())} "
              f"lanes differing from the twin {json.dumps(diff)}")
        if any(diff.values()):
            raise AssertionError(f"{name} ({variant}): B4 differs from its twin")
        r9 = c["blocks"][9] if row9 is None else row9
        slot_ok = (r9[got["slot"][hit].long()].to(torch.int32) == got["prim"][hit]).all()
        if not bool(slot_ok) or not bool((got["slot"][~hit] == -1).all()):
            raise AssertionError(f"{name} ({variant}): slot does not name the hit prim")
    return twin, worst


def graph_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device ms of one call of fn: `calls` calls captured in a CUDA graph,
    replayed `reps` times between CUDA events (no host cost between the
    kernels)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        g.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (reps * calls)


THIS_TREE = "this tree"


def tree_turns(tag, build, trees, fns, rounds):
    """{kernel: {tree: (events ms, graph ms)}}: each of fns ({kernel:
    wrapper call}) under each tree's library (`trees`: {name: library},
    THIS_TREE's first), timed in `rounds` turns whose order reverses each
    turn: CUDA events around 10 back-to-back calls, and CUDA-graph replays
    (device time alone); means of the turns. Before the turns each other
    tree's outputs are held equal to this tree's (NaN equal to NaN)."""
    import torch

    def under(handle, fn):
        def call():
            saved, build._lib = build._lib, handle
            try:
                return fn()
            finally:
                build._lib = saved
        return call

    def planes(x):
        if isinstance(x, dict):
            return [t for v in x.values() for t in planes(v)]
        if isinstance(x, (tuple, list)):
            return [t for v in x for t in planes(v)]
        return [x] if isinstance(x, torch.Tensor) else []

    calls = {(k, t): under(h, fn) for k, fn in fns.items() for t, h in trees.items()}
    for k in fns:
        want = planes(calls[(k, THIS_TREE)]())
        for t in list(trees)[1:]:
            got = planes(calls[(k, t)]())
            for x, y in zip(got, want):
                same = (x == y) | (torch.isnan(x) & torch.isnan(y)) \
                    if x.is_floating_point() else x == y
                if not bool(same.all()):
                    raise AssertionError(f"{tag} {k}: tree {t} differs from this tree on "
                                         f"{int((~same).sum())} values")
    ev = {key: [] for key in calls}
    gr = {key: [] for key in calls}
    for rnd in range(rounds):
        for key in (list(calls) if rnd % 2 == 0 else list(calls)[::-1]):
            ev[key].append(cuda_ms(calls[key], 10))
            gr[key].append(graph_ms(calls[key]))
    out = {k: {} for k in fns}
    for (k, t) in calls:
        out[k][t] = (sum(ev[(k, t)]) / rounds, sum(gr[(k, t)]) / rounds)
        if len(trees) > 1:
            print(f"{tag} {k} {t}: events {out[k][t][0]:.5f} ms, graph {out[k][t][1]:.5f} ms, "
                  f"{out[k][t][1] / out[k][THIS_TREE][1]:.3f}x this tree's (turns, graph: "
                  f"{', '.join(f'{x:.5f}' for x in gr[(k, t)])})")
    return out


def score_golden(tag, name, img, launches, want_shape):
    from fredholm_tpu_torch.utils.ssim import ssim

    golden = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))["image"]
    a = np.clip(golden.astype(np.float32), 0.0, 1.0)
    b = np.clip(img, 0.0, 1.0)
    score = ssim(a, b)
    mean_rel = abs(float(b.mean()) - float(a.mean())) / float(a.mean())
    print(f"{tag} golden {name}: SSIM={score:.5f} mean={b.mean():.5f} "
          f"golden mean={a.mean():.5f} rel={mean_rel:.5f} finite={np.isfinite(img).all()} "
          f"launches={launches}")
    if not (np.isfinite(img).all() and img.shape == want_shape):
        raise AssertionError(f"golden {name} render is not a finite {want_shape} image")
    if score < 0.98 or mean_rel > 0.02:
        raise AssertionError(f"golden {name} mismatch: SSIM {score:.4f}, mean rel {mean_rel:.4f}")
    twins = {k: v for k, v in launches.items() if k.endswith("_twin") and v}
    if twins:
        raise AssertionError(f"twins ran on the CUDA main path: {twins}")


def timed_metric(r, spp, depth, build):
    """spp calls of render(1) after 2 warm-up spp; returns (path vertices
    in float64, seconds, launches of the timed run)."""
    import torch

    r.render(n_samples=2, max_depth=depth)  # warm-up
    torch.cuda.synchronize()
    per_call = []
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    for _ in range(spp):
        # zero the float32 lifetime counter so each call's count is exact
        r.layers["n_path_vertices"] = torch.zeros_like(r.layers["n_path_vertices"])
        r.render(n_samples=1, max_depth=depth)
        per_call.append(r.layers["n_path_vertices"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    pv = float(np.sum([float(x) for x in per_call], dtype=np.float64))
    return pv, seconds, launches


def time_pairs(tag, pairs, reps):
    """{name: (kernel ms, twin ms)} in turns twin, kernel, kernel, twin. A
    twin timed one call a turn (seconds a call) is not warmed up first: the
    comparisons before ran it."""
    times = {}
    for name, (kf, tf) in pairs.items():
        kr, tr = reps.get(name, (20, 3))
        p1 = cuda_ms(tf, tr, warm=tr > 1)
        k1 = cuda_ms(kf, kr)
        k2 = cuda_ms(kf, kr)
        p2 = cuda_ms(tf, tr, warm=tr > 1)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"{tag} {name}: kernel {times[name][0]:.4f} ms, twin {times[name][1]:.4f} ms "
              f"(turns: twin {p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, twin {p2:.4f})")
    return times


def profile_busy(tag, what, r, depth, spp=2, start_tracer=True):
    """Device busy share and top kernels over spp samples of r
    (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # a first session starts the tracer (CUPTI), which takes seconds, once
    # a process; the next one is measured, its wall clock taken inside it
    if start_tracer:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            r.render(n_samples=1, max_depth=depth)
            torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        r.render(n_samples=spp, max_depth=depth)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = ev.self_cuda_time_total
        by_kernel[ev.key] = dt / 1e3
    busy_ms = sum(by_kernel.values())
    print(f"{tag} profiler, {spp} spp of {what}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, busy share {busy_ms / wall_ms:.4f}")
    for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"{tag}   {v:.3f} ms {k[:90]}")


@contextlib.contextmanager
def environ(**kv):
    """Set environment variables for a phase and restore them after."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def turns(tag, pairs, reps=10):
    """{name: (ms of a, ms of b)} for two implementations of one function,
    timed in turns a, b, b, a (CUDA events)."""
    out = {}
    for name, (label_a, fa, label_b, fb) in pairs.items():
        a1 = cuda_ms(fa, reps)
        b1 = cuda_ms(fb, reps)
        b2 = cuda_ms(fb, reps)
        a2 = cuda_ms(fa, reps)
        out[name] = ((a1 + a2) / 2, (b1 + b2) / 2)
        print(f"{tag} {name}: {label_a} {out[name][0]:.4f} ms, {label_b} {out[name][1]:.4f} ms "
              f"(turns: {a1:.4f}, {b1:.4f}, {b2:.4f}, {a2:.4f})")
    return out


def host_ms(fn):
    """One call's time on the host clock, bracketed by synchronizes, and
    its result."""
    import torch

    torch.cuda.synchronize()
    w0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - w0) * 1e3, res


def first_nee_rays(r, wavefront):
    """The [7, M] ray buffer of the first any-hit trace of one render(1)
    at depth 1 through the wavefront integrator: a real bounce's
    concatenated NEE blocks. The render's samples are cleared after."""
    seen = []
    trace_any = wavefront.trace_any

    def spy(dev_, o, d, t_max):
        seen.append(wavefront._ray_buffer(o, d, t_max))
        return trace_any(dev_, o, d, t_max)

    wavefront.trace_any = spy
    try:
        r.render(n_samples=1, max_depth=1)
    finally:
        wavefront.trace_any = trace_any
    r.init_render_states()
    return seen[0]


# The goldens of tools/gen_goldens.py that phases 18-20 render: the six
# whose scenes need mega's full variant (a coat, transmission, sheen or
# diffuse transmission), and three whose procedural scenes the port gained
# with them; [18] holds four of them at the stage level, one a lobe.
LOBE_GOLDENS = ("clear_coat", "sheen", "transmission", "transmission_rough",
                "spec_transmission", "diffuse_transmission")
NEW_GOLDENS = ("furnace", "thinlens", "metal_rough_grid") + LOBE_GOLDENS
STAGE_GOLDENS = {"clear_coat": "coat", "sheen": "sheen", "transmission_rough": "transmission",
                 "diffuse_transmission": "diffuse_t"}
# the goldens of phases 21-23: each scene uses one texture kind
TEXTURE_GOLDENS = {"texture": "base_color", "normalmap": "normalmap",
                   "emission_texture": "emission"}


def golden_setup(name, size=None):
    """(Renderer on the card, render kwargs) of golden `name` as
    tools/gen_goldens.py sets it up: its scene, camera, sky and sun, at
    the golden's size or at size x size."""
    import fredholm_tpu_torch as ft
    from fredholm_tpu_torch.scene.procedural import (
        emission_texture_test,
        furnace_sphere,
        normalmap_test,
        sphere_array_test,
        sphere_grid_test,
        texture_test,
    )
    from fredholm_tpu_torch.scene.types import Material as M

    at = (0.0, 0.6, 1.8)
    # name: (golden size, scene, camera origin, sun (le, direction, angle),
    #        constant sky, spp, depth)
    table = {
        "furnace": (48, lambda: furnace_sphere(M(specular=0.0)), (0.0, 0.0, 2.5), None,
                    (0.5, 0.5, 0.5), 16, 8),
        "thinlens": (64, lambda: sphere_array_test("metalness", [0.0, 0.0, 0.0], spacing=1.2),
                     (0.0, 0.7, 2.4), None, (0.8, 0.7, 0.5), 24, 3),
        "metal_rough_grid": (64, lambda: sphere_grid_test(
            "metalness", [0.0, 0.5, 1.0], "specular_roughness", [0.1, 0.6], spacing=1.0),
            (0.0, 1.2, 3.4), None, (0.5, 0.6, 0.7), 12, 3),
        "clear_coat": (48, lambda: sphere_array_test(
            "coat_roughness", [0.05, 0.6], base=M(coat=1.0, base_color=(0.6, 0.1, 0.1)),
            spacing=1.05), at, None, (0.7, 0.75, 0.8), 12, 4),
        "sheen": (48, lambda: sphere_array_test(
            "sheen", [0.3, 1.0], base=M(base_color=(0.2, 0.2, 0.5), sheen_color=(0.9, 0.9, 0.9)),
            spacing=1.05), at, ((3, 3, 3), (0.3, 1.0, 0.4), 1.0), (0.1, 0.1, 0.12), 12, 3),
        "transmission": (48, lambda: sphere_array_test(
            "transmission", [1.0], base=M(specular_roughness=0.05, diffuse=0.0)), at, None,
            (0.9, 0.6, 0.3), 16, 6),
        "transmission_rough": (48, lambda: sphere_array_test(
            "specular_roughness", [0.05, 0.5], base=M(transmission=1.0, diffuse=0.0),
            spacing=1.05), at, None, (0.9, 0.6, 0.3), 16, 6),
        "spec_transmission": (48, lambda: sphere_array_test(
            "transmission", [0.4, 1.0], base=M(specular=1.0, specular_roughness=0.05, diffuse=0.0),
            spacing=1.05), at, None, (0.3, 0.6, 0.9), 16, 6),
        "diffuse_transmission": (48, lambda: sphere_array_test(
            "subsurface", [0.0, 1.0], base=M(thin_walled=1.0), spacing=1.05), at,
            ((4, 4, 4), (-0.2, 1.0, -0.5), 2.0), (0.05, 0.05, 0.05), 16, 4),
        "texture": (64, texture_test, (0.0, 1.0, 2.2), None, (0.7, 0.8, 0.9), 12, 3),
        "normalmap": (64, normalmap_test, (0.0, 1.0, 2.2), ((3, 3, 3), (0.5, 1.0, 0.4), 1.0),
                      (0.2, 0.2, 0.25), 12, 3),
        "emission_texture": (64, emission_texture_test, (0.0, 1.0, 2.6), None, (0.0, 0.0, 0.0),
                             16, 3),
    }
    g_size, scene, origin, sun, bg, spp, depth = table[name]
    w = size or g_size
    r = ft.Renderer(w, w, device="cuda")
    r.set_scene(scene())
    r.camera.origin = np.asarray(origin, np.float32)
    if name == "thinlens":
        r.camera.f_number = 1.5
        r.camera.focus = 2.4
    r.camera._update_transform()
    if sun is not None:
        r.set_directional_light(sun[0], sun[1], angle=sun[2])
    r.set_bg_color(bg)
    return r, dict(n_samples=spp, max_depth=depth)


def stage_tracer(pf, cfg, dev_, n, inside=None):
    """trace_fn of compare_stages for a scene: a stage's traces as the
    pipeline makes them. With `inside` (a list), each bounce's count of
    lanes whose ray is live and hits a face from its back (the shading
    sees `entering` false) is appended to it."""
    import torch

    nb = len(cfg.blocks)
    n_occ = len(cfg.occ_blocks("clusters" in dev_))

    def fn(rays, d):
        if d == 0:
            tr = pf.trace_stage(cfg, dev_, rays, n, 1, 0)
        else:
            tr = pf.trace_stage(cfg, dev_, rays, n, nb if d > 0 else nb - 1, n_occ)
        if inside is not None and d >= 0:
            hit = tr.hits["prim"][-n:] >= 0
            if tr.geom is not None:
                g = tr.geom[:, -n:]
            else:
                g = dev_["fused_table"][tr.hits["prim"][-n:].clamp(min=0).long()].T
            e1 = g[3:6] - g[0:3]
            e2 = g[6:9] - g[0:3]
            ng = torch.linalg.cross(e1, e2, dim=0)
            back = (rays[3:6, -n:] * ng).sum(0) >= 0.0
            inside.append(int(((rays[6, -n:] > 0) & hit & back).sum()))
        return tr

    return fn


def parse_args(argv):
    import argparse

    p = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU (see the "
                                "module docstring); no arguments needed.")
    p.add_argument("--against", action="append", default=[], metavar="CSRC_DIR",
                   help="also build the kernel sources in CSRC_DIR (another tree's csrc/, "
                   "e.g. an unpacked `git archive <commit> fredholm_tpu_torch/csrc`) and "
                   "time its B1 and mega in turns with this tree's, on the same inputs, "
                   "at each bounce of metric 1 ([5]) and at metric 2's d = 1 ([9]), "
                   "mega's full variant at transmission_rough's d = 1 ([20]) and its "
                   "textured one at texture's d = 1 ([23]) where the tree has them, after "
                   "holding their outputs equal; may repeat")
    return p.parse_args(argv)


def main() -> None:
    args = parse_args(sys.argv[1:])
    t_start = time.perf_counter()
    # ---- 0: card
    card = card_line()
    print(f"[0] card: {card}")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, ROOT)
    import fredholm_tpu_torch as ft
    from fredholm_tpu_torch import _build
    from fredholm_tpu_torch.accel import clustered, dense
    from fredholm_tpu_torch.experimental import compact, resident
    from fredholm_tpu_torch.fused import kernels, slot_fetch
    from fredholm_tpu_torch.fused import pt_fused as pf
    from fredholm_tpu_torch.integrator import pt as wavefront
    from fredholm_tpu_torch.scene.device import build_device_scene
    from fredholm_tpu_torch.scene.types import Material
    from fredholm_tpu_torch.scene.procedural import (
        hosek_sweep_scene,
        sphere_array_test,
        terrain,
    )
    from fredholm_tpu_torch.tools import probe_bf16 as probe

    dev = torch.device("cuda")
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    phase_s = {}

    def phase_done(k, t0):
        phase_s[k] = time.perf_counter() - t0
        print(f"[{k}] phase seconds: {phase_s[k]:.1f}")

    # ---- 1: build
    t0 = time.perf_counter()
    _build.lib()
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(parallel nvcc + link {_build.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    for name, info in _build.BUILD_INFO.get("ptxas", {}).items():
        print(f"[1] ptxas {name}: {info}")
    trees = {THIS_TREE: _build.lib()}
    full_trees = [THIS_TREE]  # the trees with mega's full variant
    tex_trees = [THIS_TREE]  # the trees with mega's textured variant
    for csrc in args.against:
        info = {}
        trees[csrc] = _build.load(_build.build(os.path.abspath(csrc), info))
        for name, regs in info.get("ptxas", {}).items():
            if "dense_closest" in name or "k_mega" in name:
                print(f"[1] ptxas {csrc} {name}: {regs}")
        if any("k_mega_full" in name for name in info.get("ptxas", {})):
            full_trees.append(csrc)
        if any("k_mega_tex" in name for name in info.get("ptxas", {})):
            tex_trees.append(csrc)
    # turns of each timing against the other trees: their differences are
    # a few percent, so more turns than for this tree alone
    rounds = 6 if len(trees) > 1 else 2
    phase_done(1, t0)

    results = {}

    # ---- 2: dense closest-hit vs twin
    t0 = time.perf_counter()
    W = H = 512
    n = W * H
    scene_dev = build_device_scene(ft.cornell_box(), dev)
    lobes = ("diffuse_r",)
    cfg = pf.FusedConfig(W, H, 5, scene_dev["n_lights"], lobes)
    # bench.py metric 1's camera: every primary ray hits geometry
    cam = ft.Camera(origin=np.asarray([0.0, 1.0, 0.6], np.float32))
    params = {"camera": cam.device_params("cpu"), "seed": 42,
              "bg_color": np.zeros(3, np.float32)}
    sv, usv = pf.pack_scalars(params, n, dev)
    n_spp = torch.full((n,), 3, dtype=torch.int64, device=dev)
    tri = scene_dev["tri_soa"]

    state0, sidx, rays0 = kernels.raygen(cfg, sv, usv, n_spp)
    hits0 = dense.intersect_closest(tri, rays0, n)
    _, rays1, _, _ = kernels.mega(cfg, 0, sv, usv, scene_dev, n_spp, sidx, state0, rays0,
                                  None, pf.Traced(hits0))
    m1 = rays1.shape[1]
    err = [check_dense("cornell 4x512^2", dense, tri, rays1)]
    s_tri, s_rays = soup(1024, 1 << 20, 7, dev)
    err.append(check_dense("soup 1024 tris", dense, s_tri, s_rays))
    dead2 = rays1.clone()
    dead2[6] = -1.0
    err.append(check_dense("cornell bounce, every lane dead", dense, tri, dead2))
    # one live lane a block of the kernel (256 lanes): the block's first
    lone2 = dead2.clone()
    first = torch.arange(0, m1, 256, device=dev)
    lone2[6, first] = 1e9
    err.append(check_dense("cornell bounce, one live lane a block", dense, tri, lone2))
    # coplanar copies of one triangle (1, 2, 4 and 5 alike): every ray that
    # hits has an exact equal-t tie, which the lowest prim wins
    v = torch.tensor([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]], device=dev)
    tris = torch.stack([v + torch.tensor([0.0, 0.0, -1.0], device=dev), v, v, v * 0.5, v, v])
    tie_tri = torch.cat([tris[:, 0].T, (tris[:, 1] - tris[:, 0]).T,
                         (tris[:, 2] - tris[:, 0]).T]).contiguous()
    g = torch.Generator(device="cpu").manual_seed(5)
    tie_rays = torch.zeros((7, 1 << 18))
    tie_rays[0:2] = torch.rand((2, 1 << 18), generator=g) * 2.4 - 1.2
    tie_rays[2] = 2.0
    tie_rays[5] = -1.0
    tie_rays[6] = 1e9
    tie_rays = tie_rays.to(dev)
    err.append(check_dense("exact equal-t ties", dense, tie_tri, tie_rays))
    tie_hits = dense.intersect_closest(tie_tri, tie_rays, tie_rays.shape[1])["prim"]
    if not bool(((tie_hits == -1) | (tie_hits == 1) | (tie_hits == 3)).all()) \
            or not bool((tie_hits == 1).any()):
        raise AssertionError("an exact equal-t tie was not won by the lowest prim")
    results["dense_closest"] = max(err)
    phase_done(2, t0)

    # ---- 3: shading kernels vs twins, same inputs (dense Cornell)
    t0 = time.perf_counter()

    def dense_traced(rays, d):
        m = rays.shape[1] if d >= 0 else (len(cfg.blocks) - 1) * n
        return pf.Traced(dense.intersect_closest(tri, rays, m))

    results.update(compare_stages("[3]", cfg, pf, kernels, sv, usv, scene_dev, n_spp,
                                  dense_traced, depths=range(cfg.max_depth)))
    phase_done(3, t0)

    # ---- 4: the golden through the user entry point
    t0 = time.perf_counter()
    r = ft.Renderer(64, 64, device="cuda")
    r.set_scene(ft.cornell_box())
    r.camera.origin = np.asarray([0.0, 1.0, 0.6], np.float32)
    r.camera._update_transform()
    _build.LAUNCHES.clear()
    r.render(n_samples=32, max_depth=4)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    score_golden("[4]", "cornell", r.get_layer("beauty"), counts, (64, 64, 3))
    if counts.get("dense_closest", 0) != (4 + 1) * 32:
        raise AssertionError(f"dense kernel launched {counts.get('dense_closest')} times")
    for k in ("raygen", "mega", "final"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    phase_done(4, t0)

    # ---- 5: metric 1 (bench.py metric 1: Cornell 512^2, 16 spp, depth 5)
    t0 = time.perf_counter()
    spp, depth = 16, 5
    r = ft.Renderer(512, 512, device="cuda")
    r.set_scene(ft.cornell_box())
    r.camera.origin = np.asarray([0.0, 1.0, 0.6], np.float32)
    r.camera._update_transform()
    pv, seconds, launches1 = timed_metric(r, spp, depth, _build)
    beauty = r.get_layer("beauty")
    if not (np.isfinite(beauty).all() and 0.01 < beauty.mean() < 10.0):
        raise AssertionError(f"metric-1 image is off: mean {beauty.mean()}")
    if launches1.get("dense_closest", 0) != (depth + 1) * spp:
        raise AssertionError(f"dense kernel launched {launches1.get('dense_closest')} "
                             f"times, expected {(depth + 1) * spp}")
    for k in ("raygen", "mega", "final"):
        if launches1.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    twins = {k: v for k, v in launches1.items() if k.endswith("_twin") and v}
    if twins:
        raise AssertionError(f"twins ran on the CUDA main path: {twins}")
    print(json.dumps({
        "metric": "cornell_512x512_16spp_depth5",
        "mpath_vertices_per_s": pv / seconds / 1e6,
        "path_vertices": pv,
        "seconds": seconds,
        "beauty_mean": float(beauty.mean()),
        "card": card,
        "launches": launches1,
    }))
    profile_busy("[5]", "metric 1", r, depth)

    # per-kernel times at metric-1 shapes (CUDA events), in turns
    st, si, rays = kernels.raygen(cfg, sv, usv, n_spp)
    h = dense.intersect_closest(tri, rays, n)
    st, rays, pend, _ = kernels.mega(cfg, 0, sv, usv, scene_dev, n_spp, si, st, rays, None,
                                     pf.Traced(h))
    h4 = pf.Traced(dense.intersect_closest(tri, rays, rays.shape[1]))
    hf = pf.Traced(dense.intersect_closest(tri, rays, (len(cfg.blocks) - 1) * n))
    times1 = time_pairs("[5]", {
        "dense_closest": (lambda: dense.intersect_closest(tri, rays, rays.shape[1]),
                          lambda: dense.intersect_closest_twin(tri, rays, rays.shape[1])),
        "raygen": (lambda: kernels.raygen(cfg, sv, usv, n_spp),
                   lambda: pf.raygen_twin(cfg, sv, usv, n_spp)),
        "mega": (lambda: kernels.mega(cfg, 1, sv, usv, scene_dev, n_spp, si, st, rays, pend, h4),
                 lambda: pf.mega_twin(cfg, 1, sv, usv, scene_dev, n_spp, si, st, rays, pend, h4)),
        "final_resolve": (lambda: kernels.final(cfg, sv, scene_dev, st, rays, pend, hf),
                          lambda: pf.final_twin(cfg, sv, scene_dev, st, rays, pend, hf)),
    }, {})
    live = int((rays[6] > 0).sum())
    # a dead ray reads its tmax, a live one its 7 floats; each writes 16 B
    work1 = {
        "dense_closest": (4 * rays.shape[1] + 24 * live + nbytes(tri) + 16 * rays.shape[1],
                          live * tri.shape[1] * TRI_OPS),
        "mega": (mega_bytes(cfg, pf, kernels, 1, n, h4, scene_dev, sv, usv),
                 n * STAGE_OPS["mega"]),
    }
    bounds1 = {
        "dense_closest": bound(*work1["dense_closest"]),
        "raygen": bound(nbytes(n_spp) + n * (4 * pf.ST_ROWS + 8 + 4 * pf.RAY_ROWS),
                        n * STAGE_OPS["raygen"]),
        "mega": bound(*work1["mega"]),
        "final_resolve": bound(nbytes(st, pend, rays[:, :3 * n], hf.hits) + 12 * n,
                               n * STAGE_OPS["final_resolve"]),
    }
    for k, (ms, by) in bounds1.items():
        print(f"[5] {k}: bound {ms:.4f} ms ({by})")
    # both terms: the kernels build -fmad=false, so each product and sum
    # issues on its own, at half the 67 TFLOP/s the operation term uses
    for k, (b, o) in work1.items():
        print(f"[5] {k} at d = 1: bytes {b / PEAK_BYTES_PER_S * 1e3:.4f} ms, operations "
              f"{o / PEAK_FP32_PER_S * 1e3:.4f} ms at 67 TFLOP/s, "
              f"{o / (PEAK_FP32_PER_S / 2) * 1e3:.4f} ms unfused; the row uses "
              f"{bounds1[k][1]}")

    # B1 and mega at each bounce of metric 1, on the buffers the pipeline
    # makes, in turns (with the trees given by --against): CUDA events
    # around back-to-back wrapper calls, and CUDA-graph replays (device
    # time alone), beside the replaced designs' times
    st, si, rays = kernels.raygen(cfg, sv, usv, n_spp)
    pend = None
    per_d = []
    for d in range(cfg.max_depth):
        m = rays.shape[1]
        live = int((rays[6] > 0).sum())
        hd = pf.Traced(dense.intersect_closest(tri, rays, m))
        alive = int((st[pf.ST_ALIVE] != 0).sum())
        tt = tree_turns(f"[5] d={d}", _build, trees, {
            "B1": lambda r=rays, m=m: dense.intersect_closest(tri, r, m),
            "mega": lambda d=d, st=st, r=rays, p=pend, h=hd: kernels.mega(
                cfg, d, sv, usv, scene_dev, n_spp, si, st, r, p, h)}, rounds)
        out = kernels.mega(cfg, d, sv, usv, scene_dev, n_spp, si, st, rays, pend, hd)
        b1_bytes = 4 * m + 24 * live + 16 * m
        b1_ops = live * tri.shape[1] * TRI_OPS
        row = {"d": d, "rays": m, "live": live, "lanes": n, "alive": alive}
        for k, b, o in (("B1", b1_bytes, b1_ops),
                        ("mega", mega_bytes(cfg, pf, kernels, d, n, hd, scene_dev, sv, usv),
                         n * STAGE_OPS["mega"])):
            row[k] = {"events_ms": tt[k][THIS_TREE][0], "graph_ms": tt[k][THIS_TREE][1],
                      "replaced_graph_ms": REPLACED_MS[k][d][0],
                      "replaced_events_ms": REPLACED_MS[k][d][1],
                      "bound_bytes_ms": b / PEAK_BYTES_PER_S * 1e3,
                      "bound_ops_ms": o / PEAK_FP32_PER_S * 1e3,
                      "bound_ops_unfused_ms": o / (PEAK_FP32_PER_S / 2) * 1e3}
            print(f"[5] {k} d={d}: {m if k == 'B1' else n} lanes, live "
                  f"{(live / m if k == 'B1' else alive / n):.4f}; events "
                  f"{row[k]['events_ms']:.4f} ms, graph {row[k]['graph_ms']:.4f} ms (replaced "
                  f"design: {REPLACED_MS[k][d][1]} and {REPLACED_MS[k][d][0]}); bound bytes "
                  f"{row[k]['bound_bytes_ms']:.4f} ms, operations {row[k]['bound_ops_ms']:.4f} "
                  f"ms at 67 TFLOP/s ({row[k]['bound_ops_unfused_ms']:.4f} unfused)")
            if len(trees) > 1:
                row[k]["against"] = {t: {"events_ms": e, "graph_ms": g}
                                     for t, (e, g) in tt[k].items() if t != THIS_TREE}
        per_d.append(row)
        st, rays, pend, _ = out
    print(json.dumps({"metric 1 per bounce": per_d, "card": card}))
    phase_done(5, t0)

    # ---- 7: the hosek-sweep scene (bench.py metric 2); B4 / B5 / B6 vs
    # twins at its shapes
    t0 = time.perf_counter()
    SW, SH = 512, 288
    ns = SW * SH
    sweep = hosek_sweep_scene()

    def sweep_renderer(width, height):
        r = ft.Renderer(width, height, device="cuda")
        r.set_scene(sweep)
        r.camera.origin = np.asarray([0.0, 2.0, 8.0], np.float32)
        r.camera.look_around(0.0, 0.0)
        r.camera._update_transform()
        r.set_directional_light([2.0, 1.9, 1.8], [0.35, 0.75, 0.3], angle=0.5)
        r.load_arhosek_sky(turbidity=3.0, albedo=0.3)
        return r

    rs = sweep_renderer(SW, SH)
    sweep_dev = rs._dev
    c = sweep_dev["clusters"]
    print(f"[7] hosek sweep: {sweep.n_faces()} faces, {c['sc_aabb'].shape[1]} superclusters, "
          f"{c['blocks'].shape[1] // 128} clusters, scene upload {time.perf_counter() - t0:.1f} s, "
          f"staged tables {clustered.stage_bytes(c)} B")
    if not clustered.stage_bytes(c):
        raise AssertionError("the sweep's top levels no longer fit the staged kernels")
    p2 = rs._params(5)
    cfg2 = pf.make_config(sweep_dev, p2)
    assert cfg2.has_dl and cfg2.sky_mode == pf.SKY_HOSEK
    assert cfg2.lobes_on == ("metal", "specular", "diffuse_r"), cfg2.lobes_on
    sv2, usv2 = pf.pack_scalars(p2, ns, dev)
    n_spp2 = torch.full((ns,), 3, dtype=torch.int64, device=dev)
    n_occ = len(cfg2.occ_blocks(True))
    nb2 = len(cfg2.blocks)

    st0, si0, r0 = kernels.raygen(cfg2, sv2, usv2, n_spp2)
    b45_err = {"clustered_closest": [], "clustered_any": []}
    b45_err["clustered_closest"].append(
        check_clustered("[7]", "sweep primaries 512x288", clustered, c, r0)[1])
    kh0 = clustered.intersect_closest_clustered(c, r0)
    geom_k = slot_fetch.fetch_geom_by_slot(sweep_dev["slot_attrs"], kh0["slot"])
    geom_t = slot_fetch.fetch_twin(sweep_dev["slot_attrs"], kh0["slot"])
    results["slot_fetch"] = (geom_k - geom_t).abs().max().item()
    if not torch.equal(geom_k, geom_t):
        raise AssertionError("slot fetch kernel differs from its twin")
    print(f"[7] slot fetch {ns} lanes: bit-equal to its twin")
    _, r1, _, _ = kernels.mega(cfg2, 0, sv2, usv2, sweep_dev, n_spp2, si0, st0, r0, None,
                               pf.Traced(kh0, None, geom_k))
    occ_view = r1[:, :n_occ * ns]
    b45_err["clustered_any"].append(check_clustered(
        "[7]", f"sweep bounce occlusion blocks {cfg2.occ_blocks(True)}", clustered, c,
        occ_view, any_hit=True)[1])
    rad_view = r1[:, n_occ * ns:nb2 * ns]
    b45_err["clustered_closest"].append(
        check_clustered("[7]", "sweep bounce closest block", clustered, c, rad_view)[1])
    ic, i_row9, i_rays = instanced_case(1 << 18, dev)
    i9 = torch.as_tensor(i_row9, device=dev)
    ith, err = check_clustered("[7]", "two-instance TLAS", clustered, ic, i_rays, row9=i9)
    b45_err["clustered_closest"].append(err)
    i_hit = ith["prim"] >= 0
    iot, err = check_clustered("[7]", "two-instance TLAS any-hit", clustered, ic, i_rays,
                               any_hit=True)
    b45_err["clustered_any"].append(err)
    print(f"[7] two-instance: any == closest-hit {(iot == i_hit).float().mean().item():.7f}, "
          f"instances hit {sorted(set(ith['inst'][i_hit].tolist()))}")
    if sorted(set(ith["inst"][i_hit].tolist())) != [0, 1]:
        raise AssertionError("two-instance TLAS: not both instances hit")
    for k, errs in b45_err.items():
        results[k] = max(errs)

    def sweep_traced(rays, d):
        if d == 0:
            return pf.trace_stage(cfg2, sweep_dev, rays, ns, 1, 0)
        return pf.trace_stage(cfg2, sweep_dev, rays, ns, nb2 if d > 0 else nb2 - 1, n_occ)

    sres = compare_stages("[7]", cfg2, pf, kernels, sv2, usv2, sweep_dev, n_spp2,
                          sweep_traced)
    for k, v in sres.items():
        results[k] = max(results[k], v)
    phase_done(7, t0)

    # ---- 8: goldens of the clustered path through the user entry point
    t0 = time.perf_counter()

    def g_terrain_cluster():
        r = ft.Renderer(48, 48, device="cuda")
        r.set_scene(terrain(n=64, size=8.0, amp=1.2))
        r.camera.origin = np.asarray([0.0, 2.6, 5.5], np.float32)
        r.camera.look_around(0.0, -0.35)
        r.camera._update_transform()
        r.set_directional_light((2.0, 1.9, 1.8), (0.35, 0.75, 0.3), angle=0.5)
        r.load_arhosek_sky(3.0, 0.3)
        return r, dict(n_samples=6, max_depth=3)

    def g_hosek_sun():
        r = ft.Renderer(64, 64, device="cuda")
        r.set_scene(sphere_array_test("specular_roughness", [0.1, 0.5], spacing=1.2))
        r.camera.origin = np.asarray([0.0, 0.8, 2.5], np.float32)
        r.camera._update_transform()
        r.set_directional_light((5, 5, 5), (0.4, 1.0, 0.3), angle=1.0)
        r.load_arhosek_sky(3.0, 0.3)
        r.set_sky_intensity(0.05)
        return r, dict(n_samples=8, max_depth=3)

    def g_metal_row():
        r = ft.Renderer(64, 64, device="cuda")
        r.set_scene(sphere_array_test("metalness", [0.0, 0.5, 1.0], spacing=1.05))
        r.camera.origin = np.asarray([0.0, 0.8, 2.2], np.float32)
        r.camera._update_transform()
        r.set_bg_color((0.6, 0.7, 0.9))
        return r, dict(n_samples=16, max_depth=3)

    for name, setup in (("terrain_cluster", g_terrain_cluster), ("hosek_sun", g_hosek_sun),
                        ("metal_row", g_metal_row)):
        r, kw = setup()
        if "clusters" not in r._dev:
            raise AssertionError(f"golden {name} did not take the clustered path")
        _build.LAUNCHES.clear()
        r.render(**kw)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        score_golden("[8]", name, r.get_layer("beauty"), counts, (r.height, r.width, 3))
        for k in ("clustered_closest", "clustered_any", "slot_fetch", "mega"):
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"golden {name}: kernel {k} never launched")
    phase_done(8, t0)

    # ---- 9: metric 2 (bench.py:170-182: hosek sweep 512x288, 8 spp, depth 5)
    t0 = time.perf_counter()
    spp2, depth2 = 8, 5
    pv2, seconds2, launches2 = timed_metric(rs, spp2, depth2, _build)
    beauty2 = rs.get_layer("beauty")
    if not (np.isfinite(beauty2).all() and 0.01 < beauty2.mean() < 100.0):
        raise AssertionError(f"metric-2 image is off: mean {beauty2.mean()}")
    want = {"clustered_closest": depth2 * spp2, "clustered_any": depth2 * spp2,
            "slot_fetch": depth2 * spp2, "mega": depth2 * spp2, "raygen": spp2,
            "final": spp2}
    got = {k: launches2.get(k, 0) for k in want}
    twins = {k: v for k, v in launches2.items() if k.endswith("_twin") and v}
    if got != want or twins or launches2.get("dense_closest"):
        raise AssertionError(f"metric-2 launches {launches2}, expected {want} and no twins")
    print(json.dumps({
        "metric": "hosek_sweep_512x288_8spp_depth5",
        "mpath_vertices_per_s": pv2 / seconds2 / 1e6,
        "path_vertices": pv2,
        "seconds": seconds2,
        "beauty_mean": float(beauty2.mean()),
        "card": card,
        "launches": launches2,
    }))

    profile_busy("[9]", "metric 2", rs, depth2, start_tracer=False)

    # per-kernel times at metric-2 shapes (a real bounce's blocks), in turns
    st, si, rays = kernels.raygen(cfg2, sv2, usv2, n_spp2)
    tr0 = pf.trace_stage(cfg2, sweep_dev, rays, ns, 1, 0)
    st, rays, pend, _ = kernels.mega(cfg2, 0, sv2, usv2, sweep_dev, n_spp2, si, st, rays, None, tr0)
    tr1 = pf.trace_stage(cfg2, sweep_dev, rays, ns, nb2, n_occ)
    trf = pf.trace_stage(cfg2, sweep_dev, rays, ns, nb2 - 1, n_occ)
    occ_view = rays[:, :n_occ * ns]
    rad_view = rays[:, n_occ * ns:nb2 * ns]
    slots = tr1.hits["slot"]
    reps = {"clustered_closest": (10, 1), "clustered_any": (10, 1)}
    times2 = time_pairs("[9]", {
        "clustered_closest": (lambda: clustered.intersect_closest_clustered(c, rad_view),
                              lambda: clustered.intersect_closest_twin(c, rad_view)),
        "clustered_any": (lambda: clustered.intersect_any_clustered(c, occ_view),
                          lambda: clustered.intersect_any_twin(c, occ_view)),
        "slot_fetch": (lambda: slot_fetch.fetch_geom_by_slot(sweep_dev["slot_attrs"], slots),
                       lambda: slot_fetch.fetch_twin(sweep_dev["slot_attrs"], slots)),
        "raygen": (lambda: kernels.raygen(cfg2, sv2, usv2, n_spp2),
                   lambda: pf.raygen_twin(cfg2, sv2, usv2, n_spp2)),
        "mega": (lambda: kernels.mega(cfg2, 1, sv2, usv2, sweep_dev, n_spp2, si, st, rays, pend,
                                      tr1),
                 lambda: pf.mega_twin(cfg2, 1, sv2, usv2, sweep_dev, n_spp2, si, st, rays, pend,
                                      tr1)),
        "final_resolve": (lambda: kernels.final(cfg2, sv2, sweep_dev, st, rays, pend, trf),
                          lambda: pf.final_twin(cfg2, sv2, sweep_dev, st, rays, pend, trf)),
    }, reps)
    if len(trees) > 1:
        tree_turns("[9] d=1", _build, trees, {"mega": lambda: kernels.mega(
            cfg2, 1, sv2, usv2, sweep_dev, n_spp2, si, st, rays, pend, tr1)}, rounds)
    # the work these inputs need: the twins count the kernels' slab,
    # triangle and key-bound tests and the table entries they read (each
    # once); a dead lane reads only its tmax, a live one its 7 floats.
    # Counted twice: the front-to-back walk of the kernels, and the
    # table-order walk of the PR-4 design, whose bounds PERF.md kept
    def ray_bytes(view):
        return 4 * view.shape[1] + 24 * int((view[6] > 0).sum())

    walk_bounds = {}
    for walk, kw in (("front to back", {}), ("table order (PR 4)",
                                             {"order": "table", "early_exit": False})):
        cs, ca = {"slab": 0, "tri": 0}, {"slab": 0, "tri": 0}
        clustered.intersect_closest_twin(c, rad_view, cs, **kw)
        clustered.intersect_any_twin(c, occ_view, ca, **kw)
        walk_bounds[walk] = {
            "clustered_closest": bound(ray_bytes(rad_view) + cs["table_bytes"]
                                       + 24 * rad_view.shape[1],
                                       cs["slab"] * SLAB_OPS + cs["tri"] * TRI_OPS
                                       + cs["key"] * KEY_OPS),
            "clustered_any": bound(ray_bytes(occ_view) + ca["table_bytes"] + occ_view.shape[1],
                                   ca["slab"] * SLAB_OPS + ca["tri"] * TRI_OPS
                                   + ca["key"] * KEY_OPS)}
        for name, st_, view in (("closest", cs, rad_view), ("any", ca, occ_view)):
            b_ms, b_by = walk_bounds[walk][f"clustered_{name}"]
            print(f"[9] {name}, {walk}: {view.shape[1]} rays, {int((view[6] > 0).sum())} live, "
                  f"{st_['slab']} slab, {st_['tri']} triangle and {st_['key']} key-bound "
                  f"tests, table bytes read {st_['table_bytes']} of "
                  f"{nbytes(*(c[k] for k in clustered._TABLE_KEYS))}, entries "
                  f"{json.dumps({k: int(v.sum()) for k, v in st_['read'].items()})}; bound "
                  f"{b_ms:.4f} ms ({b_by})")

    hit_slots = torch.unique(slots[slots >= 0]).numel()
    print(f"[9] slot fetch: {slots.shape[0]} lanes, {int((slots >= 0).sum())} hits, "
          f"{hit_slots} distinct slots")
    bounds2 = {
        **walk_bounds["front to back"],
        # 26 planes written for every lane, read for each distinct hit slot
        "slot_fetch": bound(nbytes(slots) + 4 * slot_fetch.A_USED * (slots.shape[0] + hit_slots),
                            0),
        "raygen": bound(nbytes(n_spp2) + ns * (4 * pf.ST_ROWS + 8 + 4 * pf.RAY_ROWS),
                        ns * STAGE_OPS["raygen"]),
        "mega": bound(mega_bytes(cfg2, pf, kernels, 1, ns, tr1, sweep_dev, sv2, usv2),
                      ns * STAGE_OPS["mega"]),
        "final_resolve": bound(nbytes(st, pend, rays[:, :(nb2 - 1) * ns], trf.occ) + 12 * ns,
                               ns * STAGE_OPS["final_resolve"]),
    }
    for k, (ms, by) in bounds2.items():
        print(f"[9] {k}: bound {ms:.4f} ms ({by})")

    # B4/B5 in every kept variant, in turns: CUDA events around the wrapper
    # calls (the kernel table's times) and CUDA-graph replays (device time
    # alone); at the d = 1 blocks, the primaries, and two floors: all lanes
    # dead, and one live ray (the closest block's) a block of the kernel
    live_idx = torch.nonzero(rad_view[6] > 0.0).flatten()
    dead9 = rad_view.clone()
    dead9[6] = -1.0
    lone9 = dead9.clone()
    first = torch.arange(0, lone9.shape[1], clustered.BLOCK, device=dev)
    lone9[:, first] = rad_view[:, live_idx[:first.numel()]]
    variant_ms = {}
    for name, view, any_hit in (("B4 d=1 closest block", rad_view, False),
                                ("B5 d=1 occlusion blocks", occ_view, True),
                                ("B4 primaries", r0, False),
                                ("B4 floor, all lanes dead", dead9, False),
                                ("B4 floor, one live lane a block", lone9, False)):
        fn = clustered.intersect_any_clustered if any_hit else \
            clustered.intersect_closest_clustered
        fns = {("staged" if sv_ else "global"): (lambda sv_=sv_: fn(c, view, staged=sv_))
               for sv_ in clustered_variants(clustered, c)}
        ev = {k: [] for k in fns}
        gr = {k: [] for k in fns}
        for rnd in range(2):
            for k in (list(fns) if rnd == 0 else list(fns)[::-1]):
                ev[k].append(cuda_ms(fns[k], 10))
                gr[k].append(graph_ms(fns[k]))
        variant_ms[name] = {k: (sum(ev[k]) / 2, sum(gr[k]) / 2) for k in fns}
        print(f"[9] {name}: rays={view.shape[1]} live={int((view[6] > 0).sum())} " + ", ".join(
            f"{k} {e:.4f} ms (events), {g:.4f} ms (graph)"
            for k, (e, g) in variant_ms[name].items()))
    for name, key, was in (("B4 d=1 closest block", "clustered_closest", PR4_MS["B4"]),
                           ("B5 d=1 occlusion blocks", "clustered_any", PR4_MS["B5"])):
        now = variant_ms[name]["staged" if "staged" in variant_ms[name] else "global"][0]
        print(f"[9] {name}: {now:.4f} ms against the PR-4 design's {was} ms (PR 4 run 5): "
              f"{was / now:.2f}x; bound {walk_bounds['front to back'][key][0]:.4f} ms "
              f"(front to back), {walk_bounds['table order (PR 4)'][key][0]:.4f} ms "
              "(table order)")
    phase_done(9, t0)

    # ---- 10: dense any-hit (B3) vs its twin: bit-equal masks
    t0 = time.perf_counter()

    def check_any(name, tri_, rays_):
        m = rays_.shape[1]
        k_occ = dense.intersect_any(tri_, rays_, m)
        t_occ = dense.intersect_any_twin(tri_, rays_, m)
        torch.cuda.synchronize()
        off = (k_occ != t_occ).float().mean().item()
        print(f"[10] {name}: rays={m} live={int((rays_[6] > 0).sum())} "
              f"occluded={int(k_occ.sum())} lanes differing={int((k_occ != t_occ).sum())}")
        if off != 0.0:
            raise AssertionError(f"{name}: dense any-hit kernel differs from its twin")
        return off

    def wavefront_metric1_renderer():
        r = ft.Renderer(W, H, device="cuda")
        r.set_scene(ft.cornell_box())
        r.camera.origin = np.asarray([0.0, 1.0, 0.6], np.float32)
        r.camera._update_transform()
        r.sampler_mode = "bluenoise"
        return r

    rw = wavefront_metric1_renderer()
    if rw._params(5)["use_fused"]:
        raise AssertionError("bluenoise sampling did not route to the wavefront integrator")
    tri_w = rw._dev["tri_soa"]
    nee = first_nee_rays(rw, wavefront)
    results["dense_any"] = max(check_any("soup 1024 tris", s_tri, s_rays),
                               check_any("wavefront NEE, metric-1 bounce", tri_w, nee))
    phase_done(10, t0)

    # ---- 11: goldens of the wavefront integrator through the user entry point
    t0 = time.perf_counter()

    def g_cornell_wavefront():
        r = ft.Renderer(64, 64, device="cuda")
        r.set_scene(ft.cornell_box())
        r.camera.origin = np.asarray([0.0, 1.0, 0.6], np.float32)
        r.camera._update_transform()
        r.use_fused = False
        return r, dict(n_samples=32, max_depth=4), ("dense_closest", "dense_any")

    def g_thin_film():
        r = ft.Renderer(48, 48, device="cuda")
        r.set_scene(sphere_array_test(
            "thin_film_thickness", [250.0, 550.0],
            base=Material(diffuse=0.0, specular=1.0, specular_roughness=0.05), spacing=1.05))
        r.camera.origin = np.asarray([0.0, 0.6, 1.8], np.float32)
        r.camera._update_transform()
        r.set_bg_color((0.9, 0.9, 0.9))
        return r, dict(n_samples=12, max_depth=3), ("clustered_closest", "clustered_any",
                                                    "slot_fetch")

    for name, setup in (("cornell", g_cornell_wavefront), ("thin_film", g_thin_film)):
        r, kw, kernels_used = setup()
        if r._params(kw["max_depth"])["use_fused"]:
            raise AssertionError(f"golden {name} did not route to the wavefront integrator")
        _build.LAUNCHES.clear()
        r.render(**kw)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        score_golden("[11]", name, r.get_layer("beauty"), counts, (r.height, r.width, 3))
        for k in kernels_used:
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"golden {name}: kernel {k} never launched")
        if any(counts.get(k) for k in ("raygen", "mega", "final")):
            raise AssertionError(f"golden {name} ran the fused pipeline: {counts}")
    phase_done(11, t0)

    # ---- 12: the wavefront metric (metric 1's scene, bluenoise sampler)
    t0 = time.perf_counter()
    pv3, seconds3, launches3 = timed_metric(rw, spp, depth, _build)
    beauty3 = rw.get_layer("beauty")
    if not (np.isfinite(beauty3).all() and 0.01 < beauty3.mean() < 10.0):
        raise AssertionError(f"wavefront metric image is off: mean {beauty3.mean()}")
    want3 = {"dense_closest": 2 * depth * spp, "dense_any": depth * spp}
    got3 = {k: launches3.get(k, 0) for k in want3}
    twins3 = {k: v for k, v in launches3.items() if k.endswith("_twin") and v}
    if got3 != want3 or twins3:
        raise AssertionError(f"wavefront metric launches {launches3}, expected {want3} "
                             f"and no twins")
    print(json.dumps({
        "metric": "wavefront_cornell_512x512_16spp_depth5_bluenoise",
        "mpath_vertices_per_s": pv3 / seconds3 / 1e6,
        "path_vertices": pv3,
        "seconds": seconds3,
        "beauty_mean": float(beauty3.mean()),
        "card": card,
        "launches": launches3,
    }))
    # one sample: the tracer runs since [9], and each of the wavefront's
    # several thousand launches a bounce is recorded
    profile_busy("[12]", "the wavefront metric", rw, depth, spp=1, start_tracer=False)
    times3 = time_pairs("[12]", {
        "dense_any": (lambda: dense.intersect_any(tri_w, nee, nee.shape[1]),
                      lambda: dense.intersect_any_twin(tri_w, nee, nee.shape[1])),
    }, {})
    st3 = {"tri": 0}
    dense.intersect_any_twin(tri_w, nee, nee.shape[1], st3)
    live3 = int((nee[6] > 0).sum())
    # a dead ray reads its tmax, a live one its 7 floats; each writes 1 B;
    # the tests run up to each live lane's first occluder
    bounds3 = {"dense_any": bound(4 * nee.shape[1] + 24 * live3 + nee.shape[1],
                                  st3["tri"] * TRI_OPS)}
    print(f"[12] dense_any: {nee.shape[1]} rays, {live3} live, {st3['tri']} triangle tests, "
          f"bound {bounds3['dense_any'][0]:.4f} ms ({bounds3['dense_any'][1]})")
    phase_done(12, t0)

    # ---- 13: the ray-resident traversal (B7) vs its twins and vs B4/B5 at
    # metric 2's bounce shapes
    t0 = time.perf_counter()
    gate = {clustered.RESIDENT_ENV: "1"}
    with environ(**gate):
        rr = sweep_renderer(SW, SH)
        rdev = rr._dev
        rc = rdev["clusters"]
        if "res_meta" not in rc or not resident.routes(rc, coherent=False):
            raise AssertionError("the gate-on sweep carries no resident tables")
        # the d = 1 input of a gate-on render, stage by stage as
        # render_sample_fused runs it: raygen, the coherent d = 0 trace
        # (B4 + B6), mega at d = 0
        p13 = rr._params(5)
        cfg13 = pf.make_config(rdev, p13)
        sv13, usv13 = pf.pack_scalars(p13, ns, dev)
        n_spp13 = torch.full((ns,), 3, dtype=torch.int64, device=dev)
        st13, si13, r0 = kernels.raygen(cfg13, sv13, usv13, n_spp13)
        tr0 = pf.trace_stage(cfg13, rdev, r0, ns, 1, 0, coherent=True)
        _, r13, _, _ = kernels.mega(cfg13, 0, sv13, usv13, rdev, n_spp13, si13, st13, r0, None,
                                    tr0)
        occ13 = r13[:, :n_occ * ns]
        rad13 = r13[:, n_occ * ns:nb2 * ns]
        # the stages before d = 1 do not depend on the gate
        print(f"[13] d = 1 rays equal to [9]'s gate-off ones: {torch.equal(r13, rays)}")
        rk = resident.intersect_closest_resident(rc, rad13)
        ok13 = resident.intersect_any_resident(rc, occ13)
        twin_ms = {}
        twin_ms["resident_closest"], rt = host_ms(
            lambda: resident.intersect_closest_twin(rc, rad13))
        twin_ms["resident_any"], ot13 = host_ms(lambda: resident.intersect_any_twin(rc, occ13))
        for k in ("hit", "prim", "t", "u", "v"):
            if not torch.equal(rk[k], rt[k]):
                raise AssertionError(f"B7 closest differs from its twin in {k}: "
                                     f"{int((rk[k] != rt[k]).sum())} lanes")
        if not torch.equal(ok13, ot13):
            raise AssertionError(f"B7 any-hit differs from its twin on "
                                 f"{int((ok13 != ot13).sum())} lanes")
        results["resident_closest"] = max((rk[k] - rt[k]).abs().max().item()
                                           for k in ("t", "u", "v"))
        results["resident_any"] = (ok13 != ot13).float().mean().item()
        print(f"[13] B7 vs twin: closest {rad13.shape[1]} rays ({int(rk['hit'].sum())} hits), "
              f"any {occ13.shape[1]} rays ({int(ok13.sum())} occluded): bit-equal; twin "
              f"{twin_ms['resident_closest']:.1f} ms and {twin_ms['resident_any']:.1f} ms "
              "(host clock, one call each)")
        # the other design on the same rays
        b4 = clustered.intersect_closest_clustered(rc, rad13)
        b5 = clustered.intersect_any_clustered(rc, occ13)
        h7, h4 = rk["prim"] >= 0, b4["prim"] >= 0
        if not torch.equal(h7, h4) or not torch.equal(ok13, b5):
            raise AssertionError(f"B7 and B4/B5 masks differ: closest "
                                 f"{int((h7 != h4).sum())}, any {int((ok13 != b5).sum())}")
        diff = h7 & (rk["prim"] != b4["prim"])
        rel = (rk["t"] - b4["t"]).abs() / b4["t"].abs().clamp(min=1.0)
        tie = diff & (rel <= TIE_REL)
        same = h7 & ~diff
        dt = (rk["t"] - b4["t"])[same].abs().max().item() if bool(same.any()) else 0.0
        print(f"[13] B7 vs B4/B5 on the same rays: hit and occlusion masks equal; prim "
              f"differs on {int(diff.sum())} lanes, {int(tie.sum())} of them near-ties "
              f"(relative t <= {TIE_REL}); max |dt| where prim agrees {dt:.3g}")
        if int((diff & ~tie).sum()):
            raise AssertionError("B7 and B4 report different triangles away from a tie")
        times13 = turns("[13]", {
            "closest": ("B4", lambda: clustered.intersect_closest_clustered(rc, rad13),
                        "B7", lambda: resident.intersect_closest_resident(rc, rad13)),
            "any": ("B5", lambda: clustered.intersect_any_clustered(rc, occ13),
                    "B7", lambda: resident.intersect_any_resident(rc, occ13)),
        })
        # B7's fixed cost: every block walks every page with a barrier each.
        # Inputs that isolate it: all lanes dead (each block leaves at once),
        # and one live lane a block whose ray misses the root box (each
        # block tests every page box, stages none)
        dead13 = rad13.clone()
        dead13[6] = -1.0
        lone13 = dead13.clone()
        first = torch.arange(0, lone13.shape[1], resident.RES_BLOCK, device=dev)
        lone13[0:3, first] = rc["root_aabb"][0:3, 0:1] - 1000.0
        lone13[3:6, first] = -(3.0 ** -0.5)
        lone13[6, first] = 1e9
        turns("[13]", {"B7 closest floor": (
            "all lanes dead", lambda: resident.intersect_closest_resident(rc, dead13),
            f"one lane a block, missing ({first.numel()} blocks)",
            lambda: resident.intersect_closest_resident(rc, lone13))})
        if int(resident.intersect_closest_resident(rc, lone13)["hit"].sum()):
            raise AssertionError("a ray that misses the root box hit")
        sc13, sa13 = {}, {}
        resident.intersect_closest_twin(rc, rad13, sc13)
        resident.intersect_any_twin(rc, occ13, sa13)
    blocks13 = rc.get("res_blocks", rc["blocks"])
    page_bytes = 4 * blocks13.shape[0] * resident.P_CL * 128
    bounds13 = {}
    for name, st_, view, out_b in (("resident_closest", sc13, rad13, 16),
                                   ("resident_any", sa13, occ13, 1)):
        entries = ", ".join(f"{k} {int(v.sum())}" for k, v in st_["read"].items())
        # each table entry the lanes' tests read, once (the twin's marks)
        n_bytes = ray_bytes(view) + out_b * view.shape[1] + st_["table_bytes"]
        n_ops = (st_["page"] + st_["cluster"] + st_["group"]) * SLAB_OPS + st_["tri"] * TRI_OPS
        bounds13[name] = bound(n_bytes, n_ops)
        print(f"[13] {name}: {view.shape[1]} rays, {int((view[6] > 0).sum())} live; slab tests "
              f"page {st_['page']} cluster {st_['cluster']} group {st_['group']}, triangle "
              f"tests {st_['tri']}; distinct pages {st_['pages']} and meta columns "
              f"{st_['meta_cols']}; staged per block of {resident.RES_BLOCK} rays: "
              f"{st_['block_pages']} pages ({st_['block_pages'] * page_bytes / 1e9:.3f} GB) "
              f"and {st_['block_meta_cols']} meta columns; table bytes read "
              f"{st_['table_bytes']} (entries: {entries}); bound "
              f"{bounds13[name][0]:.4f} ms ({bounds13[name][1]})")
    b45 = {"closest": bounds2["clustered_closest"], "any": bounds2["clustered_any"]}
    for name, key in (("closest", "resident_closest"), ("any", "resident_any")):
        print(f"[13] {name}: B7 {times13[name][1]:.4f} ms (bound {bounds13[key][0]:.4f}), "
              f"B4/B5 {times13[name][0]:.4f} ms (bound at [9]'s rays {b45[name][0]:.4f}); "
              f"B7 / B4-B5 = {times13[name][1] / times13[name][0]:.3f}")
    times_res = {"resident_closest": (times13["closest"][1], twin_ms["resident_closest"]),
                 "resident_any": (times13["any"][1], twin_ms["resident_any"])}
    phase_done(13, t0)

    # ---- 14: goldens with the gate on (and compaction on metal_row)
    t0 = time.perf_counter()
    for name, setup, extra in (("terrain_cluster", g_terrain_cluster, {}),
                               ("hosek_sun", g_hosek_sun, {}),
                               ("metal_row", g_metal_row, {}),
                               ("metal_row", g_metal_row, {"FREDHOLM_COMPACT": "1"})):
        with environ(**gate, **extra):
            r, kw = setup()
            if "res_meta" not in r._dev["clusters"]:
                raise AssertionError(f"golden {name}: no resident tables with the gate on")
            if r._params(kw["max_depth"])["compact"] != extra.get("FREDHOLM_COMPACT", "0"):
                raise AssertionError(f"golden {name}: compaction mode not read")
            _build.LAUNCHES.clear()
            r.render(**kw)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
        score_golden("[14]" + (" compact" if extra else ""), name, r.get_layer("beauty"),
                     counts, (r.height, r.width, 3))
        for k in ("resident_closest", "resident_any", "clustered_closest", "mega"):
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"golden {name} (gate on): kernel {k} never launched")
    phase_done(14, t0)

    # ---- 15: the resident metric (metric 2 with the gate on)
    t0 = time.perf_counter()
    with environ(**gate):
        pv4, seconds4, launches4 = timed_metric(rr, spp2, depth2, _build)
        profile_busy("[15]", "the resident metric", rr, depth2, start_tracer=False)
    beauty4 = rr.get_layer("beauty")
    if not (np.isfinite(beauty4).all() and 0.01 < beauty4.mean() < 100.0):
        raise AssertionError(f"resident metric image is off: mean {beauty4.mean()}")
    # d = 0 traces coherently (B4 + B6); d = 1-4 bounce closest (B7) and
    # occlusion (B7 any); the final stage occlusion only (no emissive faces)
    want4 = {"clustered_closest": spp2, "slot_fetch": spp2,
             "resident_closest": (depth2 - 1) * spp2, "resident_any": depth2 * spp2,
             "mega": depth2 * spp2, "raygen": spp2, "final": spp2}
    got4 = {k: launches4.get(k, 0) for k in want4}
    twins4 = {k: v for k, v in launches4.items() if k.endswith("_twin") and v}
    if got4 != want4 or twins4 or launches4.get("clustered_any"):
        raise AssertionError(f"resident metric launches {launches4}, expected {want4}, no B5 "
                             f"and no twins")
    print(json.dumps({
        "metric": "hosek_sweep_512x288_8spp_depth5_resident",
        "mpath_vertices_per_s": pv4 / seconds4 / 1e6,
        "path_vertices": pv4,
        "seconds": seconds4,
        "beauty_mean": float(beauty4.mean()),
        "card": card,
        "launches": launches4,
        "launches_per_spp": {k: v / spp2 for k, v in launches4.items()},
    }))
    phase_done(15, t0)

    # ---- 16: the FMA probe (P1) vs its twin, then the card's rates
    t0 = time.perf_counter()
    # bit-equal: the twin rounds each step once, as fmaf and __hfma2 do.
    # The reference's tile shapes, then the inputs the rates are timed on;
    # bfloat16 also with constants that move every chain every step (the
    # reference's leave a bfloat16 chain unchanged)
    for rows, dtype in ((8, torch.float32), (16, torch.bfloat16), (1 << 16, torch.float32),
                        (1 << 16, torch.bfloat16)):
        pairs = probe.check(probe.fma_inputs(rows, dtype, dev))
        print(f"[16] P1 {str(dtype)[6:]} [{rows},128]: bit-equal to its twin with (c, d) in "
              f"{pairs}")
    results["probe_fma"] = 0.0
    x16 = probe.fma_inputs(1 << 16, torch.float32, dev)
    _build.LAUNCHES.clear()
    rates = probe.measure(iters=5)
    launches5 = dict(_build.LAUNCHES)
    for name, (ms, rate) in rates.items():
        unit = "GFLOP/s" if name.startswith("fma") else "GB/s (read + write)"
        print(f"[16] {name}: {ms:.4f} ms, {rate:.1f} {unit} on {card}")
    times16 = {"probe_fma": (rates["fma f32"][0],
                             cuda_ms(lambda: probe.fma_chain_twin(x16), 1))}
    bounds16 = {"probe_fma": bound(8 * x16.numel(), probe.FLOPS_PER_ELEMENT * x16.numel())}
    print(f"[16] probe_fma f32 [{x16.shape[0]},128]: kernel {times16['probe_fma'][0]:.4f} ms, "
          f"twin {times16['probe_fma'][1]:.4f} ms, bound {bounds16['probe_fma'][0]:.4f} ms "
          f"({bounds16['probe_fma'][1]}); {probe.FLOPS_PER_ELEMENT} flops an element")
    phase_done(16, t0)

    # ---- 17: compaction A/B on metric 2, the gate off (rs) and on (rr)
    t0 = time.perf_counter()
    ab = {}
    for gate_name, r_ab, env_ab in (("gate off", rs, {}), ("gate on", rr, gate)):
        runs = []
        for mode in ("0", "1", "1", "0"):
            with environ(**env_ab, FREDHOLM_COMPACT=mode):
                if r_ab._params(depth2)["compact"] != mode:
                    raise AssertionError("compaction mode not read")
                pv_ab, s_ab, l_ab = timed_metric(r_ab, spp2, depth2, _build)
            if any(k.endswith("_twin") and v for k, v in l_ab.items()):
                raise AssertionError(f"[17] twins ran: {l_ab}")
            runs.append((mode, pv_ab / s_ab / 1e6))
        mpv = {m: sum(v for k, v in runs if k == m) / 2 for m in ("0", "1")}
        ab[gate_name] = {"compact_0_mpv_s": mpv["0"], "compact_1_mpv_s": mpv["1"],
                         "compact_1_over_0": mpv["1"] / mpv["0"],
                         "turns": [f"{m}:{v}" for m, v in runs]}
    print(json.dumps({"metric": "hosek_sweep_512x288_8spp_depth5_compaction_ab", "card": card,
                      **ab}))
    # where it goes: each trace kernel on [13]'s d = 1 rays as they lie
    # and packed live-first, and the packing's own ops (partition, pack,
    # restore), in turns
    pk = {}
    for name, view in (("closest", rad13), ("any", occ13)):
        dest = compact.partition_dest(view[6] > 0.0)
        pk[name] = compact.compact_rays(dest, view)
        if not torch.equal(pk[name][:, :int((view[6] > 0).sum())], view[:, view[6] > 0]):
            raise AssertionError("packed rays out of order")
    times17 = turns("[17]", {
        "B4": ("as they lie", lambda: clustered.intersect_closest_clustered(rc, rad13),
               "packed", lambda: clustered.intersect_closest_clustered(rc, pk["closest"])),
        "B5": ("as they lie", lambda: clustered.intersect_any_clustered(rc, occ13),
               "packed", lambda: clustered.intersect_any_clustered(rc, pk["any"])),
        "B7 closest": ("as they lie", lambda: resident.intersect_closest_resident(rc, rad13),
                       "packed", lambda: resident.intersect_closest_resident(rc, pk["closest"])),
        "B7 any": ("as they lie", lambda: resident.intersect_any_resident(rc, occ13),
                   "packed", lambda: resident.intersect_any_resident(rc, pk["any"])),
    })

    def pack_round_trip(view):
        dest = compact.partition_dest(view[6] > 0.0)
        packed = compact.compact_rays(dest, view)
        return compact.uncompact_occ(dest, packed[6] > 0.0)

    turns("[17]", {"packing ops": ("closest block", lambda: pack_round_trip(rad13),
                                   "occlusion blocks", lambda: pack_round_trip(occ13))})
    print("[17] packed / as they lie: " + ", ".join(
        f"{k} {v[1] / v[0]:.3f}" for k, v in times17.items()))
    phase_done(17, t0)

    # ---- 18: mega's full variant vs its twins on the four lobe setups
    t0 = time.perf_counter()
    full_ptxas = {k: v for k, v in _build.BUILD_INFO.get("ptxas", {}).items()
                  if "k_mega_full" in k}
    print(f"[18] ptxas of the full mega variant: {full_ptxas}")
    if not full_ptxas:
        raise AssertionError("no k_mega_full among the built kernels")
    full_err = []
    for name, lobe in STAGE_GOLDENS.items():
        r, kw = golden_setup(name, 512)
        p18 = r._params(kw["max_depth"])
        cfg18 = pf.make_config(r._dev, p18)
        n18 = r.width * r.height
        if lobe not in cfg18.lobes_on or kernels.mega_variant(cfg18) != "full":
            raise AssertionError(f"[18] {name}: lobes {cfg18.lobes_on} do not take the full "
                                 "variant")
        sv18, usv18 = pf.pack_scalars(p18, n18, dev)
        n_spp18 = torch.full((n18,), 3, dtype=torch.int64, device=dev)
        inside = []
        res18 = compare_stages(f"[18] {name}", cfg18, pf, kernels, sv18, usv18, r._dev, n_spp18,
                               stage_tracer(pf, cfg18, r._dev, n18, inside),
                               depths=range(cfg18.max_depth))
        print(f"[18] {name} ({lobe}, lobes {cfg18.lobes_on}, {r.width}x{r.height}, depth "
              f"{cfg18.max_depth}): live lanes hitting a face from its back, per bounce {inside}")
        if name == "transmission_rough" and not sum(inside[1:]):
            raise AssertionError("[18] transmission_rough: no lane shaded from inside a sphere")
        full_err.append(res18["mega"])
        for k in ("raygen", "final_resolve"):
            results[k] = max(results[k], res18[k])
    results["mega_full"] = max(full_err)
    phase_done(18, t0)

    # ---- 19: the nine goldens the port gained, through the user entry point
    t0 = time.perf_counter()
    for name in NEW_GOLDENS:
        r, kw = golden_setup(name)
        if not r._params(kw["max_depth"])["use_fused"]:
            raise AssertionError(f"[19] golden {name} did not route to the fused pipeline")
        _build.LAUNCHES.clear()
        r.render(**kw)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        img = r.get_layer("beauty")
        score_golden("[19]", name, img, counts, (r.height, r.width, 3))
        want_full = kw["n_samples"] * kw["max_depth"] if name in LOBE_GOLDENS else 0
        if counts.get("mega", 0) <= 0 or counts.get("mega_full", 0) != want_full:
            raise AssertionError(f"[19] golden {name}: mega launches {counts}, the full "
                                 f"variant expected {want_full} times")
        if name == "furnace":
            # the bar tests/test_golden.py:40-46 holds the committed golden to
            mean = float(np.clip(img, 0.0, 4.0).mean())
            print(f"[19] furnace: image mean {mean:.6f}, {abs(mean - 0.5) / 0.5:.6f} from 0.5")
            if abs(mean - 0.5) > 0.01 * 0.5:
                raise AssertionError(f"[19] furnace mean {mean} not within 1% of 0.5")
    phase_done(19, t0)

    # ---- 20: the lobe metrics: the six lobe goldens' setups at 512x512
    t0 = time.perf_counter()
    spp20 = 8
    launches20 = {}
    for name in LOBE_GOLDENS:
        r, kw = golden_setup(name, 512)
        d20 = kw["max_depth"]
        pv20, seconds20, l20 = timed_metric(r, spp20, d20, _build)
        beauty20 = r.get_layer("beauty")
        if not (np.isfinite(beauty20).all() and 0.001 < beauty20.mean() < 100.0):
            raise AssertionError(f"[20] {name} image is off: mean {beauty20.mean()}")
        twins20 = {k: v for k, v in l20.items() if k.endswith("_twin") and v}
        if twins20 or l20.get("mega_full", 0) != d20 * spp20:
            raise AssertionError(f"[20] {name} launches {l20}: expected the full variant "
                                 f"{d20 * spp20} times and no twins")
        launches20[name] = l20
        print(json.dumps({
            "metric": f"{name}_512x512_{spp20}spp_depth{d20}",
            "mpath_vertices_per_s": pv20 / seconds20 / 1e6,
            "path_vertices": pv20,
            "seconds": seconds20,
            "beauty_mean": float(beauty20.mean()),
            "card": card,
            "launches": l20,
        }))
        if name == "spec_transmission":
            profile_busy("[20]", "spec_transmission at 512x512", r, d20, start_tracer=False)

    # the full variant at transmission_rough's d = 1, against its twin and
    # beside its bound: CUDA events around the wrapper, and graph replays
    r, kw = golden_setup("transmission_rough", 512)
    p20 = r._params(kw["max_depth"])
    cfg20 = pf.make_config(r._dev, p20)
    n20 = r.width * r.height
    sv20, usv20 = pf.pack_scalars(p20, n20, dev)
    n_spp20 = torch.full((n20,), 3, dtype=torch.int64, device=dev)
    tracer20 = stage_tracer(pf, cfg20, r._dev, n20)
    st, si, rays = kernels.raygen(cfg20, sv20, usv20, n_spp20)
    st, rays, pend, _ = kernels.mega(cfg20, 0, sv20, usv20, r._dev, n_spp20, si, st, rays, None,
                                     tracer20(rays, 0))
    tr20 = tracer20(rays, 1)

    def full20():
        return kernels.mega(cfg20, 1, sv20, usv20, r._dev, n_spp20, si, st, rays, pend, tr20)

    times20 = time_pairs("[20]", {"mega_full": (full20, lambda: pf.mega_twin(
        cfg20, 1, sv20, usv20, r._dev, n_spp20, si, st, rays, pend, tr20))}, {})
    graph20 = graph_ms(full20)
    if len(full_trees) > 1:
        tree_turns("[20] transmission_rough d=1", _build, {t: trees[t] for t in full_trees},
                   {"mega_full": full20}, rounds)
    work20 = (mega_bytes(cfg20, pf, kernels, 1, n20, tr20, r._dev, sv20, usv20),
              n20 * STAGE_OPS["mega_full"])
    bounds20 = {"mega_full": bound(*work20)}
    print(f"[20] mega_full at transmission_rough's d = 1: {n20} lanes, alive "
          f"{int((st[pf.ST_ALIVE] != 0).sum())}; events {times20['mega_full'][0]:.4f} ms, graph "
          f"{graph20:.4f} ms, twin {times20['mega_full'][1]:.4f} ms; bound bytes "
          f"{work20[0] / PEAK_BYTES_PER_S * 1e3:.4f} ms, operations "
          f"{work20[1] / PEAK_FP32_PER_S * 1e3:.4f} ms at 67 TFLOP/s "
          f"({work20[1] / (PEAK_FP32_PER_S / 2) * 1e3:.4f} unfused); the row uses "
          f"{bounds20['mega_full'][1]}")
    phase_done(20, t0)

    # ---- 21: mega's textured variant vs its twins on the three texture setups
    t0 = time.perf_counter()
    tex_ptxas = {k: v for k, v in _build.BUILD_INFO.get("ptxas", {}).items()
                 if "k_mega_tex" in k or "k_final" in k}
    print(f"[21] ptxas of the textured mega variant and the final resolve: {tex_ptxas}")
    if not any("k_mega_tex" in k for k in tex_ptxas):
        raise AssertionError("no k_mega_tex among the built kernels")
    tex_err = []
    for name, kind in TEXTURE_GOLDENS.items():
        r, kw = golden_setup(name, 512)
        p21 = r._params(kw["max_depth"])
        cfg21 = pf.make_config(r._dev, p21)
        n21 = r.width * r.height
        if cfg21.tex_kinds != (kind,) or kernels.mega_variant(cfg21) != "tex":
            raise AssertionError(f"[21] {name}: texture kinds {cfg21.tex_kinds} do not take "
                                 "the textured variant")
        sv21, usv21 = pf.pack_scalars(p21, n21, dev)
        n_spp21 = torch.full((n21,), 3, dtype=torch.int64, device=dev)
        res21 = compare_stages(f"[21] {name}", cfg21, pf, kernels, sv21, usv21, r._dev, n_spp21,
                               stage_tracer(pf, cfg21, r._dev, n21),
                               depths=range(cfg21.max_depth))
        print(f"[21] {name} ({kind}, lobes {cfg21.lobes_on}, {r.width}x{r.height}, depth "
              f"{cfg21.max_depth}, {r._dev['n_lights']} area lights, "
              f"{r._dev['tex_runs'].shape[0]} texel runs)")
        tex_err.append(res21["mega"])
        for k in ("raygen", "final_resolve"):
            results[k] = max(results[k], res21[k])
    results["mega_tex"] = max(tex_err)
    phase_done(21, t0)

    # ---- 22: the three texture goldens, through the user entry point
    t0 = time.perf_counter()
    for name in TEXTURE_GOLDENS:
        r, kw = golden_setup(name)
        if not r._params(kw["max_depth"])["use_fused"]:
            raise AssertionError(f"[22] golden {name} did not route to the fused pipeline")
        _build.LAUNCHES.clear()
        r.render(**kw)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        score_golden("[22]", name, r.get_layer("beauty"), counts, (r.height, r.width, 3))
        want_tex = kw["n_samples"] * kw["max_depth"]
        if counts.get("mega_tex", 0) != want_tex or counts.get("mega", 0) != want_tex \
                or counts.get("final", 0) != kw["n_samples"]:
            raise AssertionError(f"[22] golden {name}: launches {counts}, the textured variant "
                                 f"expected {want_tex} times")
    print("[22] the port scores 17 of the 20 goldens (left: hero, instanced, ibl)")
    phase_done(22, t0)

    # ---- 23: the texture metrics: the three setups at 512x512
    t0 = time.perf_counter()
    spp23 = 8
    launches23 = {}
    for name in TEXTURE_GOLDENS:
        r, kw = golden_setup(name, 512)
        d23 = kw["max_depth"]
        pv23, seconds23, l23 = timed_metric(r, spp23, d23, _build)
        beauty23 = r.get_layer("beauty")
        if not (np.isfinite(beauty23).all() and 0.001 < beauty23.mean() < 100.0):
            raise AssertionError(f"[23] {name} image is off: mean {beauty23.mean()}")
        twins23 = {k: v for k, v in l23.items() if k.endswith("_twin") and v}
        if twins23 or l23.get("mega_tex", 0) != d23 * spp23:
            raise AssertionError(f"[23] {name} launches {l23}: expected the textured variant "
                                 f"{d23 * spp23} times and no twins")
        launches23[name] = l23
        print(json.dumps({
            "metric": f"{name}_512x512_{spp23}spp_depth{d23}",
            "mpath_vertices_per_s": pv23 / seconds23 / 1e6,
            "path_vertices": pv23,
            "seconds": seconds23,
            "beauty_mean": float(beauty23.mean()),
            "card": card,
            "launches": l23,
        }))
        if name == "texture":
            profile_busy("[23]", "texture at 512x512", r, d23, start_tracer=False)

    # the textured variant at texture's d = 1, against its twin and beside
    # its bound: CUDA events around the wrapper, and graph replays
    r, kw = golden_setup("texture", 512)
    p23 = r._params(kw["max_depth"])
    cfg23 = pf.make_config(r._dev, p23)
    n23 = r.width * r.height
    sv23, usv23 = pf.pack_scalars(p23, n23, dev)
    n_spp23 = torch.full((n23,), 3, dtype=torch.int64, device=dev)
    tracer23 = stage_tracer(pf, cfg23, r._dev, n23)
    st, si, rays = kernels.raygen(cfg23, sv23, usv23, n_spp23)
    st, rays, pend, _ = kernels.mega(cfg23, 0, sv23, usv23, r._dev, n_spp23, si, st, rays, None,
                                     tracer23(rays, 0))
    tr23 = tracer23(rays, 1)

    def tex23():
        return kernels.mega(cfg23, 1, sv23, usv23, r._dev, n_spp23, si, st, rays, pend, tr23)

    times23 = time_pairs("[23]", {"mega_tex": (tex23, lambda: pf.mega_twin(
        cfg23, 1, sv23, usv23, r._dev, n_spp23, si, st, rays, pend, tr23))}, {})
    graph23 = graph_ms(tex23)
    if len(tex_trees) > 1:
        tree_turns("[23] texture d=1", _build, {t: trees[t] for t in tex_trees},
                   {"mega_tex": tex23}, rounds)
    work23 = (mega_bytes(cfg23, pf, kernels, 1, n23, tr23, r._dev, sv23, usv23),
              n23 * STAGE_OPS["mega_tex"])
    bounds23 = {"mega_tex": bound(*work23)}
    print(f"[23] mega_tex at texture's d = 1: {n23} lanes, alive "
          f"{int((st[pf.ST_ALIVE] != 0).sum())}, texel runs {r._dev['tex_runs'].shape[0]} "
          f"({nbytes(r._dev['tex_runs'])} B); events {times23['mega_tex'][0]:.4f} ms, graph "
          f"{graph23:.4f} ms, twin {times23['mega_tex'][1]:.4f} ms; bound bytes "
          f"{work23[0] / PEAK_BYTES_PER_S * 1e3:.4f} ms, operations "
          f"{work23[1] / PEAK_FP32_PER_S * 1e3:.4f} ms at 67 TFLOP/s "
          f"({work23[1] / (PEAK_FP32_PER_S / 2) * 1e3:.4f} unfused); the row uses "
          f"{bounds23['mega_tex'][1]}")
    phase_done(23, t0)

    # ---- 6: records. dense_closest and mega are timed on metric 1's path
    # (its d = 1 bounce), dense_any on the wavefront metric's, the resident
    # kernels on metric 2's bounce rays with the gate on (launches: the
    # resident metric's), probe_fma on its probe run, mega_full and
    # mega_tex at their d = 1 of [20] and [23] (launches: the
    # transmission_rough and texture metrics'), the others on metric 2's
    # (raygen and final: metric 1's times print in [5])
    src = "fredholm_tpu_torch/csrc/"
    table = [
        ("dense_closest", "dense_closest.cu", "fredholm_tpu/accel/pallas_dense.py:93",
         "dense_closest", times1, bounds1, launches1),
        ("dense_any", "dense_any.cu", "fredholm_tpu/accel/pallas_dense.py:139",
         "dense_any", times3, bounds3, launches3),
        ("raygen", "shade.cu", "fredholm_tpu/fused/kernels.py:47", "raygen", times2,
         bounds2, launches2),
        ("mega", "shade.cu", "fredholm_tpu/fused/kernels.py:47", "mega", times1, bounds1,
         launches1),
        ("final_resolve", "shade.cu", "fredholm_tpu/fused/kernels.py:47", "final", times2,
         bounds2, launches2),
        ("clustered_closest", "clustered.cu", "fredholm_tpu/accel/pallas_clustered.py:240",
         "clustered_closest", times2, bounds2, launches2),
        ("clustered_any", "clustered.cu", "fredholm_tpu/accel/pallas_clustered.py:240",
         "clustered_any", times2, bounds2, launches2),
        ("slot_fetch", "slot_fetch.cu", "fredholm_tpu/fused/slot_fetch.py:76", "slot_fetch",
         times2, bounds2, launches2),
        ("resident_closest", "resident.cu", "fredholm_tpu/experimental/pallas_resident.py:105",
         "resident_closest", times_res, bounds13, launches4),
        ("resident_any", "resident.cu", "fredholm_tpu/experimental/pallas_resident.py:105",
         "resident_any", times_res, bounds13, launches4),
        ("probe_fma", "probe_fma.cu", "tools/probe_bf16.py:36", "probe_fma", times16, bounds16,
         launches5),
        ("mega_full", "shade.cu", "fredholm_tpu/fused/kernels.py:47", "mega_full", times20,
         bounds20, launches20["transmission_rough"]),
        ("mega_tex", "shade.cu", "fredholm_tpu/fused/kernels.py:47", "mega_tex", times23,
         bounds23, launches23["texture"]),
    ]
    kern_json = [
        {"name": name, "route": "cuda", "source": src + f, "replaces": rep,
         "launches": int(lch.get(key, 0)), "max_abs_err": results[name],
         "ms": tms[name][0], "plain_ms": tms[name][1], "bound_ms": bnd[name][0],
         "bound_by": bnd[name][1], "library_ms": None}
        for name, f, rep, key, tms, bnd, lch in table
    ]
    print(f"[6] phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}, "
          f"total {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kern_json}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
