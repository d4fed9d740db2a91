#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fredholm_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing before the next; any failure raises and the script
exits non-zero without the final `ok` line:

0. the card's name and power limit (nvidia-smi); no CUDA device -> error
1. build the CUDA kernels from csrc/ (nvcc), print build time and spills
2. dense closest-hit kernel vs its twin: Cornell with 4 x 512^2 rays from
   a real raygen + first bounce, and a 1024-triangle soup with 2^20 rays
   (dead lanes and rays at shared edges included)
3. shading kernels vs their twins on the same inputs: raygen, mega at
   d = 0 and d = 1, final resolve
4. the Cornell golden (64^2, 32 spp, depth 4) rendered through
   Renderer(device="cuda") and scored against tests/golden/cornell.npz
5. metric 1: Cornell 512^2, 16 spp, depth 5 after 2 warm-up spp, with the
   launch counts of that run, and per-kernel times vs the plain twins
6. the kernel table, the card line, then {"ok": true, "device": ...}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel-vs-twin tolerances. The kernels build with -fmad=false and no fast
# math, but sin/cos/tan/sqrt/rsqrt differ by a few ulp between nvcc's
# device library and the torch ops the twins run, and a few ulp can flip a
# branch (RR, a shared quad edge), so masks are compared by agreement
# fraction and values only on lanes whose masks agree.
MASK_AGREE_MIN = 0.999
VALUE_RTOL = 1e-4
VALUE_ATOL = 1e-4
VALUE_AGREE_MIN = 0.999
DENSE_REL_TOL = 1e-5
TIE_REL = 1e-6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    import torch

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


def compare_dense(name, kern, twin, m):
    """Hit masks by agreement; prim equal except near-ties; t/u/v close."""
    import torch

    hk, ht = kern["prim"] >= 0, twin["prim"] >= 0
    agree = (hk == ht).float().mean().item()
    both = hk & ht
    same = both & (kern["prim"] == twin["prim"])
    diff = both & ~same
    tie = diff & ((kern["t"] - twin["t"]).abs() <= TIE_REL * twin["t"].abs().clamp(min=1.0))
    errs = {}
    for k in ("t", "u", "v"):
        e = (kern[k] - twin[k]).abs()
        e = torch.where(same | (~hk & ~ht), e, torch.zeros_like(e))
        errs[k] = e.max().item()
    rel_t = ((kern["t"] - twin["t"]).abs() / twin["t"].abs().clamp(min=1.0))
    rel_t = torch.where(same | (~hk & ~ht), rel_t, torch.zeros_like(rel_t)).max().item()
    n_bad_prim = int((diff & ~tie).sum().item())
    print(f"[2] {name}: rays={m} hit-mask agreement={agree:.7f} "
          f"hits={int(both.sum())} prim-diff={int(diff.sum())} (near-tie "
          f"{int(tie.sum())}) max|dt|={errs['t']:.3g} rel_t={rel_t:.3g} "
          f"max|du|={errs['u']:.3g} max|dv|={errs['v']:.3g}")
    if agree < 1.0 - 1e-4 or n_bad_prim > max(1, m // 100000):
        raise AssertionError(f"{name}: dense kernel disagrees with its twin")
    if rel_t > DENSE_REL_TOL or max(errs["u"], errs["v"]) > DENSE_REL_TOL:
        raise AssertionError(f"{name}: dense kernel t/u/v off by more than {DENSE_REL_TOL}")
    return max(errs.values())


def compare_planes(name, kern, twin, mask_rows=()):
    """Packed planes [R, M]: mask rows (x > 0) by lane agreement, then all
    rows on agreeing lanes within rtol/atol. Returns max |error| there."""
    import torch

    if kern.dtype != torch.float32:
        eq = (kern == twin).float().mean().item()
        print(f"[3] {name}: exact-equal fraction={eq:.7f}")
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
    err = torch.where(lanes[None] & torch.isfinite(kern) & torch.isfinite(twin),
                      (kern - twin).abs(), torch.zeros_like(kern)).max().item()
    print(f"[3] {name}: mask agreement={mask_agree:.7f} value agreement="
          f"{value_agree:.7f} max|err| on agreeing lanes={err:.3g}")
    if mask_agree < MASK_AGREE_MIN or value_agree < VALUE_AGREE_MIN:
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    return err


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


def main() -> None:
    # ---- 0: card
    card = card_line()
    print(f"[0] card: {card}")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, ROOT)
    import fredholm_tpu_torch as ft
    from fredholm_tpu_torch import _build
    from fredholm_tpu_torch.accel import dense
    from fredholm_tpu_torch.fused import kernels
    from fredholm_tpu_torch.fused import pt_fused as pf
    from fredholm_tpu_torch.scene.device import build_device_scene
    from fredholm_tpu_torch.utils.ssim import ssim

    dev = torch.device("cuda")
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- 1: build
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    spills = {k: v for k, v in _build.BUILD_INFO.get("ptxas", {}).items()}
    print(f"[1] kernels built and loaded in {build_s:.1f} s "
          f"(nvcc {_build.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    for name, info in spills.items():
        print(f"[1] ptxas {name}: {info}")

    results = {}

    # ---- 2: dense closest-hit vs twin
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
    state1, rays1, pend1, aov0 = kernels.mega(cfg, 0, sv, usv, scene_dev, n_spp, sidx,
                                              state0, rays0, hits0, None)
    m1 = rays1.shape[1]
    kh = dense.intersect_closest(tri, rays1, m1)
    th = dense.intersect_closest_twin(tri, rays1, m1)
    torch.cuda.synchronize()
    err_c = compare_dense("cornell 4x512^2", kh, th, m1)
    s_tri, s_rays = soup(1024, 1 << 20, 7, dev)
    err_s = compare_dense("soup 1024 tris", dense.intersect_closest(s_tri, s_rays, 1 << 20),
                          dense.intersect_closest_twin(s_tri, s_rays, 1 << 20), 1 << 20)
    results["dense_closest"] = max(err_c, err_s)

    # ---- 3: shading kernels vs twins, same inputs
    k_st, k_si, k_r = kernels.raygen(cfg, sv, usv, n_spp)
    t_st, t_si, t_r = pf.raygen_twin(cfg, sv, usv, n_spp)
    e = [compare_planes("raygen state", k_st, t_st, [pf.ST_ALIVE]),
         compare_planes("raygen sample_idx", k_si, t_si),
         compare_planes("raygen rays", k_r, t_r, [6])]
    results["raygen"] = max(e)

    hits = dense.intersect_closest(tri, k_r, n)
    e = []
    outs = {}
    for d in (0, 1):
        pend = None if d == 0 else outs[0][0][2]
        st_in, r_in = (k_st, k_r) if d == 0 else (outs[0][0][0], outs[0][0][1])
        if d == 1:
            hits = dense.intersect_closest(tri, r_in, r_in.shape[1])
        ko = kernels.mega(cfg, d, sv, usv, scene_dev, n_spp, k_si, st_in, r_in, hits, pend)
        to = pf.mega_twin(cfg, d, sv, usv, scene_dev, n_spp, k_si, st_in, r_in, hits, pend)
        outs[d] = (ko, to, r_in, hits)
        nb = len(cfg.blocks)
        ray_rows = [6]
        e.append(compare_planes(f"mega d={d} state", ko[0], to[0], [pf.ST_ALIVE]))
        for b in range(nb):
            e.append(compare_planes(f"mega d={d} rays[{cfg.blocks[b]}]",
                                    ko[1][:, b * n:(b + 1) * n], to[1][:, b * n:(b + 1) * n],
                                    ray_rows))
        e.append(compare_planes(f"mega d={d} pending", ko[2], to[2]))
        if d == 0:
            e.append(compare_planes("mega d=0 aov", ko[3], to[3]))
    results["mega"] = max(e)

    ko1 = outs[1][0]
    fh = dense.intersect_closest(tri, ko1[1], (len(cfg.blocks) - 1) * n)
    k_rad = kernels.final(cfg, sv, scene_dev, ko1[0], ko1[1], fh, ko1[2])
    t_rad = pf.final_twin(cfg, sv, scene_dev, ko1[0], ko1[1], fh, ko1[2])
    results["final_resolve"] = compare_planes("final radiance", k_rad, t_rad)

    # ---- 4: the golden through the user entry point
    r = ft.Renderer(64, 64, device="cuda")
    r.set_scene(ft.cornell_box())
    r.camera.origin = np.asarray([0.0, 1.0, 0.6], np.float32)
    r.camera._update_transform()
    _build.LAUNCHES.clear()
    r.render(n_samples=32, max_depth=4)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    img = r.get_layer("beauty")
    golden = np.load(os.path.join(ROOT, "tests", "golden", "cornell.npz"))["image"]
    a = np.clip(golden.astype(np.float32), 0.0, 1.0)
    b = np.clip(img, 0.0, 1.0)
    score = ssim(a, b)
    mean_rel = abs(float(b.mean()) - float(a.mean())) / float(a.mean())
    print(f"[4] golden cornell 64^2 32spp d4: SSIM={score:.5f} mean={b.mean():.5f} "
          f"golden mean={a.mean():.5f} rel={mean_rel:.5f} finite={np.isfinite(img).all()} "
          f"launches={counts}")
    if not (np.isfinite(img).all() and img.shape == (64, 64, 3)):
        raise AssertionError("golden render is not a finite 64x64x3 image")
    if score < 0.98 or mean_rel > 0.02:
        raise AssertionError(f"golden mismatch: SSIM {score:.4f}, mean rel {mean_rel:.4f}")
    if counts.get("dense_closest", 0) != (4 + 1) * 32:
        raise AssertionError(f"dense kernel launched {counts.get('dense_closest')} times")
    for k in ("raygen", "mega", "final"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    twins = {k: v for k, v in counts.items() if k.endswith("_twin") and v}
    if twins:
        raise AssertionError(f"twins ran on the CUDA main path: {twins}")

    # ---- 5: metric 1 (bench.py metric 1: Cornell 512^2, 16 spp, depth 5)
    spp, depth = 16, 5
    r = ft.Renderer(512, 512, device="cuda")
    r.set_scene(ft.cornell_box())
    r.camera.origin = np.asarray([0.0, 1.0, 0.6], np.float32)
    r.camera._update_transform()
    r.render(n_samples=2, max_depth=depth)  # warm-up
    torch.cuda.synchronize()
    per_call = []
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    for _ in range(spp):
        # zero the float32 lifetime counter so each call's count is exact
        r.layers["n_path_vertices"] = torch.zeros_like(r.layers["n_path_vertices"])
        r.render(n_samples=1, max_depth=depth)
        per_call.append(r.layers["n_path_vertices"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    pv = float(np.sum([float(x) for x in per_call], dtype=np.float64))
    beauty = r.get_layer("beauty")
    if not (np.isfinite(beauty).all() and 0.01 < beauty.mean() < 10.0):
        raise AssertionError(f"metric-1 image is off: mean {beauty.mean()}")
    if launches.get("dense_closest", 0) != (depth + 1) * spp:
        raise AssertionError(f"dense kernel launched {launches.get('dense_closest')} "
                             f"times, expected {(depth + 1) * spp}")
    for k in ("raygen", "mega", "final"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    twins = {k: v for k, v in launches.items() if k.endswith("_twin") and v}
    if twins:
        raise AssertionError(f"twins ran on the CUDA main path: {twins}")
    metric = {
        "metric": "cornell_512x512_16spp_depth5",
        "mpath_vertices_per_s": pv / seconds / 1e6,
        "path_vertices": pv,
        "seconds": seconds,
        "beauty_mean": float(beauty.mean()),
        "card": card,
        "launches": launches,
    }
    print(json.dumps(metric))

    # per-kernel times at main-path shapes (CUDA events), in turns
    st, si, rays = kernels.raygen(cfg, sv, usv, n_spp)
    h = dense.intersect_closest(tri, rays, n)
    st, rays, pend, _ = kernels.mega(cfg, 0, sv, usv, scene_dev, n_spp, si, st, rays, h, None)
    h4 = dense.intersect_closest(tri, rays, rays.shape[1])
    hf = dense.intersect_closest(tri, rays, (len(cfg.blocks) - 1) * n)
    pairs = {
        "dense_closest": (lambda: dense.intersect_closest(tri, rays, rays.shape[1]),
                          lambda: dense.intersect_closest_twin(tri, rays, rays.shape[1])),
        "raygen": (lambda: kernels.raygen(cfg, sv, usv, n_spp),
                   lambda: pf.raygen_twin(cfg, sv, usv, n_spp)),
        "mega": (lambda: kernels.mega(cfg, 1, sv, usv, scene_dev, n_spp, si, st, rays, h4, pend),
                 lambda: pf.mega_twin(cfg, 1, sv, usv, scene_dev, n_spp, si, st, rays, h4, pend)),
        "final_resolve": (lambda: kernels.final(cfg, sv, scene_dev, st, rays, hf, pend),
                          lambda: pf.final_twin(cfg, sv, scene_dev, st, rays, hf, pend)),
    }
    times = {}
    for name, (kf, tf) in pairs.items():
        p1 = cuda_ms(tf, 3)
        k1 = cuda_ms(kf, 20)
        k2 = cuda_ms(kf, 20)
        p2 = cuda_ms(tf, 3)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[5] {name}: kernel {times[name][0]:.4f} ms, twin {times[name][1]:.4f} ms "
              f"(turns: twin {p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, twin {p2:.4f})")

    # ---- 6: records
    src = "fredholm_tpu_torch/csrc/"
    table = [
        ("dense_closest", "dense_closest.cu", "fredholm_tpu/accel/pallas_dense.py:93",
         "dense_closest"),
        ("raygen", "shade.cu", "fredholm_tpu/fused/kernels.py:47", "raygen"),
        ("mega", "shade.cu", "fredholm_tpu/fused/kernels.py:47", "mega"),
        ("final_resolve", "shade.cu", "fredholm_tpu/fused/kernels.py:47", "final"),
    ]
    kern_json = [
        {"name": name, "route": "cuda", "source": src + f, "replaces": rep,
         "launches": int(launches.get(key, 0)), "max_abs_err": results[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, f, rep, key in table
    ]
    print(json.dumps({"kernels": kern_json}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
