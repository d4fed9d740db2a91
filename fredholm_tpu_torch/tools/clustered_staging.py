"""Time B4/B5's two top-level layouts against each other on the card.

Run from the repository root on a machine with an NVIDIA GPU:
    python3 -m fredholm_tpu_torch.tools.clustered_staging [pairs]

csrc/clustered.cu builds each kernel twice: with the supercluster and
member-cluster records, the visit orders and their keys staged in each
block's shared memory, and with the same records read from global
memory. This script holds both bit-equal on the hosek sweep (metric 2's
scene) and times them in `pairs` pairs (default 20), the order inside a
pair alternating, on metric 2's d = 1 closest block (147,456 rays), its
occlusion blocks (442,368) and the 512x288 primaries: device ms of one
call from CUDA-graph replays, and CUDA events around back-to-back
wrapper calls. The same pairs of the global kernel against itself give
the spread of a pair that differs in nothing. It also times, on the host
clock, the wrapper's input check that read every table on each call
against the one that checks only the rays, and the all-dead floor of the
wrapper with each.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")  # the repository root: chip_smoke.py
import chip_smoke as cs  # noqa: E402
import fredholm_tpu_torch as ft  # noqa: E402
from fredholm_tpu_torch import _build  # noqa: E402
from fredholm_tpu_torch.accel import clustered as cl  # noqa: E402
from fredholm_tpu_torch.fused import kernels  # noqa: E402
from fredholm_tpu_torch.fused import pt_fused as pf  # noqa: E402
from fredholm_tpu_torch.scene.procedural import hosek_sweep_scene  # noqa: E402


def check_every_table(c, rays):
    """The wrapper's input check before the tables were checked once at
    `prepare_clustered`: every table's dtype, layout, device and shape on
    every call."""
    cl._check(c, rays)
    cl._check_tables(c)
    for k in cl._TABLE_KEYS + cl._RECORD_KEYS:
        if c[k].device != rays.device:
            raise ValueError(k)


def summary(xs):
    return {"mean": statistics.fmean(xs), "min": min(xs), "max": max(xs),
            "stdev": statistics.stdev(xs)}


def main() -> None:
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(cs.card_line(), flush=True)
    t0 = time.time()
    _build.lib()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    sw, sh = 512, 288
    ns = sw * sh
    r = ft.Renderer(sw, sh, device="cuda")
    r.set_scene(hosek_sweep_scene())
    r.camera.origin = np.asarray([0.0, 2.0, 8.0], np.float32)
    r.camera.look_around(0.0, 0.0)
    r.camera._update_transform()
    r.set_directional_light([2.0, 1.9, 1.8], [0.35, 0.75, 0.3], angle=0.5)
    r.load_arhosek_sky(turbidity=3.0, albedo=0.3)
    sd = r._dev
    c = sd["clusters"]
    print(f"staged tables {cl.stage_bytes(c)} B", flush=True)
    p2 = r._params(5)
    cfg = pf.make_config(sd, p2)
    sv, usv = pf.pack_scalars(p2, ns, dev)
    n_spp = torch.full((ns,), 3, dtype=torch.int64, device=dev)
    n_occ = len(cfg.occ_blocks(True))
    nb = len(cfg.blocks)
    st0, si0, r0 = kernels.raygen(cfg, sv, usv, n_spp)
    tr0 = pf.trace_stage(cfg, sd, r0, ns, 1, 0, coherent=True)
    _, r1, _, _ = kernels.mega(cfg, 0, sv, usv, sd, n_spp, si0, st0, r0, None, tr0)
    views = {"B4 d=1 closest block": (r1[:, n_occ * ns:nb * ns], False),
             "B5 d=1 occlusion blocks": (r1[:, :n_occ * ns], True),
             "B4 primaries": (r0, False)}

    result = {"card": cs.card_line(), "pairs": pairs}
    for name, (view, any_hit) in views.items():
        fn = cl.intersect_any_clustered if any_hit else cl.intersect_closest_clustered
        a, b = fn(c, view, staged=True), fn(c, view, staged=False)
        same = torch.equal(a, b) if any_hit else all(
            torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)) for k in a)
        if not same:
            raise AssertionError(f"{name}: staged and global kernels differ")
        fns = {"staged": lambda: fn(c, view, staged=True),
               "global": lambda: fn(c, view, staged=False),
               "global again": lambda: fn(c, view, staged=False)}
        graph = {k: [] for k in fns}
        events = {k: [] for k in fns}
        for p in range(pairs):
            # staged vs global, then global vs itself, each pair's order
            # alternating
            for duo in (("staged", "global"), ("global again", "global")):
                for k in (duo if p % 2 == 0 else duo[::-1]):
                    graph[k].append(cs.graph_ms(fns[k]))
                    events[k].append(cs.cuda_ms(fns[k], 10))
        row = {"rays": view.shape[1], "live": int((view[6] > 0).sum())}
        for clock, ms in (("graph", graph), ("events", events)):
            row[clock] = {k: summary(v) for k, v in ms.items()}
            row[clock]["staged / global"] = summary(
                [s / g for s, g in zip(ms["staged"], ms["global"])])
            row[clock]["global again / global"] = summary(
                [s / g for s, g in zip(ms["global again"], ms["global"])])
            row[clock]["pairs staged won"] = sum(
                s < g for s, g in zip(ms["staged"], ms["global"]))
        result[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)

    # the wrapper's host cost: the input check alone, and the all-dead
    # floor (CUDA events around back-to-back wrapper calls) with each check
    dead = views["B4 d=1 closest block"][0].clone()
    dead[6] = -1.0
    checks = {"every table": lambda: check_every_table(c, dead),
              "rays only": lambda: cl._check(c, dead)}
    floors = {"every table": lambda: (check_every_table(c, dead),
                                      cl.intersect_closest_clustered(c, dead, staged=False)),
              "rays only": lambda: cl.intersect_closest_clustered(c, dead, staged=False)}
    host = {k: [] for k in checks}
    floor = {k: [] for k in checks}
    for p in range(pairs):
        for k in (list(checks) if p % 2 == 0 else list(checks)[::-1]):
            n = 2000
            h0 = time.perf_counter()
            for _ in range(n):
                checks[k]()
            host[k].append((time.perf_counter() - h0) / n * 1e3)
            floor[k].append(cs.cuda_ms(floors[k], 100))
    result["check host ms"] = {k: summary(v) for k, v in host.items()}
    result["all-dead floor events ms"] = {k: summary(v) for k, v in floor.items()}
    print(f"check host ms: {json.dumps(result['check host ms'])}")
    print(f"all-dead floor events ms: {json.dumps(result['all-dead floor events ms'])}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
