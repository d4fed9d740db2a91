#!/usr/bin/env python3
"""Read metric 1 of the PyTorch/CUDA port several times in one process.

Run from the repository root:  python3 chip_metric1.py [--root DIR] [--reps N]

Metric 1 as chip_smoke.py phase 5 reads it (bench.py metric 1: the Cornell
box at 512x512, 16 x render(1), depth 5, after 2 warm-up spp, through
Renderer(device="cuda")), N times in one process, with the
fredholm_tpu_torch package found under --root (default: this file's
directory). To compare two trees of the port on one card, unpack both and
run this script once per tree in turns (parent, change, change, parent).
Prints one JSON line with the readings in Mpath-vertices/s and the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="tree whose fredholm_tpu_torch is read")
    ap.add_argument("--reps", type=int, default=3, help="readings in this process")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, HERE)
    from chip_smoke import card_line, timed_metric

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import fredholm_tpu_torch as ft
    from fredholm_tpu_torch import _build

    if not os.path.abspath(ft.__file__).startswith(root + os.sep):
        raise RuntimeError(f"fredholm_tpu_torch came from {ft.__file__}, not from {root}")
    r = ft.Renderer(512, 512, device="cuda")
    r.set_scene(ft.cornell_box())
    r.camera.origin = np.asarray([0.0, 1.0, 0.6], np.float32)
    r.camera._update_transform()
    readings = []
    for _ in range(args.reps):
        pv, seconds, _ = timed_metric(r, 16, 5, _build)
        readings.append(pv / seconds / 1e6)
    print(json.dumps({"metric": "cornell_512x512_16spp_depth5", "root": args.root,
                      "mpath_vertices_per_s": readings, "card": card_line()}))


if __name__ == "__main__":
    main()
