"""Progressive accumulation (port of fredholm_tpu/integrator/pt.py:984-1043).

The streaming average keeps the reference's exact form
`coef * (nf * old + new)` keyed by the per-pixel sample count
(pt.cu:480-501), so `render(n); render(m)` equals `render(n + m)`.
"""

from __future__ import annotations

from typing import Dict

import torch


def render_progressive(dev: Dict, params: Dict, layers: Dict, sample_count,
                       n_samples: int):
    """Accumulate n_samples progressive samples into the render layers.

    layers: make_layers() dict; sample_count: [N] int64 (uint32 values).
    Returns (new_layers, new_sample_count)."""
    from ..fused.pt_fused import render_sample_fused

    for _ in range(n_samples):
        out = render_sample_fused(dev, params, sample_count)
        nf = sample_count.to(torch.float32)
        coef = 1.0 / (nf + 1.0)

        def avg(old, new, vec):
            c = coef[:, None] if vec else coef
            nn = nf[:, None] if vec else nf
            return c * (nn * old + new)

        layers = {
            "beauty": avg(layers["beauty"], out["radiance"], True),
            "position": avg(layers["position"], out["position"], True),
            "normal": avg(layers["normal"], out["normal"], True),
            "depth": avg(layers["depth"], out["depth"], False),
            "texcoord": avg(layers["texcoord"], out["texcoord"], True),
            "albedo": avg(layers["albedo"], out["albedo"], True),
            # float32 like the reference (pt.py:1021): parity over speed
            "n_path_vertices": layers["n_path_vertices"]
            + out["n_path_vertices"],
            "n_lane_slots": layers["n_lane_slots"] + out["n_lane_slots"],
        }
        sample_count = sample_count + 1
    return layers, sample_count


def make_layers(n: int, device) -> Dict:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "beauty": z(n, 3),
        "position": z(n, 3),
        "normal": z(n, 3),
        "depth": z(n),
        "texcoord": z(n, 2),
        "albedo": z(n, 3),
        # lifetime count of shaded path vertices (for perf accounting)
        "n_path_vertices": z(),
        # lifetime count of executed lane-bounce slots
        "n_lane_slots": z(),
    }
