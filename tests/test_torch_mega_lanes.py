"""The lane counts of mega's split variants (fredholm_tpu_torch/tools/
mega_lanes.py) on the CPU, on the scene of test_torch_lobes.py: the
Cornell box whose white faces and a sphere inside turn every lobe on,
and on test_torch_textures.py's, where every material also has one
texture kind.

- `shading_lanes`, the lanes the full and textured variants queue for
  their shading pass (csrc/shade.cu `shades`), are the lanes whose
  path-vertex count the twin steps, at every bounce of both pipelines;
  both pipelines take a variant that reads the lane queue;
- `eval_lobes` gates each lobe as cbsdf._lobe_evals does: where a bit is
  off the twin's lobe value and pdf are zero; an all-lobe face seen from
  outside evaluates all seven lobes, from inside the two that do not need
  `entering`;
- `warp_lobe_stats` counts warps, distinct sets and unions by hand;
- `kernels.lane_queue`, the split variants' scratch, is zeroed once and
  kept.
"""

import numpy as np
import pytest
import torch

from fredholm_tpu_torch import Camera
from fredholm_tpu_torch.accel.dense import intersect_closest
from fredholm_tpu_torch.fused import cbsdf, kernels
from fredholm_tpu_torch.fused import pt_fused as tpf
from fredholm_tpu_torch.fused.cvec import V3
from fredholm_tpu_torch.scene.device import build_device_scene
from fredholm_tpu_torch.tools import mega_lanes

import test_torch_textures as textures
from test_torch_lobes import W, H, _cfgs, _lobe_scene
from test_torch_cache import release_compiled_programs  # noqa: F401 (autouse)

# one intra-op thread: the suite runs its files in parallel processes
torch.set_num_threads(1)

ALL_BITS = (1 << len(cbsdf.ALL_LOBES)) - 1
# transmission and diffuse_t: the lobes whose guards do not read `entering`
INSIDE_BITS = (1 << cbsdf.ALL_LOBES.index("transmission")) | \
    (1 << cbsdf.ALL_LOBES.index("diffuse_t"))


def _stages(scene, cfg):
    """Each mega stage's inputs and the twin's outputs over one sample of
    the port's CPU pipeline on `scene`: (cfg, dev, [(d, state, Traced,
    out)])."""
    dev = build_device_scene(scene, "cpu")
    cam = Camera(origin=np.asarray([0.0, 0.9, 1.2], np.float32))
    params = {"camera": cam.device_params("cpu"), "seed": 5,
              "bg_color": np.asarray([0.3, 0.4, 0.5], np.float32),
              "directional_light": {"le": np.asarray([2.0, 1.9, 1.8], np.float32),
                                    "dir": np.asarray([0.3, 0.9, 0.3], np.float32),
                                    "angle": np.float32(1.0)}}
    n = cfg.width * cfg.height
    sv, usv = tpf.pack_scalars(params, n, "cpu")
    n_spp = torch.as_tensor(np.random.default_rng(23).integers(0, 40, n).astype(np.int64))
    state, sidx, rays = kernels.raygen(cfg, sv, usv, n_spp)
    pending, out = None, []
    for d in range(cfg.max_depth):
        tr = tpf.Traced(intersect_closest(dev["tri_soa"], rays, rays.shape[1]))
        res = kernels.mega(cfg, d, sv, usv, dev, n_spp, sidx, state, rays, pending, tr)
        out.append((d, state, tr, res))
        state, rays, pending, _ = res
    return cfg, dev, out


@pytest.fixture(scope="module")
def stages():
    """The pipeline with every lobe on (the full variant)."""
    return _stages(_lobe_scene(), _cfgs(cbsdf.ALL_LOBES)[0])


@pytest.fixture(scope="module")
def tex_stages():
    """The pipeline with every lobe and every texture kind on (the
    textured variant), W x H lanes of test_torch_textures.py."""
    return _stages(textures._kind_scene(), textures._cfgs()[0])


@pytest.mark.parametrize("pipeline", ["stages", "tex_stages"])
def test_shading_lanes_are_the_lanes_the_twin_counts(pipeline, request):
    cfg, _, out = request.getfixturevalue(pipeline)
    assert kernels.mega_variant(cfg) == {"stages": "full", "tex_stages": "tex"}[pipeline]
    n = cfg.width * cfg.height
    for d, state, tr, res in out:
        shading = mega_lanes.shading_lanes(cfg, state, tr, n, d)
        stepped = res[0][tpf.ST_NV] - state[tpf.ST_NV] == 1.0
        assert torch.equal(shading, stepped), d
        assert 0 < int(shading.sum()) < n, d


def test_eval_lobes_gate_like_the_twins_lobe_evals(stages):
    cfg, dev, out = stages
    n = W * H
    _, state, tr, _ = out[1]
    shading = mega_lanes.shading_lanes(cfg, state, tr, n, 1)
    bits = mega_lanes.eval_lobes(cfg, dev, state, tr, n, 1)
    sets = set(bits[shading].tolist())
    assert {ALL_BITS, INSIDE_BITS} <= sets, sets
    # the twin's lobe values and pdfs at random directions, on the same
    # setup: zero wherever the lane's bit is off, not everywhere it is on
    _, rattr = tr.closest(cfg.blocks.index("rad"), n, dev, cfg)
    fv0, fv1, fv2 = (tpf._attr3(rattr, k) for k in ("v0", "v1", "v2"))
    from fredholm_tpu_torch.fused.cvec import cross, dot, normalize

    n_g = normalize(cross(fv1 - fv0, fv2 - fv0), eps=1e-20)
    entering = dot(-V3(*(state[tpf.ST_D + c] for c in range(3))), n_g) > 0.0
    rng = np.random.default_rng(3)

    def hemi():
        v = rng.normal(size=(3, n)).astype(np.float32)
        v[1] = np.abs(v[1]) + 0.1
        v /= np.linalg.norm(v, axis=0)
        return V3(*(torch.as_tensor(c) for c in v))

    wo, wi = hemi(), hemi()
    ctx = cbsdf.setup(wo, tpf._shading_params_from_attr(rattr), entering, cfg.lobes_on)
    fs, ps = cbsdf._lobe_evals(ctx, wo, wi)
    for k in range(len(cbsdf.ALL_LOBES)):
        on = ((bits >> k) & 1) != 0
        nonzero = (fs[k].x != 0) | (fs[k].y != 0) | (fs[k].z != 0) | (ps[k] != 0)
        assert not bool((nonzero & ~on).any()), cbsdf.ALL_LOBES[k]
        assert bool((nonzero & on).any()), cbsdf.ALL_LOBES[k]


def test_warp_lobe_stats_by_hand():
    bits = torch.zeros(72, dtype=torch.int64)
    shading = torch.zeros(72, dtype=torch.bool)
    # warp 0: three shading lanes, two sets, seven lobes in their union;
    # warp 1: none; warp 2 (8 lanes, padded): one lane of one lobe
    bits[[1, 5, 9, 20]] = torch.tensor([ALL_BITS, INSIDE_BITS, ALL_BITS, 64])
    shading[[1, 5, 9]] = True
    bits[70], shading[70] = 64, True
    s = mega_lanes.warp_lobe_stats(bits, shading)
    assert s["warps"] == 3 and s["warps_shading"] == 2 and s["shading_lanes"] == 4
    assert s["distinct_sets_max"] == 2 and s["distinct_sets_mean"] == 1.5
    assert s["union_lobes_max"] == 7 and s["union_lobes_mean"] == 4.0
    assert s["lanes_per_warp_mean"] == 2.0
    assert s["sets"] == {ALL_BITS: 2, INSIDE_BITS: 1, 64: 1}


def test_lane_queue_is_zeroed_once_and_kept():
    # the full variant's scratch: made zeroed, the same buffer for as many
    # lanes or fewer (its kernels leave its counters at 0), made anew and
    # zeroed for more
    kernels._LANE_QUEUES.clear()
    q = kernels.lane_queue(100, "cpu")
    assert q.dtype == torch.int32 and q.shape == (102,) and not bool(q.any())
    q[:2] = 0
    q[2:] = 7
    assert kernels.lane_queue(100, "cpu") is q and kernels.lane_queue(40, "cpu") is q
    assert bool((q[2:] == 7).all())
    big = kernels.lane_queue(300, "cpu")
    assert big is not q and big.shape == (302,) and not bool(big.any())
    assert kernels.lane_queue(100, torch.device("cpu")) is big
    kernels._LANE_QUEUES.clear()
