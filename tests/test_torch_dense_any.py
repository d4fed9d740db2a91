"""The dense any-hit twin (B3's oracle) must match the reference Pallas
kernel (`intersect_any_pallas_c`, run in TPU interpret mode on the CPU).

Interpret mode runs through XLA:CPU, which contracts a*b+c into FMAs,
while the twin (like the CUDA kernel, built with -fmad=false) rounds every
product, so a lane can flip where some triangle's hit lies within 5e-5 of
its edge in barycentrics (the soup aims 20% of its rays at shared quad
diagonals) or within 1e-5 (relative) of the lane's tmax. Those lanes are
excused, and counted; every other lane, dead lanes included, must agree.
The CUDA kernel and this twin round alike; chip_smoke.py [10] holds them
to bit-equal masks on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fredholm_tpu.accel.pallas_dense import intersect_any_pallas_c, prepare_tri_soa
from fredholm_tpu_torch import _build
from fredholm_tpu_torch.accel import dense
from fredholm_tpu_torch.tools import any_lanes
from test_torch_dense import _soup
from test_torch_cache import release_compiled_programs  # noqa: F401 (autouse)

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

EDGE = 5e-5
T_END = 1e-5


def _reference(tri9: np.ndarray, rays: np.ndarray) -> np.ndarray:
    tris = prepare_tri_soa(tri9[0:3].T, tri9[3:6].T, tri9[6:9].T)
    o = tuple(jnp.asarray(rays[k]) for k in range(3))
    d = tuple(jnp.asarray(rays[k]) for k in range(3, 6))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(intersect_any_pallas_c(tris, o, d, jnp.asarray(rays[6])))


def _all_pairs(tri9: np.ndarray, rays: np.ndarray):
    """(t, u, v, valid) [M, F] of every ray against every triangle."""
    r = torch.as_tensor(rays)
    out = dense.moller_trumbore(torch.as_tensor(tri9), tuple(r[0:3]), tuple(r[3:6]))
    return [x.numpy() for x in out]


def _check(tri9: np.ndarray, rays: np.ndarray) -> int:
    """Twin vs reference on every lane but the excused ones; returns how
    many were excused."""
    got = dense.intersect_any(torch.as_tensor(tri9), torch.as_tensor(rays), rays.shape[1])
    want = _reference(tri9, rays)
    t, u, v, _ = _all_pairs(tri9, rays)
    tmax = rays[6][:, None]
    near = ((np.abs(np.minimum(np.minimum(u, v), 1.0 - u - v)) < EDGE)
            & (t > 0.0) & (t < tmax * (1.0 + T_END)))
    near |= (np.abs(t - tmax) <= T_END * np.maximum(np.abs(tmax), 1.0)) & (tmax > 0.0)
    excused = near.any(axis=1)
    np.testing.assert_array_equal(got.numpy()[~excused], want[~excused])
    dead = rays[6] <= 0.0
    assert dead.any() and not got.numpy()[dead].any()
    return int(excused.sum())


def test_random_soup_256():
    tri9, rays = _soup(256, 4096, 11)
    # a fifth of the rays aim at shared diagonals, so about that many graze
    assert _check(tri9, rays) < 0.25 * rays.shape[1]


def test_cornell_nee_rays_from_a_real_bounce(monkeypatch):
    """The concatenated sun, sky and area shadow rays of a real first
    bounce of the wavefront integrator on the Cornell box."""
    from fredholm_tpu_torch import Renderer, cornell_box
    from fredholm_tpu_torch.integrator import pt

    seen = []

    def spy(dev, o, d, t_max):
        seen.append(pt._ray_buffer(o, d, t_max))
        return trace_any(dev, o, d, t_max)

    trace_any = pt.trace_any
    monkeypatch.setattr(pt, "trace_any", spy)
    r = Renderer(32, 32, device="cpu")
    r.set_scene(cornell_box())
    r.camera.origin = np.asarray([0.0, 1.0, 0.6], np.float32)
    r.camera._update_transform()
    r.set_directional_light((2.0, 1.9, 1.8), (0.35, 0.75, 0.3), angle=0.5)
    r.use_fused = False
    r.render(n_samples=1, max_depth=1)
    rays = seen[0].numpy()
    assert rays.shape == (7, 3 * 1024)
    assert (rays[6] <= 0).any() and (rays[6] > 0).any()
    tri9 = r._dev["tri_soa"].numpy()
    assert _check(tri9, rays) < 0.01 * rays.shape[1]


def test_stats_count_tests_to_the_first_occluder():
    """The twin's stats count what the kernel's loop does: a live lane
    tests triangles in order up to its first occluder, or all of them."""
    tri9, rays = _soup(96, 512, 12)
    t, _, _, valid = _all_pairs(tri9, rays)
    hit = valid & (t < rays[6][:, None])
    f = tri9.shape[1]
    per_lane = np.where(hit.any(axis=1), np.argmax(hit, axis=1) + 1, f)
    want = int(per_lane[rays[6] > 0].sum())
    stats = {"tri": 0}
    dense.intersect_any_twin(torch.as_tensor(tri9), torch.as_tensor(rays), 512, stats)
    assert 0 < stats["tri"] == want < f * int((rays[6] > 0).sum())
    np.testing.assert_array_equal(stats["lanes"].numpy(), np.where(rays[6] > 0, per_lane, 0))


def test_largest_first_keeps_the_mask_and_counts_its_own_order():
    """The sweep in any_lanes.by_area's order (largest triangle first)
    gives the index order's mask and the reference's, and the twin's stats
    count the tests a lane takes in that order."""
    tri9, rays = _soup(96, 512, 12)
    by_area = any_lanes.by_area(torch.as_tensor(tri9))
    # the columns, moved: each kernel-order column is some index's
    where = {tuple(c): k for k, c in enumerate(tri9.T)}
    order = np.asarray([where[tuple(c)] for c in by_area.numpy().T])
    assert sorted(order) == list(range(tri9.shape[1]))
    area = np.linalg.norm(np.cross(tri9[3:6].T.astype(np.float64), tri9[6:9].T), axis=1)
    assert (np.diff(area[order]) <= 1e-6 * area.max()).all()
    stats = {"tri": 0}
    got = dense.intersect_any_twin(by_area, torch.as_tensor(rays), 512, stats)
    np.testing.assert_array_equal(
        got.numpy(), dense.intersect_any_twin(torch.as_tensor(tri9), torch.as_tensor(rays), 512))
    t, _, _, valid = _all_pairs(tri9, rays)
    hit = (valid & (t < rays[6][:, None]))[:, order]
    per_lane = np.where(hit.any(axis=1), np.argmax(hit, axis=1) + 1, tri9.shape[1])
    np.testing.assert_array_equal(stats["lanes"].numpy(), np.where(rays[6] > 0, per_lane, 0))
    # the reference on the moved triangles, lanes near an edge excused as above
    assert _check(by_area.numpy(), rays) < 0.25 * rays.shape[1]


def _replay_slots(tests, block, first, pack_above, packed):
    """k_dense_any's schedule one block and one warp at a time."""
    t = [int(x) for x in tests]
    if not packed:
        tops = [max(t[i:i + 32]) for i in range(0, len(t), 32)]
        return 32 * sum(tops), sum(1 for x in tops if x > 0)
    slots = warps = 0
    for b in range(0, len(t), block):
        lanes = [i for i in range(b, min(b + block, len(t))) if t[i] > 0]
        runs = [(lanes, lambda x: x)]
        if first is not None and len(lanes) > pack_above:
            runs = [(lanes, lambda x: min(x, first)),
                    ([i for i in lanes if t[i] > first], lambda x: x - first)]
        for group, run in runs:
            for w in range(0, len(group), 32):
                slots += 32 * max(run(t[i]) for i in group[w:w + 32])
                warps += 1
    return slots, warps


def test_warp_slots_match_a_replay_of_each_schedule():
    rng = np.random.default_rng(13)
    for _ in range(6):
        m = int(rng.integers(1, 2000))
        tests = rng.integers(1, 37, m) * (rng.random(m) < rng.random())
        for packed, first, pack_above in ((False, None, 0), (True, None, 0), (True, 3, 0),
                                          (True, any_lanes.FIRST, any_lanes.PACK_ABOVE)):
            assert any_lanes.warp_slots(torch.as_tensor(tests), 256, first, pack_above,
                                        packed) == _replay_slots(tests, 256, first,
                                                                 pack_above, packed)


def test_wrapper_counts_twin_and_checks_inputs():
    tri9, rays = _soup(8, 64, 4)
    before = _build.LAUNCHES["dense_any_twin"]
    out = dense.intersect_any(torch.as_tensor(tri9), torch.as_tensor(rays), 64)
    assert out.dtype == torch.bool and out.shape == (64,)
    assert _build.LAUNCHES["dense_any_twin"] == before + 1
    assert _build.LAUNCHES["dense_any"] == 0  # no kernel on the CPU
    with pytest.raises(ValueError):
        dense.intersect_any(torch.as_tensor(tri9[:8]), torch.as_tensor(rays), 64)
    with pytest.raises(ValueError):
        dense.intersect_any(torch.as_tensor(tri9), torch.as_tensor(rays), 65)
