"""The dense closest-hit twin must match the reference Pallas kernel
(`intersect_closest_pallas_c`, run in TPU interpret mode on the CPU).

Float32 Moller-Trumbore loses about 1e-5 to cancellation at these scales
(on the soup both implementations sit up to ~2e-5 from a float64
evaluation), and interpret mode runs through XLA:CPU, which contracts
a*b+c into FMAs, while the twin (like the CUDA kernel, built with
-fmad=false) rounds every product. So the two round differently:
- hit masks are equal except on lanes whose hit lies within 5e-5 of a
  triangle edge in barycentrics (rays aimed at shared edges land there);
- prim is equal except there, or where two candidate t lie within 1e-6;
- t agrees to 5e-5 relative (1e-6 absolute near 0), u and v to 5e-5.
The CUDA kernel and this twin round alike; chip_smoke.py holds them
bit-equal on the card (t, u, v and prim).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fredholm_tpu.accel.pallas_dense import intersect_closest_pallas_c, prepare_tri_soa
from fredholm_tpu_torch import _build
from fredholm_tpu_torch.accel import dense
from test_torch_cache import release_compiled_programs  # noqa: F401 (autouse)

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

TIE = 1e-6
EDGE = 5e-5
T_RTOL, T_ATOL, UV_ATOL = 5e-5, 1e-6, 5e-5


def _reference(tri9: np.ndarray, rays: np.ndarray):
    tris = prepare_tri_soa(tri9[0:3].T, tri9[3:6].T, tri9[6:9].T)
    o = tuple(jnp.asarray(rays[k]) for k in range(3))
    d = tuple(jnp.asarray(rays[k]) for k in range(3, 6))
    with pltpu.force_tpu_interpret_mode():
        out = intersect_closest_pallas_c(tris, o, d, jnp.asarray(rays[6]))
        return {k: np.asarray(v) for k, v in out.items()}


def _port(tri9: np.ndarray, rays: np.ndarray):
    out = dense.intersect_closest(torch.as_tensor(tri9), torch.as_tensor(rays), rays.shape[1])
    return {k: v.numpy() for k, v in out.items()}


def _near_edge(out, tol=EDGE):
    u, v = out["u"], out["v"]
    return (out["prim"] >= 0) & (np.minimum(np.minimum(u, v), 1.0 - u - v) < tol)


def _check(ref, got, tri9, rays):
    edge = _near_edge(got) | _near_edge(ref)
    np.testing.assert_array_equal((got["prim"] >= 0)[~edge], ref["hit"][~edge])
    same = (got["prim"] == ref["prim"]) & ~edge
    diff = (got["prim"] != ref["prim"]) & ~edge
    if diff.any():  # otherwise only near-ties may pick another prim
        gap = np.abs(got["t"][diff] - ref["t"][diff])
        assert (gap <= TIE * np.maximum(np.abs(ref["t"][diff]), 1.0)).all(), gap.max()
    np.testing.assert_allclose(got["t"][same], ref["t"][same], rtol=T_RTOL, atol=T_ATOL,
                               err_msg="t")
    hit = same & (got["prim"] >= 0)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k][hit], ref[k][hit], rtol=0, atol=UV_ATOL, err_msg=k)
        # the contract on a miss (the interpret-mode reference can leave
        # an edge-grazing candidate's barycentrics there)
        assert (got[k][got["prim"] < 0] == 0.0).all()
    dead = rays[6] <= 0.0
    assert (got["prim"][dead] == -1).all()
    np.testing.assert_array_equal(got["t"][dead], rays[6][dead])
    return int(edge.sum())


def _soup(n_tris, n_rays, seed):
    rng = np.random.default_rng(seed)
    n_q = n_tris // 2  # quads split along a shared diagonal
    # one quad per cell of a 8x8x8 grid, jittered, so rays meet their target
    # (or a neighbour) at a bounded angle rather than grazing a far quad
    g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    c = (g[:n_q] - 3.5) + rng.uniform(-0.1, 0.1, (n_q, 3))
    ax = rng.normal(size=(n_q, 2, 3)) * 0.3
    p0, p1 = c, c + ax[:, 0]
    p2, p3 = c + ax[:, 0] + ax[:, 1], c + ax[:, 1]
    tris = np.concatenate([np.stack([p0, p1, p2], 1), np.stack([p0, p2, p3], 1)])
    tris = tris.astype(np.float32)
    tri9 = np.ascontiguousarray(np.concatenate(
        [tris[:, 0].T, (tris[:, 1] - tris[:, 0]).T, (tris[:, 2] - tris[:, 0]).T]
    ).astype(np.float32))
    k = rng.integers(0, n_tris, n_rays)
    target = np.einsum("nk,nkc->nc", rng.dirichlet([1, 1, 1], n_rays), tris[k])
    edge = rng.uniform(size=n_rays) < 0.2
    q = k[edge] % n_q
    target[edge] = 0.5 * (p0[q] + p2[q])  # shared-diagonal midpoints
    # rays arrive within ~72 degrees of the target's normal, from either
    # side, so Moller-Trumbore stays well-conditioned
    nrm = np.cross(tris[k, 1] - tris[k, 0], tris[k, 2] - tris[k, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    side = rng.normal(size=(n_rays, 3))
    side -= np.sum(side * nrm, axis=1, keepdims=True) * nrm
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    cos = rng.uniform(0.3, 1.0, (n_rays, 1)) * rng.choice([-1.0, 1.0], (n_rays, 1))
    back = cos * nrm + np.sqrt(1.0 - cos * cos) * side
    o = target + rng.uniform(0.3, 2.0, (n_rays, 1)) * back
    d = -back
    tmax = np.full(n_rays, 1e9)
    tmax[rng.uniform(size=n_rays) < 0.1] = -1.0  # dead lanes
    tmax[rng.uniform(size=n_rays) < 0.02] = 0.0
    tmax[rng.uniform(size=n_rays) < 0.1] = 3.0  # short rays
    rays = np.ascontiguousarray(np.concatenate([o.T, d.T, tmax[None]]).astype(np.float32))
    return tri9, rays


def test_random_soup_1024():
    tri9, rays = _soup(1024, 1024, 3)
    ref = _reference(tri9, rays)
    assert 0.6 < ref["hit"].mean() < 0.95
    n_edge = _check(ref, _port(tri9, rays), tri9, rays)
    assert n_edge < 0.25 * rays.shape[1]


def test_cornell_rays_from_a_real_bounce():
    """All four ray blocks of a real first bounce (sky, area, light, rad)."""
    from fredholm_tpu_torch import Camera, cornell_box
    from fredholm_tpu_torch.fused import pt_fused as pf
    from fredholm_tpu_torch.scene.device import build_device_scene

    dev = build_device_scene(cornell_box(), "cpu")
    cfg = pf.FusedConfig(32, 32, 4, dev["n_lights"], ("diffuse_r",))
    cam = Camera(origin=np.asarray([0.0, 1.0, 0.6], np.float32))
    sv, usv = pf.pack_scalars({"camera": cam.device_params("cpu"), "seed": 42,
                               "bg_color": np.zeros(3)}, 1024, "cpu")
    n_spp = torch.full((1024,), 5, dtype=torch.int64)
    state, sidx, rays0 = pf.raygen_twin(cfg, sv, usv, n_spp)
    hits0 = dense.intersect_closest_twin(dev["tri_soa"], rays0, 1024)
    _, rays, _, _ = pf.mega_twin(cfg, 0, sv, usv, dev, n_spp, sidx, state, rays0, None,
                                  pf.Traced(hits0))
    tri9, rays_np = dev["tri_soa"].numpy(), rays.numpy()
    assert (rays_np[6] <= 0).any() and (rays_np[6] > 0).any()
    for r in (rays0.numpy(), rays_np):
        _check(_reference(tri9, r), _port(tri9, r), tri9, r)


def test_equal_t_lowest_prim_wins():
    """Two coplanar copies of one triangle: the lower index wins."""
    v = np.asarray([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    tris = np.stack([v, v + [0, 0, -1], v, v])
    tri9 = np.ascontiguousarray(np.concatenate(
        [tris[:, 0].T, (tris[:, 1] - tris[:, 0]).T, (tris[:, 2] - tris[:, 0]).T]
    ).astype(np.float32))
    rays = np.zeros((7, 3), np.float32)
    rays[2] = 2.0
    rays[5] = -1.0
    rays[6] = [1e9, 1.5, -1.0]
    got = _port(tri9, rays)
    np.testing.assert_array_equal(got["prim"], [0, -1, -1])
    np.testing.assert_array_equal(got["t"], [2.0, 1.5, -1.0])
    _check(_reference(tri9, rays), got, tri9, rays)


def test_wrapper_counts_twin_and_checks_inputs():
    tri9, rays = _soup(8, 64, 4)
    before = _build.LAUNCHES["dense_closest_twin"]
    dense.intersect_closest(torch.as_tensor(tri9), torch.as_tensor(rays), 64)
    assert _build.LAUNCHES["dense_closest_twin"] == before + 1
    assert _build.LAUNCHES["dense_closest"] == 0  # no kernel on the CPU
    with pytest.raises(ValueError):
        dense.intersect_closest(torch.as_tensor(tri9[:8]), torch.as_tensor(rays), 64)
    with pytest.raises(ValueError):
        dense.intersect_closest(torch.as_tensor(tri9), torch.as_tensor(rays), 65)


def _edge_tris():
    """Four triangles, each of whose tests is exact in float32: the unit
    right triangle in z = 0 (det 1), and thin ones whose det is exactly
    f32(1e-12), -f32(1e-12) and the next float above f32(1e-12)."""
    a = np.float32(1e-12)
    above = np.nextafter(a, np.float32(np.inf))
    v0 = [(0.0, 0.0, 0.0), (0.0, 10.0, 0.0), (0.0, 20.0, 0.0), (0.0, 30.0, 0.0)]
    e1 = [(1.0, 0.0, 0.0), (a, 0.0, 0.0), (-a, 0.0, 0.0), (above, 0.0, 0.0)]
    e2 = [(0.0, 1.0, 0.0)] * 4
    return np.ascontiguousarray(
        np.concatenate([np.asarray(x, np.float32).T for x in (v0, e1, e2)]))


def _edge_rays(case):
    """Eight rays straight down (-z) from z = 1 for one contract edge case:
    (origin x, y) and tmax per lane."""
    a = np.float32(1e-12)
    q = np.float32(a / 4)
    if case == "all dead":
        xy = [(0.25, 0.25)] * 8
        tmax = [-1.0, 0.0, -0.0, -1e9, -1.0, 0.0, -2.0, -1.0]
    elif case == "one live":
        xy = [(0.25, 0.25)] * 8
        tmax = [-1.0] * 3 + [1e9] + [-1.0] * 4
    elif case == "det 1e-12":
        # u = v = 0.25 and t = 1 on each thin triangle; only the one whose
        # |det| exceeds 1e-12 is hit
        xy = [(q, 10.25), (-q, 20.25), (np.nextafter(a, np.float32(1)) / 4, 30.25),
              (q, 10.25), (-q, 20.25), (0.25, 0.25), (0.5, 0.5), (q, 30.25)]
        tmax = [1e9] * 8
    elif case == "u + v = 1":
        # on the hypotenuse, past it by one ulp of u + v, on the u = 0 and
        # v = 0 edges and at the vertices
        xy = [(0.5, 0.5), (0.5, 0.5 + 2.0 ** -23), (0.0, 0.5),
              (0.5, 0.0), (0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (0.75, 0.25)]
        tmax = [1e9] * 8
    else:  # "t = tmax": the hit is at t = 1 exactly
        xy = [(0.25, 0.25)] * 8
        one = np.float32(1.0)
        tmax = [1.0, np.nextafter(one, np.float32(2)), np.nextafter(one, np.float32(0)), 2.0,
                1.0, 0.5, 1e9, 1.0]
    rays = np.zeros((7, 8), np.float32)
    rays[0:2] = np.asarray(xy, np.float32).T
    rays[2] = 1.0
    rays[5] = -1.0
    rays[6] = np.asarray(tmax, np.float32)
    return rays


@pytest.mark.parametrize("case", ["all dead", "one live", "det 1e-12", "u + v = 1", "t = tmax"])
def test_contract_edge_cases(case):
    """The contract's edges, where every operation is exact in float32 and
    the twin and the interpret-mode reference must agree bit for bit."""
    tri9, rays = _edge_tris(), _edge_rays(case)
    ref, got = _reference(tri9, rays), _port(tri9, rays)
    hit = got["prim"] >= 0
    np.testing.assert_array_equal(hit, ref["hit"])
    np.testing.assert_array_equal(got["prim"], np.where(hit, ref["prim"], -1))
    for k in ("t", "u", "v"):
        np.testing.assert_array_equal(got[k][hit], ref[k][hit], err_msg=k)
    np.testing.assert_array_equal(got["t"][~hit], rays[6][~hit])
    assert (got["u"][~hit] == 0).all() and (got["v"][~hit] == 0).all()
    want_hits = {"all dead": 0, "one live": 1, "det 1e-12": 4, "u + v = 1": 7, "t = tmax": 3}
    assert int(hit.sum()) == want_hits[case], got["prim"]
    if case == "det 1e-12":
        np.testing.assert_array_equal(got["prim"], [-1, -1, 3, -1, -1, 0, 0, 3])
    if case == "t = tmax":
        np.testing.assert_array_equal(hit, [False, True, False, True, False, False, True, False])
