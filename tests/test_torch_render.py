"""The port as a whole: its host scene and tables are byte-equal to the
reference's, and `fredholm_tpu_torch.Renderer` on the CPU renders like
`fredholm_tpu.Renderer` (all six layers at rtol = atol = 2e-4, the bar of
tests/test_fused_integrator.py:55-58; n_path_vertices exactly) on the
Cornell box (dense, area lights) and on the metal_row golden's three
spheres (clustered, lobes metal + specular + diffuse_r, constant sky; the
reference on its plain path, use_pallas=False). The Cornell setup mirrors
test_fused_integrator's so XLA:CPU's persistent compile cache serves both
files."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fredholm_tpu.renderer import Renderer as JRenderer
from fredholm_tpu.scene.device import build_device_scene as j_build
from fredholm_tpu.scene.procedural import cornell_box as j_cornell
from fredholm_tpu.scene.procedural import sphere_array_test as j_spheres
from fredholm_tpu_torch import Renderer, cornell_box
from fredholm_tpu_torch.scene import device as tdev
from fredholm_tpu_torch.scene.procedural import sphere_array_test

from test_torch_cache import cached_all

# one intra-op thread: the suite runs its files in parallel processes, and
# torch's default of a thread per core makes them fight for the cores
torch.set_num_threads(1)

LAYERS = ("beauty", "position", "normal", "depth", "texcoord", "albedo")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(cls, **kw):
    if cls is Renderer:
        kw.setdefault("device", "cpu")
    r = cls(width=32, height=32, **kw)
    r.set_scene(cornell_box() if cls is Renderer else j_cornell())
    r.camera.origin = np.asarray([0.0, 1.0, 0.6], np.float32)
    r.camera._update_transform()
    return r


@pytest.fixture(scope="module")
def reference_tables():
    dev = j_build(j_cornell())
    return {
        "fused_table": np.asarray(dev["fused_table"]),
        "fused_mat_table": np.asarray(dev["fused_mat_table"]),
        "light_table": np.asarray(dev["light_table"]),
        "tri_soa": {k: np.asarray(v) for k, v in dev["tri_soa"].items()},
        "n_lights": dev["n_lights"],
        "n_faces": dev["n_faces"],
        # the wavefront integrator's face, material and light tables
        **{k: np.asarray(dev[k]) for k in tdev._WAVEFRONT_KEYS if k != "materials"},
        "materials": {k: np.asarray(v) for k, v in dev["materials"].items()},
    }


def test_cornell_host_scene_is_byte_equal():
    a, b = cornell_box(), j_cornell()
    for k in ("vertices", "normals", "texcoords", "indices", "material_ids",
              "instance_ids", "transforms"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
    assert [vars(m) for m in a.materials] == [vars(m) for m in b.materials]


@pytest.mark.parametrize("key", ["fused_table", "fused_mat_table", "light_table"])
def test_upload_tables_byte_equal(reference_tables, key):
    port = tdev.build_device_scene(cornell_box(), "cpu")
    got, want = port[key].numpy(), reference_tables[key]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_upload_tri_soa_byte_equal(reference_tables):
    port = tdev.build_device_scene(cornell_box(), "cpu")
    assert port["n_lights"] == reference_tables["n_lights"] == 2
    assert port["n_faces"] == reference_tables["n_faces"] == 36
    for row, key in enumerate(tdev._TRI_KEYS):
        want = reference_tables["tri_soa"][key][0]
        assert port["tri_soa"][row].numpy().tobytes() == want.tobytes(), key


def test_dev_from_reference_round_trip(reference_tables):
    port = tdev.build_device_scene(cornell_box(), "cpu")
    carried = tdev.dev_from_reference(reference_tables, "cpu")
    assert set(carried) == set(port)
    for k, v in port.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(carried[k], v), k
        elif isinstance(v, dict):
            assert set(carried[k]) == set(v), k
            for name, x in v.items():
                assert torch.equal(carried[k][name], x), (k, name)
        else:
            assert carried[k] == v, k


def _reference_layers(tmp_path_factory, name, setup, **kw):
    """The reference's layers of setup() rendered with kw, once a session."""
    return _both_layers(tmp_path_factory, name, None, setup, **kw)[1]


def _both_layers(tmp_path_factory, name, port_setup, setup, **kw):
    """(port layers as tensors, the reference's as arrays) of the two
    setups rendered with kw, each once a session (port_setup None: the
    reference's alone)."""
    def render(r):
        r.render(**kw)
        return {k: np.asarray(v) for k, v in r.layers.items()}

    entries = [(name, sorted(kw.items()), lambda: render(setup()))]
    if port_setup is not None:
        entries.append((name + "_port", sorted(kw.items()), lambda: render(port_setup())))
    out = cached_all(tmp_path_factory, entries)
    port = {k: torch.as_tensor(v) for k, v in out[1].items()} if port_setup else None
    return port, out[0]


@pytest.fixture(scope="module")
def both_renders(tmp_path_factory):
    def setup():
        j = _setup(JRenderer)
        assert j._config(1, 4).use_fused and j._config(1, 4).lobes_on == ("diffuse_r",)
        return j

    return _both_layers(tmp_path_factory, "cornell_layers",
                        lambda: _setup(Renderer, device="cpu"), setup, n_samples=2,
                        max_depth=4)


@pytest.mark.parametrize("key", LAYERS)
def test_slice_matches_reference(both_renders, key):
    got, want = both_renders
    np.testing.assert_allclose(got[key].numpy(), want[key], rtol=2e-4, atol=2e-4, err_msg=key)


def test_slice_path_vertices_match(both_renders):
    got, want = both_renders
    np.testing.assert_allclose(float(got["n_path_vertices"]),
                               float(want["n_path_vertices"]), rtol=1e-6)
    assert float(got["n_lane_slots"]) == float(want["n_lane_slots"]) == 32 * 32 * 4 * 2


def _camera_transform() -> np.ndarray:
    """A camera-to-world 4x4 (right, up, backward, origin columns) inside
    the box, turned left and down: another camera than the default's."""
    origin = np.asarray([0.25, 1.15, 0.5], np.float32)
    f = np.asarray([-0.35, -0.25, -1.0], np.float32)
    f /= np.linalg.norm(f)
    r = np.cross(f, [0.0, 1.0, 0.0])
    r /= np.linalg.norm(r)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = r, np.cross(r, f), -f, origin
    return m


def _camera_scene(cls):
    # _setup's size, rendered below at its spp and depth: the camera is no
    # part of the reference's compiled program, so the program it built for
    # cornell_layers renders this scene too
    r = cls(width=32, height=32, **({"device": "cpu"} if cls is Renderer else {}))
    scene = cornell_box() if cls is Renderer else j_cornell()
    scene.has_camera_transform = True
    scene.camera_transform = _camera_transform()
    r.set_scene(scene)
    return r


def test_scene_camera_transform_matches_reference(tmp_path_factory):
    """set_scene takes a scene's camera transform, as the reference does
    (renderer.py:314-318): both render it from that camera."""
    want = _reference_layers(tmp_path_factory, "cornell_camera_layers",
                             lambda: _camera_scene(JRenderer), n_samples=2, max_depth=4)
    t = _camera_scene(Renderer)
    np.testing.assert_array_equal(t.camera.transform, _camera_transform())
    np.testing.assert_array_equal(t.camera.origin, _camera_transform()[:3, 3])
    t.render(n_samples=2, max_depth=4)
    for key in LAYERS:
        np.testing.assert_allclose(t.layers[key].numpy(), want[key], rtol=2e-4, atol=2e-4,
                                   err_msg=key)
    assert float(t.layers["n_path_vertices"]) == float(want["n_path_vertices"]) > 0


def test_progressive_accumulation_is_exact():
    r = _setup(Renderer)
    r.render(n_samples=1, max_depth=3)
    r.render(n_samples=1, max_depth=3)
    split = {k: v.clone() for k, v in r.layers.items()}
    r.init_render_states()
    r.render(n_samples=2, max_depth=3)
    for k in LAYERS + ("n_path_vertices",):
        assert torch.equal(split[k], r.layers[k]), k
    assert int(r.sample_count.min()) == int(r.sample_count.max()) == 2


def test_get_layer_and_envelope():
    from fredholm_tpu_torch.fused import kernels

    r = _setup(Renderer)
    r.set_bg_color([0.2, 0.3, 0.4])
    r.render(n_samples=1, max_depth=2)
    assert r.get_layer("beauty").shape == (32, 32, 3)
    assert r.get_layer("depth").shape == (32, 32, 1)
    # the CPU twins and the CUDA kernel take every lobe; the coat takes the
    # kernel's full variant
    scene = cornell_box()
    scene.materials[0].coat = 0.5
    r.set_scene(scene)
    assert r._lobes == ("coat", "diffuse_r") and r._params(2)["use_fused"]
    cfg = kernels.pf.FusedConfig(32, 32, 2, 2, r._lobes)
    assert kernels._lobe_mask(cfg) == 65 and kernels.mega_variant(cfg) == "full"
    # a thin film routes the scene to the wavefront integrator
    scene = cornell_box()
    scene.materials[1].thin_film_thickness = 300.0
    r = Renderer(8, 8, device="cpu")
    r.set_scene(scene)
    assert "thin_film" in r._lobes and not r._params(2)["use_fused"]


def _metal_row(cls, **kw):
    """The metal_row golden's setup (tools/gen_goldens.py:38-46) at 16^2."""
    r = cls(width=16, height=16, **kw)
    spheres = sphere_array_test if cls is Renderer else j_spheres
    r.set_scene(spheres("metalness", [0.0, 0.5, 1.0], spacing=1.05))
    r.camera.origin = np.asarray([0.0, 0.8, 2.2], np.float32)
    r.camera._update_transform()
    r.set_bg_color((0.6, 0.7, 0.9))
    return r


def _metal_row_reference_setup():
    j = _metal_row(JRenderer)
    j.use_pallas = False
    cfg = j._config(1, 3)
    assert cfg.use_fused and not cfg.use_dense
    assert cfg.lobes_on == ("metal", "specular", "diffuse_r")
    return j


def _metal_row_reference(tmp_path_factory):
    """The reference's metal_row layers at 2 spp, depth 3, on its plain
    path (use_pallas=False), once a session."""
    return _reference_layers(tmp_path_factory, "metal_row_layers", _metal_row_reference_setup,
                             n_samples=2, max_depth=3)


@pytest.fixture(scope="module")
def metal_renders(tmp_path_factory):
    def port():
        t = _metal_row(Renderer, device="cpu")
        assert "clusters" in t._dev and t._lobes == ("metal", "specular", "diffuse_r")
        return t

    return _both_layers(tmp_path_factory, "metal_row_layers", port,
                        _metal_row_reference_setup, n_samples=2, max_depth=3)


@pytest.mark.parametrize("key", LAYERS)
def test_metal_row_matches_reference(metal_renders, key):
    got, want = metal_renders
    np.testing.assert_allclose(got[key].numpy(), want[key], rtol=2e-4, atol=2e-4, err_msg=key)


def test_metal_row_path_vertices_match(metal_renders):
    got, want = metal_renders
    assert float(got["n_path_vertices"]) == float(want["n_path_vertices"]) > 0


def test_renderer_defaults_to_cuda():
    """Renderer() asks for the card; without one it raises, never falling
    back to the CPU."""
    import inspect

    assert inspect.signature(Renderer).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert Renderer(8, 8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Renderer(8, 8)


def test_port_never_imports_jax_or_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fredholm_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'fredholm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'fredholm_tpu' or k.startswith('fredholm_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_metric1.py"])
def test_chip_scripts_never_import_jax_or_the_reference(script):
    """The scripts run on a machine without JAX: no import of jax, the
    reference package, bench.py or tools/, at any depth of the file."""
    import ast

    with open(os.path.join(ROOT, script)) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    tops = {n.split(".")[0] for n in names}
    assert "fredholm_tpu_torch" in tops or script != "chip_smoke.py"
    assert not tops & {"jax", "jaxlib", "fredholm_tpu", "bench", "tools"}, tops
