"""Build and load the hand-written CUDA kernels; count their launches.

The sources under csrc/ have a plain `extern "C"` interface. At first use
each is compiled by its own nvcc process, all started together, and the
objects are linked into one shared library under build/fredholm_tpu_torch/
(next to the package), named by a hash of the sources and flags, and
loaded with ctypes. Nothing here runs at import: CPU-only installs import
the package without nvcc.

LAUNCHES counts, per name, the launches each kernel wrapper made and the
calls of each plain twin. With the loaded library and its build record,
it is the package's only global state.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "fredholm_tpu_torch")
SOURCES = ("dense_closest.cu", "dense_any.cu", "shade.cu", "clustered.cu", "slot_fetch.cu",
           "resident.cu", "probe_fma.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_lib = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source_hash(csrc_dir: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(csrc_dir, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _parse_ptxas(log: str) -> dict:
    """Per-kernel registers and spill bytes from `-Xptxas -v` output."""
    out = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_stores"] = int(m.group(1))
            out[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


def build(csrc_dir: str = CSRC_DIR, info: dict = BUILD_INFO) -> str:
    """Compile the kernels of csrc_dir (the package's own by default;
    chip_smoke.py --against builds another tree's to time it beside these)
    if no library for these sources exists; returns the library path and
    records the build in `info`. Raises on any compiler error."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libfh_kernels_{_source_hash(csrc_dir)}.so")
    if os.path.exists(lib_path):
        info.setdefault("seconds", 0.0)
        return lib_path
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{s}.{tag}.o") for s in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(csrc_dir, s)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s, p.returncode, log) for s, p, log in zip(SOURCES, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{s} ({rc}):\n{log}" for s, rc, log in failed))
    tmp = f"{lib_path}.{tag}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    for o in objs:
        os.remove(o)
    os.replace(tmp, lib_path)
    log = "".join(logs)
    info.update(seconds=time.perf_counter() - t0, ptxas=_parse_ptxas(log), log=log)
    return lib_path


class ShadeArgs(ctypes.Structure):
    """Mirror of `ShadeArgs` in csrc/common.cuh (same field order)."""

    _fields_ = [
        ("sv", ctypes.c_void_p),
        ("usv", ctypes.c_void_p),
        ("fused_table", ctypes.c_void_p),
        ("mat_table", ctypes.c_void_p),
        ("light_table", ctypes.c_void_p),
        ("sobol", ctypes.c_void_p),
        ("lut", ctypes.c_void_p),
        ("sheen_lut", ctypes.c_void_p),
        ("n_spp", ctypes.c_void_p),
        ("sample_idx", ctypes.c_void_p),
        ("state_in", ctypes.c_void_p),
        ("state_out", ctypes.c_void_p),
        ("rays_in", ctypes.c_void_p),
        ("hit_t", ctypes.c_void_p),
        ("hit_prim", ctypes.c_void_p),
        ("hit_u", ctypes.c_void_p),
        ("hit_v", ctypes.c_void_p),
        ("geom", ctypes.c_void_p),
        ("occ", ctypes.c_void_p),
        ("pending_in", ctypes.c_void_p),
        ("pending_out", ctypes.c_void_p),
        ("rays_out", ctypes.c_void_p),
        ("aov_out", ctypes.c_void_p),
        ("rad_out", ctypes.c_void_p),
        ("rays_in_stride", ctypes.c_longlong),
        ("hits_m", ctypes.c_longlong),
        ("n", ctypes.c_int),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("d", ctypes.c_int),
        ("max_depth", ctypes.c_int),
        ("n_faces", ctypes.c_int),
        ("n_mats", ctypes.c_int),
        ("n_lights", ctypes.c_int),
        ("lobe_mask", ctypes.c_int),
        ("sky_mode", ctypes.c_int),
        ("has_dl", ctypes.c_int),
        ("hit_block0", ctypes.c_int),
        ("tex_mask", ctypes.c_int),
        ("n_tex_runs", ctypes.c_int),
        ("tex_runs", ctypes.c_void_p),
    ]


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def load(lib_path: str):
    """Load a kernel library built by `build` and declare its entry points."""
    handle = ctypes.CDLL(lib_path)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    handle.fh_dense_closest.argtypes = [vp, ll, i, vp, i, vp, vp, vp, vp, vp]
    handle.fh_dense_closest.restype = i
    handle.fh_dense_any.argtypes = [vp, ll, i, vp, i, vp, vp]
    handle.fh_dense_any.restype = i
    for name in ("fh_clustered_closest", "fh_clustered_any"):
        fn = getattr(handle, name)
        fn.argtypes = [vp, ll, i, vp, vp, vp, i, i, vp, vp, vp, i, vp, vp, vp, i, i,
                       vp, vp, vp, vp, vp, vp, vp, vp]
        fn.restype = i
    for name in ("fh_resident_closest", "fh_resident_any"):
        fn = getattr(handle, name)
        fn.argtypes = [vp, ll, i, vp, vp, i, i, vp, ll, vp, vp, vp, vp, vp, vp]
        fn.restype = i
    handle.fh_clustered_stage_bytes.argtypes = [i, i]
    handle.fh_clustered_stage_bytes.restype = ll
    handle.fh_probe_fma.argtypes = [vp, vp, ll, i, ctypes.c_float, ctypes.c_float, vp]
    handle.fh_probe_fma.restype = i
    handle.fh_slot_fetch.argtypes = [vp, i, vp, ll, vp, vp]
    handle.fh_slot_fetch.restype = i
    for name in ("fh_raygen", "fh_mega", "fh_final"):
        fn = getattr(handle, name)
        fn.argtypes = [ctypes.POINTER(ShadeArgs), vp]
        fn.restype = i
    return handle


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
