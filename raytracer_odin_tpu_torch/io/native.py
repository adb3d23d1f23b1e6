"""ctypes loader for the port's native host runtime (csrc/rtnative.cpp).

Compiles the shared library with g++ on first use into the gitignored
`raytracer_odin_tpu_torch/build/` directory, and raises if it cannot. With
RT_TPU_NO_NATIVE set (the JAX package's switch), `load` returns None and
PNG row unfiltering and the BVH builder take their numpy paths
(png._unfilter_py, bvh._build_py): only then, since the numpy BVH orders
the triangles otherwise than the native builder, so a silent switch would
change every cluster.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG_ROOT = Path(__file__).resolve().parents[1]
_SRC = _PKG_ROOT / "csrc" / "rtnative.cpp"
BUILD_DIR = _PKG_ROOT / "build"
_SO = BUILD_DIR / "librtnative_torch.so"

_lock = threading.Lock()
_lib = None


def _compile() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # A per-process temporary name: parallel test workers may build at once.
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC),
           "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ could not build {_SRC}:\n{e.stderr}") from e
    tmp.replace(_SO)


class _NativeLib:
    def __init__(self, cdll: ctypes.CDLL):
        self._cdll = cdll
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        cdll.png_unfilter.argtypes = [
            u8p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        cdll.png_unfilter.restype = ctypes.c_int
        cdll.bvh_build.argtypes = [
            ctypes.c_int32, f32p, f32p, ctypes.c_int32, ctypes.c_int32,
            i32p, f32p, f32p, i32p, i32p, i32p,
        ]
        cdll.bvh_build.restype = ctypes.c_int32

    def png_unfilter(self, raw, out, height, stride, bpp):
        rc = self._cdll.png_unfilter(raw, out, height, stride, bpp)
        if rc != 0:
            raise ValueError("native png_unfilter failed (bad filter byte)")
        return out

    def bvh_build(self, lo: np.ndarray, hi: np.ndarray, leaf_size: int):
        n = lo.shape[0]
        cap = max(2 * n + 2, 8)
        perm = np.zeros(n, np.int32)
        out_lo = np.zeros((cap, 3), np.float32)
        out_hi = np.zeros((cap, 3), np.float32)
        out_first = np.zeros(cap, np.int32)
        out_count = np.zeros(cap, np.int32)
        out_links = np.zeros(8 * 2 * cap, np.int32)
        n_nodes = self._cdll.bvh_build(
            n,
            np.ascontiguousarray(lo, np.float32),
            np.ascontiguousarray(hi, np.float32),
            leaf_size, cap, perm,
            out_lo.reshape(-1), out_hi.reshape(-1),
            out_first, out_count, out_links,
        )
        if n_nodes < 0:
            raise RuntimeError("native bvh_build: node capacity exceeded")
        # The C side packs links densely with stride n_nodes.
        links = out_links[: 8 * 2 * n_nodes].reshape(8, 2, n_nodes).copy()
        return (
            perm,
            out_lo[:n_nodes], out_hi[:n_nodes],
            out_first[:n_nodes], out_count[:n_nodes],
            links,
            n_nodes,
        )


def load() -> _NativeLib | None:
    """Return the native lib wrapper, building it first if needed; None
    when RT_TPU_NO_NATIVE is set (read at every call)."""
    global _lib
    if os.environ.get("RT_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is None:
            if (not _SO.exists()
                    or _SO.stat().st_mtime < _SRC.stat().st_mtime):
                _compile()
            _lib = _NativeLib(ctypes.CDLL(str(_SO)))
        return _lib
