"""Build and load the port's CUDA kernels: K1-K5 (csrc/intersect_kernels.cu),
the row layout's shade kernel (csrc/shade_kernels.cu) and the draw kernel
(csrc/prng_kernels.cu).

nvcc compiles the sources into one shared library with a plain C interface
at first use, into the gitignored `raytracer_odin_tpu_torch/build/` directory,
and ctypes loads it. No PyTorch header is compiled, so the build takes
seconds. Nothing here runs at import: the CPU tests import every module on
a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

from raytracer_odin_tpu_torch.ops import pallas_intersect as pi

_PKG_ROOT = Path(__file__).resolve().parents[1]
SOURCES = (_PKG_ROOT / "csrc" / "intersect_kernels.cu",
           _PKG_ROOT / "csrc" / "shade_kernels.cu",
           _PKG_ROOT / "csrc" / "prng_kernels.cu")
BUILD_DIR = _PKG_ROOT / "build"
# The kernel layout of this process (pallas_intersect.LEAF, RB, RB_SUB, read
# from the environment at import) is compiled in: one library a layout.
LAYOUT = {"RT_LEAF": pi.LEAF, "RT_RB": pi.RB, "RT_RB_SUB": pi.RB_SUB}
_SO = BUILD_DIR / ("librt_intersect_sm90a_"
                   + "_".join(str(v) for v in LAYOUT.values()) + ".so")

# -fmad=false and IEEE division (no --use_fast_math) make the kernels round
# every expression as the plain PyTorch versions do: bit-equal results.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-prec-div=true",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> str:
    """Compile the kernels; returns nvcc's report (ptxas -v resource use).
    Raises RuntimeError with the compiler's output when the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    defines = [f"-D{k}={v}" for k, v in LAYOUT.items()]
    cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(tmp),
           *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{report}")
    tmp.replace(_SO)
    return report


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing or older
    than any of its sources."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        newest = max(src.stat().st_mtime for src in SOURCES)
        if not _SO.exists() or _SO.stat().st_mtime < newest:
            build()
        lib = ctypes.CDLL(str(_SO))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rt_mask_launch.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.rt_mask_launch.restype = i
        for name in ("rt_culled_launch", "rt_stream_launch",
                     "rt_light_launch"):
            getattr(lib, name).argtypes = [p, p, i, p, i, p, i, p, p]
            getattr(lib, name).restype = i
        lib.rt_brute_launch.argtypes = [p, i, p, i, p, p]
        lib.rt_brute_launch.restype = i
        lib.rt_shade_launch.argtypes = [i, p, p, p]
        lib.rt_shade_launch.restype = i
        lib.rt_shade_abi.argtypes = [p]
        lib.rt_shade_abi.restype = i
        lib.rt_draw_launch.argtypes = [p, p]
        lib.rt_draw_launch.restype = i
        lib.rt_draw_abi.argtypes = [p]
        lib.rt_draw_abi.restype = i
        _lib = lib
        return _lib
