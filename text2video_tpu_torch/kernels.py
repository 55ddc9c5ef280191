"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

All sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. The build runs at first
use, into ``build/torch_kernels/<hash>/`` at the root of the checkout, keyed
by a hash of the sources and flags (``buildcache.build_library``), so a
fresh checkout builds everything from its own sources and an unchanged tree
reuses the library. A failed build raises; nothing falls back to the plain
PyTorch versions.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path
from typing import Optional, Tuple

from text2video_tpu_torch.buildcache import build_library

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
LIB_NAME = "libt2v_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit "
        "(on PATH or under CUDA_HOME)"
    )


def build() -> Tuple[Path, str]:
    """Compile ``csrc/*.cu`` unless this exact build exists.

    Returns (library path, compiler log). The log holds ``ptxas`` register,
    shared-memory and spill counts per kernel; it is empty for a reused
    build."""
    sources = sorted(CSRC.glob("*.cu"))
    nvcc = _nvcc()
    return build_library(
        BUILD_ROOT, LIB_NAME, sources, NVCC_FLAGS,
        lambda out: [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources)],
    )


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.t2v_conv3x3_tiles.argtypes = [i32] * 3
        lib.t2v_conv3x3_tiles.restype = i32
        lib.t2v_conv3x3_stats.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.t2v_conv3x3_stats.restype = i32
        lib.t2v_synthesize_and_smooth.argtypes = [ptr] * 7 + [i32] * 2 + [ptr]
        lib.t2v_synthesize_and_smooth.restype = i32
        lib.t2v_norm_splits.argtypes = [i32] * 6
        lib.t2v_norm_splits.restype = i32
        lib.t2v_norm_stats.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        lib.t2v_norm_stats.restype = i32
        lib.t2v_norm_apply.argtypes = ([ptr] * 8 + [i32] * 3
                                       + [ctypes.c_float] + [i32] * 4 + [ptr])
        lib.t2v_norm_apply.restype = i32
        _lib = lib
    return _lib


def check_launch(rc: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error (refused or failed launch)."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")
