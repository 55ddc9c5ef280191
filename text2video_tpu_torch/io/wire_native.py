"""ctypes bindings for the native wire codec, ``libt2v_wire.so``
(counterpart of ``text2video_tpu/io/wire_native.py``).

The streaming renderer pulls frames off the card as bit-packed, truncated,
quantized DCT coefficients (``ops/dct.py``). This module hands them to
``native/wire/wire.cc``, which produces muxer-ready output with no Python
pixel work:

  * :func:`unpack_plane` — the bit-plane unpack of the packed wire back to
    int8 coefficients.
  * :func:`to_jpegs` — baseline JFIF images assembled directly from the
    quantized coefficients (entropy coding only, no IDCT and no JPEG
    re-compression), which the muxer stream-copies into the MP4 and AVI.
  * :func:`decode_bgr` — fused dequantize + IDCT + chroma upsample + BT.601
    YUV->BGR.

The library is compiled on first use with ``g++`` directly (``-O3``, as
``native/CMakeLists.txt`` builds it, but as C++20: the unpack left-shifts
negative values, which C++17 leaves undefined; no cmake), into
``build/torch_native/<hash of the source and flags>/`` at the root of the
checkout, through ``buildcache.build_library`` (a lock, so concurrent test
workers build once, and an atomic rename). A failed build raises with the
compiler's output: ``wire_format="dct"`` means this codec or an error,
never another path.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path
from typing import List, Optional

import numpy as np

from text2video_tpu_torch.buildcache import build_library
from text2video_tpu_torch.ops.dct import _decode_kernel, quant_tables

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO_ROOT / "native" / "wire" / "wire.cc"
BUILD_ROOT = _REPO_ROOT / "build" / "torch_native"
LIB_NAME = "libt2v_wire.so"
CXX_FLAGS = ("-O3", "-std=c++20", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None

_I8P = ctypes.POINTER(ctypes.c_int8)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)


def ensure_built() -> str:
    """Path of ``libt2v_wire.so``, compiled from ``native/wire/wire.cc``
    unless this exact build (source and flags) exists."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: building {LIB_NAME} needs it")
    lib, _ = build_library(
        BUILD_ROOT, LIB_NAME, [SOURCE], CXX_FLAGS,
        lambda out: [cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE)],
    )
    return str(lib)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        lib.t2v_wire_decode_bgr.restype = ctypes.c_int
        lib.t2v_wire_decode_bgr.argtypes = [
            _I8P, _I8P, _I8P,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _F32P, _F32P, ctypes.c_int, ctypes.c_int, _U8P,
        ]
        lib.t2v_wire_to_jpeg.restype = ctypes.c_int64
        lib.t2v_wire_to_jpeg.argtypes = [
            _I8P, _I8P, _I8P,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _F32P, _F32P, ctypes.c_int, ctypes.c_int,
            _U8P, ctypes.c_int64, _I64P,
        ]
        lib.t2v_wire_unpack.restype = ctypes.c_int
        lib.t2v_wire_unpack.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _I8P,
        ]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (a probe for callers that
    ask; the wire path itself calls :func:`get_lib` and raises)."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def unpack_plane(buf: np.ndarray, shape, w_ac: int) -> np.ndarray:
    """Native bit-plane unpack of the per-block-shift packed wire
    (``ops/dct.py::pack_plane_shift`` layout) -> int8 coefficient array of
    ``shape``."""
    lib = get_lib()
    k = int(shape[-1])
    n_blocks = 1
    for d in shape[:-1]:
        n_blocks *= int(d)
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    m = -(-n_blocks // 8)
    if buf.size < m * (10 + (k - 1) * w_ac):
        raise ValueError(f"packed plane of {buf.size} bytes is too short "
                         f"for {n_blocks} blocks of {k} coefficients")
    out = np.empty((n_blocks, k), np.int8)
    rc = lib.t2v_wire_unpack(
        buf.ctypes.data_as(_U8P),
        ctypes.c_int64(n_blocks),
        ctypes.c_int(k),
        ctypes.c_int(w_ac),
        out.ctypes.data_as(_I8P),
    )
    if rc != 0:
        raise RuntimeError(f"t2v_wire_unpack failed: rc={rc}")
    return out.reshape(shape)


def _prep(yq: np.ndarray, uq: np.ndarray, vq: np.ndarray, quality: int):
    yq = np.ascontiguousarray(yq, dtype=np.int8)
    uq = np.ascontiguousarray(uq, dtype=np.int8)
    vq = np.ascontiguousarray(vq, dtype=np.int8)
    n, yhb, ywb, kl = yq.shape
    chb, cwb, kc = uq.shape[1:]
    if vq.shape != uq.shape or uq.shape[0] != n:
        raise ValueError(f"coefficient shapes {yq.shape} {uq.shape} "
                         f"{vq.shape} do not form one chunk")
    lq, cq = quant_tables(quality)
    return yq, uq, vq, n, yhb, ywb, chb, cwb, kl, kc, lq, cq


def _check_size(h: int, w: int, yhb: int, ywb: int, chb: int, cwb: int):
    """The native codec reads (h, w) pixels out of the block grids."""
    if not (0 < h <= 8 * yhb and 0 < w <= 8 * ywb
            and (h + 1) // 2 <= 8 * chb and (w + 1) // 2 <= 8 * cwb):
        raise ValueError(f"{h}x{w} frames do not fit block grids "
                         f"{yhb}x{ywb} / {chb}x{cwb}")


def decode_bgr(
    yq: np.ndarray,
    uq: np.ndarray,
    vq: np.ndarray,
    h: int,
    w: int,
    quality: int = 80,
) -> np.ndarray:
    """[n, yhb, ywb, kl] / [n, chb, cwb, kc] int8 coefficient arrays ->
    [n, h, w, 3] uint8 BGR frames (cropped to the true pixel dims)."""
    lib = get_lib()
    yq, uq, vq, n, yhb, ywb, chb, cwb, kl, kc, lq, cq = _prep(
        yq, uq, vq, quality
    )
    _check_size(h, w, yhb, ywb, chb, cwb)
    lkern = np.ascontiguousarray(_decode_kernel(lq, kl))
    ckern = np.ascontiguousarray(_decode_kernel(cq, kc))
    out = np.empty((n, h, w, 3), np.uint8)
    rc = lib.t2v_wire_decode_bgr(
        yq.ctypes.data_as(_I8P), uq.ctypes.data_as(_I8P),
        vq.ctypes.data_as(_I8P),
        n, yhb, ywb, chb, cwb, kl, kc,
        lkern.ctypes.data_as(_F32P), ckern.ctypes.data_as(_F32P),
        h, w, out.ctypes.data_as(_U8P),
    )
    if rc != 0:
        raise RuntimeError(f"t2v_wire_decode_bgr failed: rc={rc}")
    return out


def to_jpegs(
    yq: np.ndarray,
    uq: np.ndarray,
    vq: np.ndarray,
    h: int,
    w: int,
    quality: int = 80,
) -> List[bytes]:
    """Coefficient arrays -> one baseline JFIF byte string per frame."""
    lib = get_lib()
    yq, uq, vq, n, yhb, ywb, chb, cwb, kl, kc, lq, cq = _prep(
        yq, uq, vq, quality
    )
    _check_size(h, w, yhb, ywb, chb, cwb)
    lqf = np.ascontiguousarray(lq, dtype=np.float32).reshape(-1)
    cqf = np.ascontiguousarray(cq, dtype=np.float32).reshape(-1)
    # The encoder's exact worst case (fixed-length symbols: <= 15 DC +
    # 18*k AC bits a block, byte stuffing can double the bytes); block
    # counts from the MCU grid cover edge-clamped odd grids.
    mcux, mcuy = (w + 15) // 16, (h + 15) // 16

    def block_bytes(k):
        return 2 * ((15 + 18 * k + 7) // 8)

    cap = n * (mcuy * mcux * (4 * block_bytes(kl) + 2 * block_bytes(kc))
               + 2048)
    out = np.empty(cap, np.uint8)
    sizes = np.zeros(n, np.int64)
    total = lib.t2v_wire_to_jpeg(
        yq.ctypes.data_as(_I8P), uq.ctypes.data_as(_I8P),
        vq.ctypes.data_as(_I8P),
        n, yhb, ywb, chb, cwb, kl, kc,
        lqf.ctypes.data_as(_F32P), cqf.ctypes.data_as(_F32P),
        h, w, out.ctypes.data_as(_U8P), cap,
        sizes.ctypes.data_as(_I64P),
    )
    if total < 0:
        raise RuntimeError("t2v_wire_to_jpeg: output capacity overflow")
    res: List[bytes] = []
    off = 0
    for s in sizes:
        res.append(out[off : off + int(s)].tobytes())
        off += int(s)
    return res
