"""Truncated-DCT wire codec of the frame-return path (counterpart of
``text2video_tpu/ops/dct.py``).

Each YUV420 plane of a finished chunk is transformed on the device with an
8x8 blockwise DCT, quantized with JPEG-style tables, truncated to its first
K zigzag coefficients and bit-packed per block (:func:`pack_plane_shift`):
30,720 bytes a 512x384 frame at the default K = 12 / 6, quality 75, against
294,912 for the uint8 YUV420 planes. The host then assembles baseline JPEGs
straight from those coefficients (``io/wire_native.py``: entropy coding
only, no IDCT and no pixel re-encode), or decodes them to planes with
:func:`decode_plane_np`.

Device side (:func:`encode_plane`, :func:`encode_yuv`,
:func:`pack_plane_shift`): plain torch ops on any device. The blockwise DCT,
quantization and truncation are one ``[blocks, 64] @ [64, k]`` product
against quant-scaled basis functions, computed in IEEE f32 whatever the
global TF32 settings say (TF32 would round the operands to a 10-bit
mantissa and move coefficients across rounding boundaries). Host side
(:func:`quant_tables`, :func:`decode_plane_np`, the unpacks): numpy, copied
from the JAX module, which cannot be imported without JAX.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

# Standard JPEG zigzag order: ZIGZAG[i] = row-major index of the i-th
# zigzag coefficient.
ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

# Annex-K JPEG base quantization tables (quality 50).
_LUMA_BASE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float64,
)
_CHROMA_BASE = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float64,
)

# int8 coefficient safety floors: the orthonormal DCT of a 128-shifted
# uint8 block is bounded by |coef| <= 1024, so a quantizer step below
# 1024/127 ~ 8.07 could clip the DC of an extreme flat block. AC floors
# guard hard synthetic edges.
_DC_MIN = 9.0
_AC_MIN = 5.0


def dct_matrix8() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix (float32)."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    d = np.cos((2 * n + 1) * k * np.pi / 16.0)
    d[0] *= 1.0 / np.sqrt(2.0)
    return (d * 0.5).astype(np.float32)


def quant_tables(quality: int = 80):
    """JPEG-style quality scaling -> (luma, chroma) float32 8x8 tables,
    floored so quantized coefficients always fit int8."""
    quality = int(np.clip(quality, 1, 100))
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality

    def _scaled(base):
        q = np.floor((base * scale + 50.0) / 100.0)
        q = np.clip(q, _AC_MIN, 255.0)
        q[0, 0] = max(q[0, 0], _DC_MIN)
        return q.astype(np.float32)

    return _scaled(_LUMA_BASE), _scaled(_CHROMA_BASE)


def _encode_kernel(quant: np.ndarray, k: int) -> np.ndarray:
    """[8, 8, 1, k] kernel whose output channel c is the c-th zigzag DCT-II
    basis function pre-divided by its quantizer step:
    K[u, v, 0, c] = D[zr(c), u] * D[zc(c), v] / quant[zr(c), zc(c)]."""
    d = dct_matrix8()
    zr, zc = ZIGZAG[:k] // 8, ZIGZAG[:k] % 8
    basis = d[zr][:, :, None] * d[zc][:, None, :]  # [k, 8, 8]
    scale = quant.astype(np.float32)[zr, zc]  # [k]
    return np.transpose(
        basis / scale[:, None, None], (1, 2, 0)
    )[:, :, None, :].astype(np.float32)


@contextlib.contextmanager
def _ieee_f32_matmul(device: torch.device):
    """f32 matmuls on ``device`` in IEEE f32 (no TF32) inside the block,
    the caller's setting restored after it."""
    if device.type != "cuda":
        yield
        return
    mm = torch.backends.cuda.matmul
    old = mm.fp32_precision  # the legacy allow_tf32 flag sets this too
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision = old


def encode_plane(plane: torch.Tensor, quant: np.ndarray,
                 k: int) -> torch.Tensor:
    """[..., H, W] float plane (0..255, any float dtype) -> [..., ceil(H/8),
    ceil(W/8), k] int8 zigzag-truncated quantized DCT coefficients, on the
    plane's device.

    Planes whose sides are not multiples of 8 (the 540x960 chroma of a 1080p
    canvas, the 192x352 of 384x704) are edge-padded up; the decoder returns
    the padded size and the caller crops. The plane is cast to f32 and
    shifted by 128 before the product; rounding is half to even, as
    ``jnp.round``."""
    h, w = plane.shape[-2:]
    lead = plane.shape[:-2]
    x = plane.float().reshape(-1, h, w)
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        x = F.pad(x[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]
        h, w = h + ph, w + pw
    x = x - 128.0
    hb, wb = h // 8, w // 8
    blocks = x.reshape(-1, hb, 8, wb, 8).permute(0, 1, 3, 2, 4).reshape(-1, 64)
    kern = torch.from_numpy(
        _encode_kernel(np.asarray(quant), k).reshape(64, k)).to(x.device)
    with _ieee_f32_matmul(x.device):
        q = blocks @ kern
    q = torch.clamp(torch.round(q), -127.0, 127.0).to(torch.int8)
    return q.reshape(*lead, hb, wb, k)


def encode_yuv(y, u, v, quality: int = 80, k_luma: int = 20,
               k_chroma: int = 8):
    """Device encode of float YUV planes (0..255) -> int8 coefficient
    tensors (yq, uq, vq)."""
    lq, cq = quant_tables(quality)
    return (
        encode_plane(y, lq, k_luma),
        encode_plane(u, cq, k_chroma),
        encode_plane(v, cq, k_chroma),
    )


_DECODE_KERNELS: dict = {}


def _decode_kernel(quant: np.ndarray, k: int) -> np.ndarray:
    """[k, 64] dequant+IDCT matrix: row c is the c-th zigzag basis block
    (flattened row-major) scaled by its quantizer step, so decoding is one
    BLAS matmul ``coeffs @ K``."""
    key = (quant.tobytes(), k)
    kern = _DECODE_KERNELS.get(key)
    if kern is None:
        d = dct_matrix8()
        zr, zc = ZIGZAG[:k] // 8, ZIGZAG[:k] % 8
        basis = d[zr][:, :, None] * d[zc][:, None, :]  # [k, 8, 8]
        scale = quant.astype(np.float32)[zr, zc]  # [k]
        kern = (basis * scale[:, None, None]).reshape(k, 64)
        _DECODE_KERNELS[key] = kern
    return kern


def decode_plane_np(coeffs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Host decode: [..., Hb, Wb, k] int8 -> [..., Hb*8, Wb*8] uint8
    (dequantize + IDCT as one [N*Hb*Wb, k] @ [k, 64] matmul)."""
    *lead, hb, wb, k = coeffs.shape
    kern = _decode_kernel(np.asarray(quant), k)
    flat = coeffs.reshape(-1, k).astype(np.float32) @ kern
    blocks = flat.reshape(*lead, hb, wb, 8, 8)
    pix = np.moveaxis(blocks, -3, -2).reshape(*lead, hb * 8, wb * 8)
    # np.rint, not np.round: round's decimals machinery is far slower on
    # large arrays.
    return np.clip(np.rint(pix + 128.0), 0.0, 255.0).astype(np.uint8)


def decode_yuv_np(yq, uq, vq, quality: int = 80):
    """Host decode of pulled int8 coefficient arrays -> uint8 planes."""
    lq, cq = quant_tables(quality)
    return (
        decode_plane_np(np.asarray(yq), lq),
        decode_plane_np(np.asarray(uq), cq),
        decode_plane_np(np.asarray(vq), cq),
    )


# ---- per-block-shift bit packing -------------------------------------
#
# Each block carries its DC exactly (8 bits), a 2-bit shift s and its ACs
# as (ac >> s) in W_AC bits: the range doubles where a block needs it and
# the precision halves only there. Packing is COLUMNAR BIT-PLANE: per
# field (DC, shift, each AC), the column is biased to unsigned and emitted
# as one byte per 8 blocks per bit plane, MSB first (np.unpackbits order).

W_AC_LUMA = 5
W_AC_CHROMA = 4


def packed_plane_bytes(n_blocks: int, k: int, w_ac: int) -> int:
    """Wire bytes for one plane of n_blocks shift-packed blocks."""
    m = -(-n_blocks // 8)  # byte groups per bit plane
    return int(m * (8 + 2 + (k - 1) * w_ac))


def block_shift(m: torch.Tensor, w_ac: int) -> torch.Tensor:
    """Per-block shift from the largest |AC| ``m`` (int): the smallest s in
    0..3 with m <= lim * 2^s, 3 past that (lim = 2^(w_ac-1) - 1). Integer
    form of the JAX package's ``ceil(log2(max(m, 1) / lim))`` clipped to
    0..3."""
    lim = (1 << (w_ac - 1)) - 1
    return ((m > lim).to(torch.int32) + (m > 2 * lim).to(torch.int32)
            + (m > 4 * lim).to(torch.int32))


def pack_plane_shift(coeffs: torch.Tensor, w_ac: int) -> torch.Tensor:
    """Device pack: [..., Hb, Wb, k] int8 coefficients -> flat uint8 of
    :func:`packed_plane_bytes` bytes.

    Per block: DC exact (8 bits), shift s (2 bits, :func:`block_shift`),
    ACs rounded-shifted ((ac + 2^(s-1)) >> s, floor semantics) in w_ac bits
    each, clipped after the shift. Every bit plane of every field is made
    by one gather, shift and weighted sum over all fields at once."""
    k = coeffs.shape[-1]
    dev = coeffs.device
    flat = coeffs.reshape(-1, k).to(torch.int32)
    n = flat.shape[0]
    lim = (1 << (w_ac - 1)) - 1
    ac = flat[:, 1:]
    s = block_shift(ac.abs().amax(dim=1), w_ac)
    half = torch.where(s > 0, 1 << torch.clamp(s - 1, min=0),
                       torch.zeros_like(s))
    ac_s = torch.clamp((ac + half[:, None]) >> s[:, None], -lim - 1, lim)
    # Fields [k + 1, n]: DC + 128, the shift, each AC biased to unsigned.
    fields = torch.cat([(flat[:, :1] + 128), s[:, None], ac_s + (lim + 1)],
                       dim=1).t()
    pad = (-n) % 8
    if pad:
        fields = F.pad(fields, (0, pad))
    widths = [8, 2] + [w_ac] * (k - 1)
    field_of = torch.tensor(
        [f for f, wd in enumerate(widths) for _ in range(wd)], device=dev)
    bit_of = torch.tensor(
        [b for wd in widths for b in range(wd - 1, -1, -1)],
        dtype=torch.int32, device=dev)
    bits = (fields[field_of] >> bit_of[:, None]) & 1  # [planes, n + pad]
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=dev)
    grp = bits.reshape(len(bit_of), -1, 8)
    return (grp * weights).sum(dim=-1).to(torch.uint8).reshape(-1)


def unpack_plane_shift_np(buf: np.ndarray, shape, w_ac: int) -> np.ndarray:
    """Host unpack: flat uint8 -> [..., Hb, Wb, k] int8 in the same
    quantized-coefficient domain as the unpacked wire (ACs carry the block
    shift back in: value << s, max 120, fits int8), by the native codec
    (``native/wire/wire.cc::t2v_wire_unpack``), which raises when it cannot
    be built. :func:`_unpack_plane_shift_numpy` is the reference."""
    from text2video_tpu_torch.io import wire_native

    return wire_native.unpack_plane(buf, shape, w_ac)


def _unpack_plane_shift_numpy(
    buf: np.ndarray, shape, w_ac: int
) -> np.ndarray:
    k = shape[-1]
    n = int(np.prod(shape[:-1]))
    m = -(-n // 8)
    widths = [8, 2] + [w_ac] * (k - 1)
    fields = []
    pos = 0
    for w in widths:
        planes = buf[pos : pos + w * m].reshape(w, m)
        pos += w * m
        bits = np.unpackbits(planes, axis=-1)  # [w, m*8]
        val = np.zeros(m * 8, np.int32)
        for b in range(w):
            val |= bits[b].astype(np.int32) << (w - 1 - b)
        fields.append(val)
    lim = (1 << (w_ac - 1)) - 1
    out = np.empty((m * 8, k), np.int8)
    out[:, 0] = (fields[0] - 128).astype(np.int8)
    s = fields[1]
    for i in range(k - 1):
        out[:, i + 1] = ((fields[2 + i] - (lim + 1)) << s).astype(np.int8)
    return out[:n].reshape(shape)
