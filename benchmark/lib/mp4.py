"""Frames read back from a written MP4 of JPEG samples (ISO-BMFF): the
sample sizes from ``stsz``, the chunk offsets from ``stco``, each sample
decoded by libjpeg through OpenCV."""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl"}


def _boxes(buf: bytes, lo: int, hi: int, out: Dict[bytes, bytes]) -> None:
    while lo + 8 <= hi:
        size, kind = struct.unpack(">I4s", buf[lo: lo + 8])
        head = 8
        if size == 1:
            size, head = struct.unpack(">Q", buf[lo + 8: lo + 16])[0], 16
        elif size == 0:
            size = hi - lo
        if size < head:
            raise ValueError(f"bad MP4 box {kind!r} of size {size}")
        if kind in CONTAINERS:
            _boxes(buf, lo + head, lo + size, out)
        else:
            out.setdefault(kind, buf[lo + head: lo + size])
        lo += size


def jpeg_samples(path: str) -> List[bytes]:
    """The video track's samples, in order."""
    with open(path, "rb") as f:
        buf = f.read()
    boxes: Dict[bytes, bytes] = {}
    _boxes(buf, 0, len(buf), boxes)
    stsz, stco = boxes[b"stsz"], boxes[b"stco"]
    fixed, count = struct.unpack(">II", stsz[4:12])
    sizes = ([fixed] * count if fixed else
             list(struct.unpack(f">{count}I", stsz[12: 12 + 4 * count])))
    n_chunks = struct.unpack(">I", stco[4:8])[0]
    offsets = struct.unpack(f">{n_chunks}I", stco[8: 8 + 4 * n_chunks])
    stsc = boxes.get(b"stsc")
    per_chunk = [count] if n_chunks == 1 else None
    if per_chunk is None:
        # One sample a chunk unless stsc says otherwise.
        entries = struct.unpack(">I", stsc[4:8])[0]
        rows = [struct.unpack(">III", stsc[8 + 12 * i: 20 + 12 * i])
                for i in range(entries)]
        per_chunk = []
        for c in range(1, n_chunks + 1):
            per_chunk.append([r[1] for r in rows if r[0] <= c][-1])
    out, s = [], 0
    for off, n in zip(offsets, per_chunk):
        for _ in range(n):
            out.append(buf[off: off + sizes[s]])
            off += sizes[s]
            s += 1
    return out


def decoded_luma(path: str) -> np.ndarray:
    """[T, H, W] uint8: each sample's luma as libjpeg decodes it (the Y
    component of a YCbCr JPEG, with no colour conversion)."""
    import cv2
    frames = [cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_GRAYSCALE)
              for j in jpeg_samples(path)]
    if any(f is None for f in frames):
        raise ValueError(f"{path}: a sample is not a decodable JPEG")
    return np.stack(frames)
