"""Minimal ISO-BMFF (MP4) muxer for pre-encoded JPEG frames (counterpart of
``text2video_tpu/io/mp4.py``).

Role: the container half of the reference's L7 muxer (reference:
*phoneme_data/VidTIMIT/fadg0/image2video_real.py:12 — cv2.VideoWriter
``MP4V``). Each frame is JPEG-encoded once and its bytes are stream-copied
into an MP4: video track ``mp4v`` with an MPEG-4 ``esds`` declaring
objectTypeIndication 0x6C (JPEG), i.e. standards-compliant
Motion-JPEG-in-MP4 that ffmpeg/VLC/OpenCV all read. Container cost is
bookkeeping only (microseconds per frame, no pixel work).

Every sample is an intra frame, so no sync-sample table is needed and
seeking is exact.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List

_TIMESCALE = 90000


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload) + 8) + kind + payload


def _full(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(kind, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def _descriptor(tag: int, payload: bytes) -> bytes:
    # MPEG-4 systems expandable length; our descriptors are all short.
    assert len(payload) < 128
    return struct.pack(">BB", tag, len(payload)) + payload


def _esds(avg_bitrate: int, buffer_size: int) -> bytes:
    """ES descriptor declaring a JPEG visual stream (OTI 0x6C)."""
    dec_config = _descriptor(
        0x04,
        struct.pack(
            ">BB3sII",
            0x6C,               # objectTypeIndication: JPEG
            (4 << 2) | 1,       # streamType visual, reserved bit
            buffer_size.to_bytes(3, "big"),
            avg_bitrate,        # maxBitrate
            avg_bitrate,
        ),
    )
    sl_config = _descriptor(0x06, b"\x02")  # predefined MP4
    es = _descriptor(
        0x03, struct.pack(">HB", 1, 0) + dec_config + sl_config
    )
    return _full(b"esds", 0, 0, es)


def _sample_entry(w: int, h: int, avg_bitrate: int, buffer_size: int) -> bytes:
    body = (
        b"\x00" * 6                       # reserved
        + struct.pack(">H", 1)            # data_reference_index
        + b"\x00" * 16                    # pre_defined / reserved
        + struct.pack(">HH", w, h)
        + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
        + struct.pack(">I", 0)
        + struct.pack(">H", 1)            # frame_count
        + b"\x00" * 32                    # compressorname
        + struct.pack(">Hh", 24, -1)      # depth, pre_defined
        + _esds(avg_bitrate, buffer_size)
    )
    return _box(b"mp4v", body)


_MATRIX = struct.pack(
    ">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000
)


class Mp4Writer:
    """Incremental JPEG-samples-to-MP4 writer.

    ``add_jpeg`` appends the sample bytes to the ``mdat`` as they arrive
    (streaming — nothing is buffered but the per-sample sizes); ``close``
    patches the ``mdat`` size and appends the ``moov``.
    """

    def __init__(self, path: str, width: int, height: int, fps: float):
        self.w, self.h, self.fps = int(width), int(height), float(fps)
        self._sizes: List[int] = []
        self._f: BinaryIO = open(path, "wb")
        self._f.write(
            _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
        )
        self._mdat_at = self._f.tell()
        self._f.write(struct.pack(">I", 8) + b"mdat")

    def add_jpeg(self, jpeg: bytes) -> None:
        self._f.write(jpeg)
        self._sizes.append(len(jpeg))

    @property
    def n_frames(self) -> int:
        return len(self._sizes)

    def close(self) -> None:
        if self._f.closed:
            return
        n = len(self._sizes)
        mdat_size = 8 + sum(self._sizes)
        self._f.seek(self._mdat_at)
        self._f.write(struct.pack(">I", mdat_size))
        self._f.seek(0, 2)

        delta = int(round(_TIMESCALE / self.fps)) if self.fps > 0 else 3600
        duration = n * delta
        avg_bitrate = (
            int(sum(self._sizes) * 8 * self.fps / n) if n else 0
        )
        # esds packs buffer_size into 3 bytes; a >=16 MiB sample must not
        # blow up close() and lose an otherwise-complete file.
        buffer_size = min(max(self._sizes, default=0), 0xFFFFFF)

        # Zero samples (error paths can close a StreamingMuxer before any
        # frame arrives): skip the sample-table entries a count of 0 would
        # corrupt — an empty stts/stsz entry list is the spec-valid form.
        stts = _full(
            b"stts", 0, 0,
            struct.pack(">I", 0) if n == 0
            else struct.pack(">III", 1, n, delta),
        )
        # One chunk holding every sample: stco points at the first sample.
        stsc = _full(
            b"stsc", 0, 0,
            struct.pack(">I", 0) if n == 0
            else struct.pack(">IIII", 1, 1, n, 1),
        )
        stsz = _full(
            b"stsz", 0, 0,
            struct.pack(">II", 0, n) + struct.pack(f">{n}I", *self._sizes),
        )
        stco = _full(
            b"stco", 0, 0,
            struct.pack(">I", 0) if n == 0
            else struct.pack(">II", 1, self._mdat_at + 8),
        )
        stsd = _full(
            b"stsd", 0, 0,
            struct.pack(">I", 1)
            + _sample_entry(self.w, self.h, avg_bitrate, buffer_size),
        )
        stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
        dref = _full(
            b"dref", 0, 0,
            struct.pack(">I", 1) + _full(b"url ", 0, 1, b""),
        )
        minf = _box(
            b"minf",
            _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
            + _box(b"dinf", dref)
            + stbl,
        )
        hdlr = _full(
            b"hdlr", 0, 0,
            struct.pack(">I4s", 0, b"vide") + b"\x00" * 12 + b"VideoHandler\x00",
        )
        mdhd = _full(
            b"mdhd", 0, 0,
            struct.pack(">IIIIHH", 0, 0, _TIMESCALE, duration, 0x55C4, 0),
        )
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        tkhd = _full(
            b"tkhd", 0, 3,
            struct.pack(">IIIII", 0, 0, 1, 0, duration)
            + b"\x00" * 8
            + struct.pack(">hhhh", 0, 0, 0, 0)
            + _MATRIX
            + struct.pack(">II", self.w << 16, self.h << 16),
        )
        mvhd = _full(
            b"mvhd", 0, 0,
            struct.pack(">IIII", 0, 0, _TIMESCALE, duration)
            + struct.pack(">IH", 0x00010000, 0x0100)
            + b"\x00" * 10
            + _MATRIX
            + b"\x00" * 24
            + struct.pack(">I", 2),  # next_track_ID
        )
        self._f.write(_box(b"moov", mvhd + _box(b"trak", tkhd + mdia)))
        self._f.close()

    def __enter__(self) -> "Mp4Writer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_mp4_from_jpegs(
    jpegs: List[bytes], path: str, width: int, height: int, fps: float
) -> None:
    with Mp4Writer(path, width, height, fps) as w:
        for j in jpegs:
            w.add_jpeg(j)
