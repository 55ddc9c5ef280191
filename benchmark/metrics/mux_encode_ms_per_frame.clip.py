"""mux_encode_ms_per_frame.clip: the muxer worker's time in the program's
``mux.encode`` spans of the traced window (a chunk's JPEG assembly and
write), in ms, over the frames they carry. None where the program has no
recorder or the window holds no such span."""

from text2video_tpu_torch.utils import profiling


def read(r):
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    spans = [s for s in records() if s["name"] == "mux.encode"]
    frames = sum(s["attrs"]["frames"] for s in spans)
    if not frames:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e6 / frames
