"""wire_bytes_per_frame.clip: the program's counter ``wire_bytes`` (the
wire tensors whose device-to-host copy started) over the frames of the
traced window's ``render.chunk`` spans. None where the program has no
recorder or the window holds no such span or count."""

from text2video_tpu_torch.utils import profiling


def read(r):
    records = getattr(profiling, "records", None)
    counters = getattr(profiling, "counters", None)
    if records is None or counters is None:
        return None
    frames = sum(s["attrs"]["frames"] for s in records()
                 if s["name"] == "render.chunk")
    wire = counters().get("wire_bytes")
    return wire / frames if frames and wire else None
