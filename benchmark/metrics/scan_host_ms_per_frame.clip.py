"""scan_host_ms_per_frame.clip: the host's time in the program's
``render.chunk`` spans of the traced window (one a ``Renderer._scan_chunk``
call: the enqueue of its launches), in ms, over the frames they carry
(``frames``, steps x batch): the launch loop's pace. None where the program
has no recorder or the window holds no such span."""

from text2video_tpu_torch.utils import profiling


def read(r):
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    spans = [s for s in records() if s["name"] == "render.chunk"]
    frames = sum(s["attrs"]["frames"] for s in spans)
    if not frames:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e6 / frames
