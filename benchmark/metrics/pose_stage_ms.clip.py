"""pose_stage_ms.clip: the mean duration, in ms, of the program's
``pose_synthesis`` spans in the traced window (``StageTimer``'s stage, which
ends in a device-to-host read, so it holds B2's device time). None where
the program has no recorder or the window holds no such span."""

from text2video_tpu_torch.utils import profiling


def read(r):
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    ms = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in records()
          if s["name"] == "pose_synthesis"]
    return sum(ms) / len(ms) if ms else None
