"""rasterize_device_ms.clip: the mean device time, in ms, of the program's
``rasterize`` spans in the traced window: each span's CUDA event pair
(``device_ms``), from the card reaching the stage's first launch to its
finishing the last, idle stretches between them included. None where the
program has no recorder or the window holds no such span."""

from text2video_tpu_torch.utils import profiling


def read(r):
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    ms = [s["device_ms"] for s in records()
          if s["name"] == "rasterize" and s.get("device_ms") is not None]
    return sum(ms) / len(ms) if ms else None
