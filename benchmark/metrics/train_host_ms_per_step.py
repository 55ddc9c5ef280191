"""train_host_ms_per_step: the mean duration, in ms, of the program's
``train.step`` spans in the traced window: the host's enqueue of a step
(read beside ``train_device_ms_per_step``). None where the program has no
recorder or the window holds no such span."""

from text2video_tpu_torch.utils import profiling


def read(r):
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    ms = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in records()
          if s["name"] == "train.step"]
    return sum(ms) / len(ms) if ms else None
