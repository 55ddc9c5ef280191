"""pipeline_self_ms.clip: the host time of a text-to-mp4 request that no
span of the program names, in ms: over the traced window's ``synthesize``
spans (``text2video_tpu_torch/utils/profiling.py``), the mean of a span's
duration less the union of its direct children in its thread. None where
the program has no recorder or the window holds no such span."""

from text2video_tpu_torch.utils import profiling


def self_ns(root, spans) -> int:
    """``root``'s duration less the union of its direct children."""
    kids = sorted((max(s["start_ns"], root["start_ns"]),
                   min(s["end_ns"], root["end_ns"])) for s in spans
                  if s["parent"] == root["id"]
                  and s["thread"] == root["thread"])
    covered, edge = 0, root["start_ns"]
    for a, b in kids:
        a = max(a, edge)
        if b > a:
            covered += b - a
            edge = b
    return root["end_ns"] - root["start_ns"] - covered


def read(r):
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    spans = records()
    roots = [s for s in spans if s["name"] == "synthesize"]
    if not roots:
        return None
    return sum(self_ns(s, spans) for s in roots) / len(roots) / 1e6
