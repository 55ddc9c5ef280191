"""Structured JSON-lines logging for pipeline runs (counterpart of
``text2video_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Optional, TextIO


class JsonLogger:
    """Writes one JSON object per event: {"ts", "event", **fields}."""

    def __init__(self, stream: Optional[TextIO] = None, path: Optional[str] = None):
        self._stream = stream  # None: sys.stderr as it is at each event
        self._file = open(path, "a") if path else None

    def log(self, event: str, **fields: Any) -> None:
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        line = json.dumps(rec, default=str)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        else:
            print(line, file=self._stream or sys.stderr)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()


_default: Optional[JsonLogger] = None


def get_logger() -> JsonLogger:
    global _default
    if _default is None:
        _default = JsonLogger()
    return _default
