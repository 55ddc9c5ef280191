"""mux_tail_s: the program's ``StageTimer`` stage ``mux`` (the host's work
after the last chunk: closing the streams, the AVI), a mean over the
window's clips."""


def read(r):
    mux = [u["mux_s"] for u in r.units if "mux_s" in u]
    return sum(mux) / len(mux) if mux else None
