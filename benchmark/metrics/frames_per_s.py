"""frames_per_s: real (unpadded) frames delivered to the host as uint8,
over the window's wall seconds."""


def read(r):
    return r.total("frames") / r.window_s if r.units else None
