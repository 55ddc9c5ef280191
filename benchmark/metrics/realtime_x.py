"""realtime_x: seconds of video in the mp4 files completed in the window,
over the window's wall seconds."""


def read(r):
    return r.total("video_s") / r.window_s if r.units else None
