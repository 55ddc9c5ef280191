"""setup_s: seconds from process start to the window's start (loading,
building, warming up)."""


def read(r):
    return r.setup_s
