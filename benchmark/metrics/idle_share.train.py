"""The device's idle share of the traced window, in %: 1 - the time in
which a kernel, copy or memset ran (their union) over the window."""

from benchmark.lib.trace import idle_share


def read(r):
    return idle_share(r.trace)
