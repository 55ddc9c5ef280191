"""gen_device_ms_per_frame: summed kernel time of the traced window, in ms,
over the frames generated in it."""


def read(r):
    frames = r.total("frames", traced=True)
    return 1e3 * r.trace.kernel_s / frames if r.trace and frames else None
