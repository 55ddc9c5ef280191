"""train_device_ms_per_step: summed kernel time of the traced window, in
ms, over the optimizer steps in it."""


def read(r):
    steps = r.total("steps", traced=True)
    return 1e3 * r.trace.kernel_s / steps if r.trace and steps else None
