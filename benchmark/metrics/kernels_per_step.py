"""kernels_per_step: CUDA kernels launched in the traced window over the
optimizer steps in it."""


def read(r):
    steps = r.total("steps", traced=True)
    return r.trace.kernels / steps if r.trace and steps else None
