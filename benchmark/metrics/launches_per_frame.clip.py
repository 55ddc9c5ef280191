"""launches_per_frame.clip: CUDA kernels launched in the traced window over
the frames generated in it."""


def read(r):
    frames = r.total("frames", traced=True)
    return r.trace.kernels / frames if r.trace and frames else None
