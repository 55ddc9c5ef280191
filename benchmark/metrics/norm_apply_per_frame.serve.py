"""norm_apply_per_frame.serve: launches of the generator's norm-apply kernel
(``csrc/fused_norm.cu``, every kernel whose name holds ``norm_apply``) in
the traced window over the frames generated in it. 0 where the trace holds
no such kernel (a program without it), None without a trace."""


def read(r):
    frames = r.total("frames", traced=True)
    if r.trace is None or not frames:
        return None
    return r.trace.kernel_times("norm_apply")[0] / frames
