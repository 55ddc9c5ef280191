"""b1_roofline: kernel B1's share of its roofline, in %: the summed least
times of the traced ``conv3x3_stats`` calls (each the larger of its
operations over the bf16 peak and its bytes over the memory bandwidth,
counted from its shape) over their summed profiler time. A call is the
kernels ``csrc/conv3x3_stats.cu`` launches for it: the reflect pad, the
wgmma conv (one a call, which counts the calls) and the statistics' finish.
Every call of a unit is at the shape it reports (``b1_shape``: batch, H/8,
W/8, 512)."""

from benchmark.lib.arith import b1_ops_bytes, bound_s, peaks

PAD, CONV, FINISH = ("::reflect_pad_kernel", "::conv3x3_wgmma_kernel",
                     "::finish_stats_kernel")


def read(r):
    peak = peaks(r.device_name)
    if r.trace is None or peak is None or not r.traced:
        return None
    launches, _ = r.trace.kernel_times(CONV)
    seconds = sum(r.trace.kernel_times(k)[1] for k in (PAD, CONV, FINISH))
    shapes = {tuple(u["b1_shape"]) for u in r.traced if "b1_shape" in u}
    if not launches or len(shapes) != 1:
        return None
    least = bound_s(*b1_ops_bytes(*shapes.pop()), peak)
    return 100.0 * launches * least / seconds
