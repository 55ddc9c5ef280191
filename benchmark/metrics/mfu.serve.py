"""mfu.serve: the generator's model FLOPs a frame (the plain model's
convolutions, whatever form runs them) times the traced window's frames per
second, over the card's dense bf16 peak, in %."""

from benchmark.lib.arith import frame_flops, peaks


def read(r):
    peak = peaks(r.device_name)
    frames = r.total("frames", traced=True)
    if r.trace is None or peak is None or not frames:
        return None
    c = r.cell.config
    flops = frame_flops(c["height"], c["width"], c["base_ch"],
                        c["n_downsample"], c["n_blocks"])
    return 100.0 * flops * frames / r.trace.window_s / peak["bf16_flops_per_s"]
