"""mfu.serve_hd: the coarse-to-fine generator's model FLOPs a frame (the
plain model's convolutions, trunk, local enhancers and heads, whatever form
runs them: ``lib/arith_hd.py``) times the traced window's frames per
second, over the card's dense bf16 peak, in %."""

from benchmark.lib.arith import peaks
from benchmark.lib.arith_hd import hd_frame_flops


def read(r):
    peak = peaks(r.device_name)
    frames = r.total("frames", traced=True)
    if r.trace is None or peak is None or not frames:
        return None
    c = r.cell.config
    flops = hd_frame_flops(c["height"], c["width"], c["base_ch"],
                           c["n_downsample"], c["n_blocks"],
                           c.get("local_enhancers", 0),
                           c.get("local_blocks", 3))
    return 100.0 * flops * frames / r.trace.window_s / peak["bf16_flops_per_s"]
