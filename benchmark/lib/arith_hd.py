"""Operation counts of the coarse-to-fine generator (``reference/hd.py``).

``hd_frame_flops`` is the model's work, as ``arith.frame_flops`` counts it:
the plain generator's convolutions at ``2 * H * W * Cin * Cout * K^2`` each,
whatever form (phase, fused) a program runs them in; elementwise, norm,
pyramid and warp work are left out.
"""

from __future__ import annotations

from benchmark.lib.arith import frame_flops


def hd_frame_flops(h: int, w: int, base_ch: int = 64, n_downsample: int = 3,
                   n_blocks: int = 9, local_enhancers: int = 0,
                   local_blocks: int = 3, label_ch: int = 9,
                   prev_ch: int = 6) -> float:
    """Convolution FLOPs of one generator forward at h x w: the trunk at
    ``1 / 2**local_enhancers`` of the size without its heads, each local
    enhancer at its scale, and the heads on the finest stage.
    ``local_enhancers`` 0 is ``frame_flops``."""
    cin = label_ch + prev_ch
    if not local_enhancers:
        return frame_flops(h, w, base_ch, n_downsample, n_blocks, label_ch,
                           prev_ch)
    th, tw = h >> local_enhancers, w >> local_enhancers
    mac = (frame_flops(th, tw, base_ch, n_downsample, n_blocks, label_ch,
                       prev_ch) / 2 - th * tw * base_ch * 6 * 49)
    ch = base_ch // 2
    for i in reversed(range(local_enhancers)):  # coarse to fine
        sh, sw = h >> i, w >> i  # the stage's scale
        half = (sh // 2) * (sw // 2)
        mac += sh * sw * cin * ch * 49  # 7x7 stem
        mac += half * ch * 2 * ch * 9  # stride-2 block
        feat_ch = base_ch if i == local_enhancers - 1 else ch
        mac += half * feat_ch * 2 * ch * 9  # merge of the coarser feature
        mac += local_blocks * 2 * half * (2 * ch) ** 2 * 9  # resblocks
        mac += sh * sw * 2 * ch * ch * 9  # nearest-2x + 3x3 upsample
    mac += h * w * ch * 6 * 49  # merged heads, 7x7
    return 2.0 * mac
