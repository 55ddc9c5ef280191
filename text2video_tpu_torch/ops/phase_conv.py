"""Exact phase-form (polyphase) convolutions of the generator's stem and
decoder tail (counterpart of ``text2video_tpu/ops/phase_conv.py``).

Three convs of the generator are computed at the coarse resolution, with the
same parameters and the same function as their plain forms:

  * ``nearest-up(2x) -> reflect-pad(1) -> 3x3 VALID conv`` over a
    [B, h, w, Cin] map reads at most a 2x2 window of coarse pixels per output
    pixel, so all four output phases come from ONE 2x2-window conv with
    4*Cout stacked outputs, and the 2x map and its padded copy are never
    built (:func:`upsample2x_conv_phase`);
  * a full-resolution ``reflect-pad(3) -> 7x7 conv`` of a map held as a
    phase tensor is a 4x4-window conv over the phase tensor with 4*Cout
    outputs (:func:`head_conv_phase`: the heads, and the stem over
    ``space_to_depth2`` of its input);
  * ``reflect-pad(1) -> 3x3 stride-2 conv`` of a phase tensor is a 2x2-window
    conv over it (:func:`down2x_conv_phase`: the first downsample after the
    phase stem).

The phase kernels are reparameterisations of the original kernels, built as
products with constant 0/1 selection tensors (an elementwise product and a
sum: IEEE f32 whatever the TF32 flags say, and a backward that is a product
too, with no index accumulation). The window convs are ``F.conv2d``; on the
TPU they were XLA convs outside any Pallas kernel. The public functions take
the HWIO kernel, as the JAX ones do; the ``*_window`` functions take a phase
kernel already built and laid out OIHW, which ``layers.Conv.weights`` makes
once per parameter version for inference.

Phase layout: a phase tensor P [B, h, w, 4*C] holds the full-resolution map
f [B, 2h, 2w, C] with ``f[:, 2i + pr, 2j + pc, c] == P[:, i, j, (2pr + pc)C
+ c]``. All tensors are NHWC.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def depth_to_space2(p: torch.Tensor) -> torch.Tensor:
    """[B, h, w, 4*C] phase tensor -> [B, 2h, 2w, C] full-res map."""
    b, h, w, c4 = p.shape
    c = c4 // 4
    p = p.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return p.reshape(b, 2 * h, 2 * w, c)


def space_to_depth2(f: torch.Tensor) -> torch.Tensor:
    """[B, 2h, 2w, C] -> [B, h, w, 4*C] (inverse of depth_to_space2)."""
    b, hh, ww, c = f.shape
    f = f.reshape(b, hh // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return f.reshape(b, hh // 2, ww // 2, 4 * c)


def oihw(k: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel as ``F.conv2d`` takes it (a view)."""
    return k.permute(3, 2, 0, 1)


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID stride-1 conv of NHWC ``x`` with OIHW ``w``."""
    return F.conv2d(x.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _selection(name: str, device: torch.device) -> torch.Tensor:
    """The 0/1 table ``name`` of :data:`_TABLES` as an f32 tensor on
    ``device``, copied there once (a host copy at every build would stall
    the stream), and never an inference tensor, so that a train step may
    save it."""
    with torch.inference_mode(False):
        return torch.as_tensor(_TABLES[name], device=device)


def _wide(k: torch.Tensor) -> torch.Tensor:
    """``k`` in the dtype a kernel build sums in: f32, or f64 for f64."""
    return k.to(torch.promote_types(k.dtype, torch.float32))


def _contract(name: str, k: torch.Tensor, dim: int) -> torch.Tensor:
    """``sum_j sel[..., j] * k[(dim) j]`` for the 0/1 table ``sel`` named
    ``name``: axis ``dim`` of ``k`` (f32 or f64) replaced by the leading
    axes of ``sel``, which go first. An elementwise product and a sum: the
    build sums its at most four taps an entry in ``k``'s dtype whatever the
    TF32 flags say, and its backward is a product, with no index
    accumulation."""
    sel = _selection(name, k.device)
    km = k.movedim(dim, 0)
    sel = sel.reshape(*sel.shape, *([1] * (km.dim() - 1)))
    return (sel * km).sum(dim=sel.dim() - km.dim())


# ---------------------------------------------------------------------
# the edge pad of the coarse input, with an ordered backward
# ---------------------------------------------------------------------

def _replicate(x: torch.Tensor,
               pads: Tuple[int, int, int, int]) -> torch.Tensor:
    top, bottom, left, right = pads
    y = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
              mode="replicate")
    return y.permute(0, 2, 3, 1)


def _fold_edges(g: torch.Tensor, lo: int, hi: int, dim: int) -> torch.Tensor:
    """The gradient of an edge pad of (``lo``, ``hi``) along ``dim``: the
    interior of ``g`` with each border row added onto the edge row it copies,
    one row at a time."""
    n = g.shape[dim] - lo - hi
    out = g.narrow(dim, lo, n).clone()
    for i in range(lo):
        out.narrow(dim, 0, 1).add_(g.narrow(dim, i, 1))
    for i in range(hi):
        out.narrow(dim, n - 1, 1).add_(g.narrow(dim, lo + n + i, 1))
    return out


class _DeterministicEdgePad(torch.autograd.Function):
    """``F.pad(mode="replicate")`` forward; a backward that adds the border
    onto the edge in a fixed order. The CUDA backward of ``F.pad`` accumulates
    with atomics, which PyTorch's deterministic mode (the train step runs in
    it) refuses."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, pads) -> torch.Tensor:
        ctx.pads = pads
        return _replicate(x, pads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        top, bottom, left, right = ctx.pads
        g = _fold_edges(_fold_edges(g, top, bottom, 1), left, right, 2)
        return g, None


def edge_pad(x: torch.Tensor, pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """Edge-pad the H and W axes of an NHWC tensor by (top, bottom, left,
    right). A pad that autograd will differentiate takes
    :class:`_DeterministicEdgePad`."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _DeterministicEdgePad.apply(x, tuple(pads))
    return _replicate(x, pads)


# ---------------------------------------------------------------------
# nearest-up(2x) + reflect-pad(1) + 3x3 conv, in phase form
# ---------------------------------------------------------------------

# _UP_MAP[pr, a, o] = 1 where coarse tap a feeds 3x3 kernel row offset o of
# output row phase pr: output row 2i+pr reads upsampled rows 2i+pr-1 ..
# 2i+pr+1, i.e. coarse rows (i-1, i, i) for pr=0 and (i, i, i+1) for pr=1,
# the window starting at coarse row i-1+pr. Columns alike.
_UP_MAP = np.zeros((2, 2, 3), np.float32)  # [phase, tap a, offset o]
_UP_MAP[0, 0, 0] = 1.0
_UP_MAP[0, 1, 1] = _UP_MAP[0, 1, 2] = 1.0
_UP_MAP[1, 0, 0] = _UP_MAP[1, 0, 1] = 1.0
_UP_MAP[1, 1, 2] = 1.0


def build_up_kernel(k3: torch.Tensor) -> torch.Tensor:
    """[3, 3, Cin, Cout] -> [2, 2, Cin, 4*Cout] phase window kernel, in
    ``k3``'s dtype: the 1-4 taps of each entry are summed in f32 and rounded
    once, as the JAX build folds a bf16 kernel's taps."""
    cin, cout = k3.shape[2:]
    # [pc, b, pr, a, ci, co]
    kp = _contract("up", _contract("up", _wide(k3), 0), 2)
    kp = kp.permute(3, 1, 4, 2, 0, 5)  # [a, b, ci, pr, pc, co]
    return kp.reshape(2, 2, cin, 4 * cout).to(k3.dtype)


def _align_phases(win: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Window-conv output [B, h+1, w+1, 4*C] -> aligned phase tensor
    [B, h, w, 4*C]: output phase (pr, pc) at coarse (i, j) is the window at
    (i + pr, j + pc). One concatenation of four strided slices."""
    c = win.shape[-1] // 4
    blocks = []
    for pr in (0, 1):
        for pc in (0, 1):
            p = 2 * pr + pc
            blocks.append(win[:, pr: h + pr, pc: w + pc, p * c: (p + 1) * c])
    return torch.cat(blocks, dim=-1)


def upsample2x_window(x: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """:func:`upsample2x_conv_phase` with the phase kernel built: ``kp``
    OIHW [4*Cout, Cin, 2, 2] in ``x``'s dtype.

    Border rule: reflect-padding the 2x-upsampled map by 1 duplicates the
    first/last coarse row/col, i.e. EDGE padding of the coarse input."""
    h, w = x.shape[1:3]
    win = _conv(edge_pad(x, (1, 1, 1, 1)), kp)  # [B, h+1, w+1, 4*Cout]
    return _align_phases(win, h, w)


def upsample2x_conv_phase(x: torch.Tensor, k3: torch.Tensor) -> torch.Tensor:
    """Exact ``nearest-up(2x); reflect-pad(1); 3x3 VALID conv`` of x with
    kernel ``k3`` [3, 3, Cin, Cout], returned as a PHASE tensor
    [B, h, w, 4*Cout] (no bias, no cast: callers handle both)."""
    return upsample2x_window(x, oihw(build_up_kernel(k3).to(x.dtype)))


# ---------------------------------------------------------------------
# reflect-pad(3) + 7x7 conv over a phase-form input, in phase form
# ---------------------------------------------------------------------

def _head_map() -> np.ndarray:
    """[a, pi, po, r] = 1 where coarse tap a at input phase pi feeds row r
    of the 7x7 kernel for output phase po: r = 2a + pi + po - 1 (rows
    outside [0, 6] have zero weight)."""
    m = np.zeros((4, 2, 2, 7), np.float32)
    for a in range(4):
        for pi in range(2):
            for po in range(2):
                r = 2 * a + pi + po - 1
                if 0 <= r <= 6:
                    m[a, pi, po, r] = 1.0
    return m


_HEAD_MAP = _head_map()


def build_head_kernel(k7: torch.Tensor) -> torch.Tensor:
    """[7, 7, Cin, Cout] -> [4, 4, 4*Cin, 4*Cout] phase window kernel.

    Entry [a, b, (pi_r, pi_c, ci), (po_r, po_c, co)] is
    k7[2a + pi_r + po_r - 1, 2b + pi_c + po_c - 1, ci, co] (out-of-range
    rows/cols are zero): with the output-phase window starting at coarse row
    i - 2 + po_r, the coarse tap a at input phase pi_r holds full-res row
    2(i - 2 + po_r + a) + pi_r, whose offset into the reflect-padded 7x7
    receptive field of output row 2i + po_r is 2a + pi_r + po_r - 1."""
    cin, cout = k7.shape[2:]
    # [b, pc_i, pc_o, a, pr_i, pr_o, ci, co]
    kp = _contract("head", _contract("head", _wide(k7), 0), 3)
    kp = kp.permute(3, 0, 4, 1, 6, 5, 2, 7)  # [a, b, pi_r, pi_c, ci, po..]
    return kp.reshape(4, 4, 4 * cin, 4 * cout).to(k7.dtype)


def _head_pad_axis(p: torch.Tensor, axis: int, phase_axis_stride: int,
                   c: int) -> torch.Tensor:
    """Pad a phase tensor by 2 along ``axis`` with the phase-form image of a
    full-res reflect-pad(3).

    With P[i, pr] holding full row 2i+pr and fpad[-k] = f[k]:
      Ppad[-2]  = pr=0 <- P[2, pr=0] (zero-tap filler), pr=1 <- P[1, pr=1]
      Ppad[-1]  = pr=0 <- P[1, pr=0], pr=1 <- P[0, pr=1]
      Ppad[h]   = pr=0 <- P[h-1, pr=0], pr=1 <- P[h-2, pr=1]
      Ppad[h+1] = pr=0 <- P[h-2, pr=0], pr=1 <- P[h-3, pr=1] (filler)
    Rows outside [0, h-1] clip to it (tiny maps).

    ``phase_axis_stride``: how many channels a phase step along ``axis``
    spans (2*c for the row axis, c for the col axis: layout p = 2*pr + pc)."""
    n = p.shape[axis]

    def take(i):
        i = int(np.clip(i, 0, n - 1))
        return p.narrow(axis, i, 1)

    nblk = p.shape[-1] // (2 * phase_axis_stride)  # (phase 0, phase 1) pairs
    s = phase_axis_stride

    def mix(i0, i1):
        """One pad row: phase-0 blocks from row i0, phase-1 from i1."""
        a, b = take(i0), take(i1)
        parts = []
        for k in range(nblk):
            lo = 2 * k * s
            parts += [a[..., lo: lo + s], b[..., lo + s: lo + 2 * s]]
        return torch.cat(parts, dim=-1)

    top = [mix(2, 1), mix(1, 0)]                    # Ppad[-2], Ppad[-1]
    bot = [mix(n - 1, n - 2), mix(n - 2, n - 3)]    # Ppad[n], Ppad[n+1]
    return torch.cat(top + [p] + bot, dim=axis)


def head_window(p: torch.Tensor, kp: torch.Tensor,
                emit_phase: bool = False) -> torch.Tensor:
    """:func:`head_conv_phase` with the phase kernel built: ``kp`` OIHW
    [4*Cout, 4*Cin, 4, 4] in ``p``'s dtype."""
    h, w, c4 = p.shape[1:]
    cin = c4 // 4
    # A row phase step spans 2*Cin channels, a col phase step Cin (the
    # (pc=0, pc=1) pair repeats for each row phase).
    ppad = _head_pad_axis(p, 1, 2 * cin, cin)
    ppad = _head_pad_axis(ppad, 2, cin, cin)
    win = _conv(ppad, kp)  # [B, h+1, w+1, 4*Cout]
    aligned = _align_phases(win, h, w)
    return aligned if emit_phase else depth_to_space2(aligned)


def head_conv_phase(p: torch.Tensor, k7: torch.Tensor,
                    emit_phase: bool = False) -> torch.Tensor:
    """Exact ``reflect-pad(3); 7x7 VALID conv`` of the full-res map held by
    phase tensor ``p`` [B, h, w, 4*Cin] with kernel ``k7`` [7, 7, Cin, Cout]:
    the FULL-RES output [B, 2h, 2w, Cout] (no bias, no cast), or the aligned
    PHASE tensor [B, h, w, 4*Cout] when ``emit_phase`` (for a phase-aware
    consumer: the stem -> first-downsample chain)."""
    return head_window(p, oihw(build_head_kernel(k7).to(p.dtype)),
                       emit_phase)


# ---------------------------------------------------------------------
# reflect-pad(1) + 3x3 stride-2 conv over a phase-form input
# ---------------------------------------------------------------------

def _down_map() -> np.ndarray:
    """[a, pi, r] = 1 where coarse tap a at input phase pi feeds kernel row
    r = 2a + pi - 1 (r = -1 has zero weight)."""
    m = np.zeros((2, 2, 3), np.float32)
    for a in range(2):
        for pi in range(2):
            if 2 * a + pi >= 1:
                m[a, pi, 2 * a + pi - 1] = 1.0
    return m


_DOWN_MAP = _down_map()
_TABLES = {"up": _UP_MAP, "head": _HEAD_MAP, "down": _DOWN_MAP}


def build_down_kernel(k3: torch.Tensor) -> torch.Tensor:
    """[3, 3, Cin, Cout] -> [2, 2, 4*Cin, Cout] phase window kernel for a
    stride-2 conv consuming a phase tensor.

    The stride-2 output at coarse (i, j) reads full-res rows 2i-1 .. 2i+1
    (after reflect-pad(1)). Coarse tap a of a 2x2 window anchored at coarse
    row i-1 holds, at input phase pi_r, full row 2(i-1+a) + pi_r, i.e.
    kernel row 2a + pi_r - 1."""
    cin, cout = k3.shape[2:]
    # [b, pc, a, pr, ci, co]
    kp = _contract("down", _contract("down", _wide(k3), 0), 2)
    kp = kp.permute(2, 0, 3, 1, 4, 5)  # [a, b, pi_r, pi_c, ci, co]
    return kp.reshape(2, 2, 4 * cin, cout).to(k3.dtype)


def down2x_window(p: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """:func:`down2x_conv_phase` with the phase kernel built: ``kp`` OIHW
    [Cout, 4*Cin, 2, 2] in ``p``'s dtype.

    Border rule: the stride-2 output reads one pad row/col, at the top/left;
    the full-res reflect-pad(1) there is f[-1] = f[1], the pr=1 block of
    coarse row 0, which EDGE-padding the phase tensor supplies (the pr=0
    block of the pad row has zero weight).

    Served (nothing to differentiate), the conv runs one batch row at a
    time: on an H100 cuDNN takes another kernel for this conv at batch 1-2
    than at batch 4 and up, whose f32 sums round to other bf16 values, and
    a row must not depend on its batch (sharded serving is held bit-equal to
    one process)."""
    pp = edge_pad(p, (1, 0, 1, 0))
    if pp.shape[0] == 1 or (torch.is_grad_enabled()
                            and (pp.requires_grad or kp.requires_grad)):
        return _conv(pp, kp)
    return torch.cat([_conv(row, kp) for row in pp.split(1)])


def down2x_conv_phase(p: torch.Tensor, k3: torch.Tensor) -> torch.Tensor:
    """Exact ``reflect-pad(1); 3x3 stride-2 VALID conv`` of the full-res map
    held by phase tensor ``p`` [B, h, w, 4*Cin] with kernel ``k3``
    [3, 3, Cin, Cout]: [B, h, w, Cout] (no bias, no cast)."""
    return down2x_window(p, oihw(build_down_kernel(k3).to(p.dtype)))
