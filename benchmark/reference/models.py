"""The pose2frame generator, its discriminators and losses, plain.

Written from the model's description: NHWC tensors at the boundary, HWIO
float32 kernels, every convolution a plain ``F.conv2d`` at full resolution
(reflect padding for the generator, zeros for the discriminators), instance
norm with float32 statistics, the flow warp as a bilinear gather clamped to
the border. No phase forms, no fused conv, no cast to a lower precision
unless a :class:`~benchmark.reference.lowp.Precision` asks for one.

Generator (pix2pixHD global trunk, vid2vid's composite output): a 7x7 stem
over [current + 2 previous label maps, 2 previous frames], 3 stride-2
downsamples, 9 residual blocks, 3 nearest-2x upsamples each followed by a
3x3 conv, and one 7x7 conv giving image (tanh), flow (x10 px) and occlusion
mask (sigmoid); frame = mask * image + (1 - mask) * warp(prev, flow), the
mask forced open on an utterance's first frame.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.lowp import Precision


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """NCHW conv over an HWIO kernel ``[k, k, cin, cout]`` and a bias."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, prec: Precision = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.prec = prec or Precision()
        self.kernel = nn.Parameter(torch.zeros(kernel, kernel, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.prec(self.kernel).permute(3, 2, 0, 1)
        y = F.conv2d(self.prec(x), w, stride=self.stride,
                     padding=self.padding)
        return y + self.bias[None, :, None, None]


class InstanceNorm(nn.Module):
    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale[None, :, None, None] + self.bias[None, :, None, None]


class ConvBlock(nn.Module):
    """Reflect pad -> conv -> instance norm -> ReLU (the ReLU optional)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 act: bool = True, prec: Precision = None):
        super().__init__()
        self.pad, self.act = kernel // 2, act
        self.conv = Conv(cin, cout, kernel, stride, prec=prec)
        self.norm = InstanceNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (self.pad,) * 4, mode="reflect")
        y = self.norm(self.conv(x))
        return F.relu(y) if self.act else y


class ResBlock(nn.Module):
    def __init__(self, ch: int, prec: Precision = None):
        super().__init__()
        self.block0 = ConvBlock(ch, ch, prec=prec)
        self.block1 = ConvBlock(ch, ch, act=False, prec=prec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block1(self.block0(x))


class Upsample(nn.Module):
    def __init__(self, cin: int, cout: int, prec: Precision = None):
        super().__init__()
        self.block = ConvBlock(cin, cout, prec=prec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(F.interpolate(x, scale_factor=2, mode="nearest"))


class GlobalTrunk(nn.Module):
    def __init__(self, cin: int, base_ch: int, n_down: int, n_blocks: int,
                 prec: Precision = None):
        super().__init__()
        ch = base_ch
        self.stem = ConvBlock(cin, ch, kernel=7, prec=prec)
        down = []
        for _ in range(n_down):
            down.append(ConvBlock(ch, 2 * ch, stride=2, prec=prec))
            ch *= 2
        self.down = nn.ModuleList(down)
        self.res = nn.ModuleList(ResBlock(ch, prec) for _ in range(n_blocks))
        up = []
        for _ in range(n_down):
            up.append(Upsample(ch, ch // 2, prec))
            ch //= 2
        self.up = nn.ModuleList(up)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for layer in (*self.down, *self.res, *self.up):
            x = layer(x)
        return x


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img [B, C, H, W], flow [B, 2, H, W] (dx, dy in pixels): output (y, x)
    samples img bilinearly at (y + dy, x + dx), the position clamped to the
    image."""
    b, c, h, w = img.shape
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    sx = torch.clamp(xx + flow[:, 0], 0.0, w - 1.0)
    sy = torch.clamp(yy + flow[:, 1], 0.0, h - 1.0)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[:, None], (sy - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    flat = img.reshape(b, c, h * w)

    def at(yi, xi):
        idx = (yi * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


class CompositeGenerator(nn.Module):
    """Inputs and outputs NHWC, as the program's: labels [B, H, W, 9],
    prev_imgs [B, H, W, 6], has_prev [B] -> (frame [B, H, W, 3], flow
    [B, H, W, 2], mask [B, H, W, 1])."""

    def __init__(self, in_channels: int = 15, base_ch: int = 64,
                 n_downsample: int = 3, n_blocks: int = 9,
                 flow_scale: float = 10.0, prec: Precision = None):
        super().__init__()
        self.flow_scale = flow_scale
        self.trunk = GlobalTrunk(in_channels, base_ch, n_downsample,
                                 n_blocks, prec)
        self.heads = Conv(base_ch, 6, kernel=7, prec=prec)

    def forward(self, labels, prev_imgs, has_prev
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = nchw(torch.cat([labels, prev_imgs], dim=-1).float())
        feat = self.trunk(x)
        heads = self.heads(F.pad(feat, (3, 3, 3, 3), mode="reflect"))
        raw = torch.tanh(heads[:, 0:3])
        flow = heads[:, 3:5] * self.flow_scale
        mask = torch.sigmoid(heads[:, 5:6])
        warped = flow_warp(nchw(prev_imgs[..., :3].float()), flow)
        hp = has_prev.float().reshape(-1, 1, 1, 1)
        mask = mask * hp + (1.0 - hp)
        frame = mask * raw + (1.0 - mask) * warped
        return nhwc(frame), nhwc(flow), nhwc(mask)


def downscale2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 average, stride 2, zero pad 1 counted in the average (NCHW)."""
    h, w = x.shape[2:]
    ho, wo = (h + 1) // 2, (w + 1) // 2
    xp = F.pad(x, (1, 1, 1, 1))
    acc = 0.0
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[:, :, dy: dy + 2 * ho - 1: 2, dx: dx + 2 * wo - 1: 2]
    return acc / 9.0


class PatchDiscriminator(nn.Module):
    """4x4 convs, zero pad 2, strides 2, 2, 2, 1, instance norm from the
    second conv on, leaky ReLU 0.2; a 4x4 logits conv. Returns (logits,
    [features]) NCHW."""

    def __init__(self, cin: int, base_ch: int = 64, n_layers: int = 3,
                 prec: Precision = None):
        super().__init__()
        convs, norms = [], []
        ch = base_ch
        for i in range(n_layers + 1):
            convs.append(Conv(cin, ch, 4, 2 if i < n_layers else 1, 2, prec))
            if i > 0:
                norms.append(InstanceNorm(ch))
            cin, ch = ch, min(ch * 2, 512)
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.logits = Conv(cin, 1, 4, 1, 2, prec)

    def forward(self, x: torch.Tensor):
        feats = []
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i > 0:
                x = self.norms[i - 1](x)
            x = F.leaky_relu(x, 0.2)
            feats.append(x)
        return self.logits(x), feats


class MultiscaleDiscriminator(nn.Module):
    def __init__(self, cin: int, num_d: int = 2, base_ch: int = 64,
                 prec: Precision = None):
        super().__init__()
        self.num_d = num_d
        for i in range(num_d):
            setattr(self, f"scale{i}", PatchDiscriminator(cin, base_ch,
                                                          prec=prec))

    def forward(self, x_nhwc: torch.Tensor) -> List:
        x = nchw(x_nhwc.float())
        outs = []
        for i in range(self.num_d):
            outs.append(getattr(self, f"scale{i}")(x))
            if i + 1 < self.num_d:
                x = downscale2x(x)
        return outs


def face_crop(imgs: torch.Tensor, centers: torch.Tensor,
              crop: int) -> torch.Tensor:
    """imgs [B, H, W, C], centers [B, 2] (x, y) -> [B, crop, crop, C]: the
    window around each centre (truncated to an integer), kept inside the
    image."""
    crops = []
    h, w = imgs.shape[1:3]
    for i in range(imgs.shape[0]):
        x0 = min(max(int(centers[i, 0]) - crop // 2, 0), w - crop)
        y0 = min(max(int(centers[i, 1]) - crop // 2, 0), h - crop)
        crops.append(imgs[i, y0: y0 + crop, x0: x0 + crop])
    return torch.stack(crops)


def lsgan_d(real, fake) -> torch.Tensor:
    loss = 0.0
    for (lr, _), (lf, _) in zip(real, fake):
        loss = loss + ((lr - 1.0) ** 2).mean() + (lf ** 2).mean()
    return 0.5 * loss


def lsgan_g(fake) -> torch.Tensor:
    return 0.5 * sum(((lf - 1.0) ** 2).mean() for lf, _ in fake)


def feature_matching(real, fake) -> torch.Tensor:
    terms = [(f - r.detach()).abs().mean()
             for (_, fr), (_, ff) in zip(real, fake) for r, f in zip(fr, ff)]
    return sum(terms) / max(len(terms), 1)


def flow_loss(flow, real_prev, real_cur, tv_weight: float = 0.01):
    """NHWC flow [N, H, W, 2]; the previous real frame warped onto the
    current one (L1) plus total variation of the flow."""
    warped = flow_warp(nchw(real_prev), nchw(flow))
    photo = (warped - nchw(real_cur)).abs().mean()
    tv = ((flow[:, 1:] - flow[:, :-1]).abs().mean()
          + (flow[:, :, 1:] - flow[:, :, :-1]).abs().mean())
    return photo + tv_weight * tv


def l1(a, b) -> torch.Tensor:
    return (a - b.detach()).abs().mean()
