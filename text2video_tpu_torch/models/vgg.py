"""VGG19 feature extractor for the perceptual loss (counterpart of
``text2video_tpu/models/vgg.py``).

The VGG19 convolutional stack, returning the relu{1..5}_1 activations.
Pretrained weights are not part of the repository: :func:`load_params` reads
an ``.npz`` of conv kernels and biases where the user has one (keys
``conv{i}_{j}/kernel`` HWIO, ``conv{i}_{j}/bias``), and :func:`init_params`
gives a network of seeded random filters, a documented fallback ("A Powerful
Generative Model Using Random Weights", He et al. 2016): the loss still
measures multi-scale structural agreement, less semantically weighted.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from text2video_tpu_torch.models.layers import Conv

# (block, convs in the block, channels) of VGG19's five conv stages.
_STAGES: Sequence[Tuple[int, int, int]] = (
    (1, 2, 64),
    (2, 2, 128),
    (3, 4, 256),
    (4, 4, 512),
    (5, 4, 512),
)

# ImageNet normalisation (inputs arrive in [-1, 1]).
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class VGG19Features(nn.Module):
    """[B, H, W, 3] in [-1, 1] -> [relu1_1, relu2_1, relu3_1, relu4_1,
    relu5_1], NHWC in the compute dtype. The filters are fixed: its
    parameters do not require grad."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for block, n_convs, ch in _STAGES:
            for j in range(1, n_convs + 1):
                setattr(self, f"conv{block}_{j}",
                        Conv(cin, ch, dtype=dtype, padding=1))
                cin = ch
        self.register_buffer("mean", torch.tensor(_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(_STD), persistent=False)
        self.requires_grad_(False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = ((x.float() + 1.0) * 0.5 - self.mean) / self.std
        x = x.to(self.dtype)
        feats: List[torch.Tensor] = []
        for block, n_convs, _ in _STAGES:
            for j in range(1, n_convs + 1):
                x = F.relu(getattr(self, f"conv{block}_{j}")(x))
                if j == 1:
                    feats.append(x)
            if block < 5:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return feats


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """``state_dict`` of a VGG19 with seeded lecun-normal filters and zero
    biases (f32, whatever dtype the module computes in)."""
    model = VGG19Features(dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def load_params(npz_path: str, seed: int = 0) -> Dict[str, torch.Tensor]:
    """``state_dict`` from an ``.npz`` of conv weights (kernel HWIO f32). A
    layer missing from the file keeps its random init."""
    params = init_params(seed)
    data = np.load(npz_path)
    for block, n_convs, _ in _STAGES:
        for j in range(1, n_convs + 1):
            name = f"conv{block}_{j}"
            if f"{name}/kernel" in data:
                params[f"{name}.kernel"] = torch.as_tensor(
                    data[f"{name}/kernel"].astype(np.float32))
                params[f"{name}.bias"] = torch.as_tensor(
                    data[f"{name}/bias"].astype(np.float32))
    return params
