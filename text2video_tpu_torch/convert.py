"""Flax parameter tree -> state_dict of the port's CompositeGenerator.

The flax tree (``CompositeGenerator.init`` or a checkpoint, leaves as numpy)
is laid out as::

    GlobalTrunk_0/ConvBlock_0                  stem (7x7)
    GlobalTrunk_0/ConvBlock_{1..n_down}        stride-2 downsamples
    GlobalTrunk_0/ResBlock_k/ConvBlock_{0,1}   resblock convs
    GlobalTrunk_0/Upsample_k/ConvBlock_0       upsample convs
    heads/{kernel,bias}                        merged 7x7 heads

with every ConvBlock holding ``Conv_0/{kernel,bias}`` and
``InstanceNorm_0/{scale,bias}``. The phase form and the fused form of the
JAX generator share this tree, so one mapping serves every JAX variant.
Kernels stay HWIO float32: the port keeps the flax layout.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _expect(node: Mapping[str, Any], keys, where: str) -> None:
    if set(node) != set(keys):
        raise KeyError(f"{where}: flax entries {sorted(node)}, expected "
                       f"{sorted(keys)}")


def _leaves(prefix: str, node: Mapping[str, Any], keys,
            out: Dict[str, torch.Tensor]) -> None:
    _expect(node, keys, prefix)
    for leaf in keys:
        out[f"{prefix}.{leaf}"] = torch.as_tensor(
            np.asarray(node[leaf], dtype=np.float32))


def _conv_block(prefix: str, node: Mapping[str, Any],
                out: Dict[str, torch.Tensor]) -> None:
    _expect(node, ("Conv_0", "InstanceNorm_0"), prefix)
    _leaves(f"{prefix}.conv", node["Conv_0"], ("kernel", "bias"), out)
    _leaves(f"{prefix}.norm", node["InstanceNorm_0"], ("scale", "bias"), out)


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax CompositeGenerator params (with or without the top-level
    ``"params"`` key) -> state_dict for
    :class:`text2video_tpu_torch.models.generator.CompositeGenerator`.
    Raises KeyError on any entry it cannot place."""
    p = tree.get("params", tree)
    _expect(p, ("GlobalTrunk_0", "heads"), "params")
    out: Dict[str, torch.Tensor] = {}
    for name, node in p["GlobalTrunk_0"].items():
        m = re.fullmatch(r"(ConvBlock|ResBlock|Upsample)_(\d+)", name)
        if m is None:
            raise KeyError(f"unmapped flax entry GlobalTrunk_0/{name}")
        kind, i = m.group(1), int(m.group(2))
        if kind == "ConvBlock":
            prefix = "trunk.stem" if i == 0 else f"trunk.down.{i - 1}"
            _conv_block(prefix, node, out)
        elif kind == "ResBlock":
            _expect(node, ("ConvBlock_0", "ConvBlock_1"), name)
            for j in (0, 1):
                _conv_block(f"trunk.res.{i}.block{j}", node[f"ConvBlock_{j}"],
                            out)
        else:
            _expect(node, ("ConvBlock_0",), name)
            _conv_block(f"trunk.up.{i}.block", node["ConvBlock_0"], out)
    _leaves("heads", p["heads"], ("kernel", "bias"), out)
    return out
