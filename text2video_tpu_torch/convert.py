"""Flax parameter trees -> state_dicts of the port's modules, and a whole
JAX ``TrainerState`` -> the port's.

The generator's flax tree (``CompositeGenerator.init`` or a checkpoint,
leaves as numpy) is laid out as::

    GlobalTrunk_0/ConvBlock_0                  stem (7x7)
    GlobalTrunk_0/ConvBlock_{1..n_down}        stride-2 downsamples
    GlobalTrunk_0/ResBlock_k/ConvBlock_{0,1}   resblock convs
    GlobalTrunk_0/Upsample_k/ConvBlock_0       upsample convs
    heads/{kernel,bias}                        merged 7x7 heads

with every ConvBlock holding ``Conv_0/{kernel,bias}`` and
``InstanceNorm_0/{scale,bias}``. The phase form and the fused form of the
JAX generator share this tree, and so do the port's phase and plain forms
(``CompositeGenerator(phase_form=...)``): one mapping serves every variant.
With local enhancers the top level also holds, for the j-th stage in the
order the stages run (the coarsest first), ``ConvBlock_{2j}`` (7x7 stem),
``ConvBlock_{2j+1}`` (stride 2), ``Conv_j`` (the 3x3 conv on the coarser
feature), ``ResBlock_{j*n .. j*n+n-1}`` and ``Upsample_j``.
Kernels stay HWIO float32: the port keeps the flax layout.

A tree from before the heads were merged (``img_head``, ``flow_head``,
``mask_head``) is upgraded first (:func:`migrate_generator_params`).

Nothing here imports JAX: the trees come in as mappings of numpy-convertible
leaves, and the optimizer state is read by attribute (``g_opt[0].mu``).
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
        # A copy: the leaf may be a read-only view of a JAX buffer, and an
        # optimizer updates its moments in place.
        out[f"{prefix}.{leaf}"] = torch.from_numpy(
            np.array(node[leaf], dtype=np.float32))


def _conv_block(prefix: str, node: Mapping[str, Any],
                out: Dict[str, torch.Tensor]) -> None:
    _expect(node, ("Conv_0", "InstanceNorm_0"), prefix)
    _leaves(f"{prefix}.conv", node["Conv_0"], ("kernel", "bias"), out)
    _leaves(f"{prefix}.norm", node["InstanceNorm_0"], ("scale", "bias"), out)


def _res_block(prefix: str, node: Mapping[str, Any],
               out: Dict[str, torch.Tensor]) -> None:
    _expect(node, ("ConvBlock_0", "ConvBlock_1"), prefix)
    for j in (0, 1):
        _conv_block(f"{prefix}.block{j}", node[f"ConvBlock_{j}"], out)


def _local_enhancers(p: Mapping[str, Any],
                     out: Dict[str, torch.Tensor]) -> None:
    """The top-level entries of the local enhancer stages (none without)."""
    names = [n for n in p if n not in ("GlobalTrunk_0", "heads")]
    n_local = sum(1 for n in names if re.fullmatch(r"Upsample_\d+", n))
    n_res = sum(1 for n in names if re.fullmatch(r"ResBlock_\d+", n))
    if names and (n_local == 0 or n_res % n_local):
        raise KeyError(f"unmapped flax entries {sorted(names)}")
    n_blocks = n_res // n_local if n_local else 0
    for name in names:
        m = re.fullmatch(r"(ConvBlock|Conv|ResBlock|Upsample)_(\d+)", name)
        if m is None:
            raise KeyError(f"unmapped flax entry {name}")
        kind, i = m.group(1), int(m.group(2))
        node = p[name]
        if kind == "ConvBlock" and i < 2 * n_local:
            _conv_block(f"local.{i // 2}." + ("down" if i % 2 else "stem"),
                        node, out)
        elif kind == "Conv" and i < n_local:
            _leaves(f"local.{i}.merge", node, ("kernel", "bias"), out)
        elif kind == "ResBlock":
            _res_block(f"local.{i // n_blocks}.res.{i % n_blocks}", node, out)
        elif kind == "Upsample" and i < n_local:
            _expect(node, ("ConvBlock_0",), name)
            _conv_block(f"local.{i}.up.block", node["ConvBlock_0"], out)
        else:
            raise KeyError(f"unmapped flax entry {name}")


def migrate_generator_params(g_params: Mapping[str, Any]) -> Mapping[str, Any]:
    """Upgrade generator params from before the heads were merged: the
    separate img/flow/mask 7x7 head convs concatenate (on the output-channel
    axis) into the single ``heads`` conv, which computes the same function.
    A current tree passes through; the older two-branch encoder raises."""
    p = g_params["params"] if "params" in g_params else g_params
    trunk = p.get("GlobalTrunk_0", {})
    if "ConvBlock_1" in trunk and "Conv_0" in trunk.get("ConvBlock_1", {}):
        k1 = np.shape(trunk["ConvBlock_0"]["Conv_0"]["kernel"])
        k2 = np.shape(trunk["ConvBlock_1"]["Conv_0"]["kernel"])
        if (len(k1) == 4 and len(k2) == 4 and k1[:2] == (7, 7)
                and k2[:2] == (7, 7)):
            raise ValueError(
                "checkpoint uses the legacy two-branch encoder; it cannot "
                "be migrated exactly to the single-encoder generator — "
                "retrain (train-gan) to produce a current checkpoint")
    if "img_head" not in p:
        return g_params
    old = ("img_head", "flow_head", "mask_head")
    new = {k: v for k, v in p.items() if k not in old}
    new["heads"] = {
        "kernel": np.concatenate(
            [np.asarray(p[k]["kernel"]) for k in old], axis=-1),
        "bias": np.concatenate([np.asarray(p[k]["bias"]) for k in old]),
    }
    return {"params": new} if "params" in g_params else new


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax CompositeGenerator params (with or without the top-level
    ``"params"`` key) -> state_dict for
    :class:`text2video_tpu_torch.models.generator.CompositeGenerator`.
    A tree with separate head convs is migrated first. Raises KeyError on
    any entry it cannot place."""
    tree = migrate_generator_params(tree)
    p = tree.get("params", tree)
    if "GlobalTrunk_0" not in p or "heads" not in p:
        raise KeyError(f"params: flax entries {sorted(p)}, expected "
                       "GlobalTrunk_0 and heads")
    out: Dict[str, torch.Tensor] = {}
    _local_enhancers(p, out)
    for name, node in p["GlobalTrunk_0"].items():
        m = re.fullmatch(r"(ConvBlock|ResBlock|Upsample)_(\d+)", name)
        if m is None:
            raise KeyError(f"unmapped flax entry GlobalTrunk_0/{name}")
        kind, i = m.group(1), int(m.group(2))
        if kind == "ConvBlock":
            prefix = "trunk.stem" if i == 0 else f"trunk.down.{i - 1}"
            _conv_block(prefix, node, out)
        elif kind == "ResBlock":
            _res_block(f"trunk.res.{i}", node, out)
        else:
            _expect(node, ("ConvBlock_0",), name)
            _conv_block(f"trunk.up.{i}.block", node["ConvBlock_0"], out)
    _leaves("heads", p["heads"], ("kernel", "bias"), out)
    return out


def discriminator_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax MultiscaleDiscriminator params -> state_dict for
    :class:`text2video_tpu_torch.models.discriminator.MultiscaleDiscriminator`.
    A tower ``scale{i}`` holds ``Conv_0 .. Conv_{n+1}`` (the last one the
    logits) and ``InstanceNorm_0 .. InstanceNorm_{n-1}``."""
    p = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    for scale, tower in p.items():
        if re.fullmatch(r"scale\d+", scale) is None:
            raise KeyError(f"unmapped flax entry {scale}")
        n_convs = sum(1 for n in tower if n.startswith("Conv_"))
        _expect(tower, [f"Conv_{i}" for i in range(n_convs)]
                + [f"InstanceNorm_{i}" for i in range(n_convs - 2)], scale)
        for i in range(n_convs):
            name = (f"{scale}.logits" if i == n_convs - 1
                    else f"{scale}.convs.{i}")
            _leaves(name, tower[f"Conv_{i}"], ("kernel", "bias"), out)
        for i in range(n_convs - 2):
            _leaves(f"{scale}.norms.{i}", tower[f"InstanceNorm_{i}"],
                    ("scale", "bias"), out)
    return out


def vgg_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax VGG19Features params -> state_dict for
    :class:`text2video_tpu_torch.models.vgg.VGG19Features`."""
    out: Dict[str, torch.Tensor] = {}
    for name, node in tree.get("params", tree).items():
        if re.fullmatch(r"conv\d_\d", name) is None:
            raise KeyError(f"unmapped flax entry {name}")
        _leaves(name, node, ("kernel", "bias"), out)
    return out


def _load_adam(opt: torch.optim.Adam, named_params, scale_by_adam,
               convert) -> None:
    """Fill a torch Adam's state from optax's ``ScaleByAdamState``
    (``count``, ``mu``, ``nu``; the moments are trees shaped like the
    parameters, so ``convert`` maps them the way it maps parameters)."""
    mu, nu = convert(scale_by_adam.mu), convert(scale_by_adam.nu)
    count = float(np.asarray(scale_by_adam.count))
    for name, p in named_params:
        opt.state[p] = {
            "step": torch.tensor(count),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device),
        }


def trainer_state_from_flax(state: Any, cfg, device=None):
    """A JAX ``TrainerState`` (``step``, ``g_params``, ``d_params``,
    ``vgg_params``, ``g_opt``, ``d_opt`` of ``optax.adam``) -> the port's
    :class:`text2video_tpu_torch.train.trainer.TrainerState` for ``cfg`` (the
    port's ``TrainConfig`` with the same fields), on ``device``: parameters,
    Adam moments and counts, and the step, so both packages take the same
    next step."""
    from text2video_tpu_torch.train.trainer import create_trainer_state

    def discs_from_flax(d_tree):
        return {f"{key}.{k}": v for key, tree in d_tree.items()
                for k, v in discriminator_from_flax(tree).items()}

    vgg_params = (vgg_from_flax(state.vgg_params)
                  if cfg.use_vgg and state.vgg_params is not None else None)
    out = create_trainer_state(cfg, vgg_params=vgg_params, device=device)
    out.step = int(np.asarray(state.step))
    out.generator.load_state_dict(params_from_flax(state.g_params),
                                  strict=True)
    out.discriminators.load_state_dict(discs_from_flax(state.d_params),
                                       strict=True)
    _load_adam(out.g_opt, out.generator.named_parameters(), state.g_opt[0],
               params_from_flax)
    _load_adam(out.d_opt, out.discriminators.named_parameters(),
               state.d_opt[0], discs_from_flax)
    return out
