"""Shared by ``test_torch_train.py`` and ``test_torch_train_variants.py``: one
JAX train step against the port's from the same converted ``TrainerState``
(see ``check_variant``). Not a test file itself: the variants are split over
two files so that the workers of a parallel run share the JAX compiles."""

import dataclasses

import numpy as np
import torch

from text2video_tpu_torch.convert import (
    discriminator_from_flax,
    params_from_flax,
    trainer_state_from_flax,
)
from text2video_tpu_torch.train import trainer as tt

torch.set_num_threads(1)

BASE = dict(height=32, width=32, face_crop=8, base_ch=8, n_blocks=1,
            d_base_ch=8, use_vgg=False)
CFG = tt.TrainConfig(**BASE, dtype=torch.float32)

# name -> (config overrides, clip length). At T=5 the stride-2 temporal D
# applies (its window spans 5 frames); at T=4 it is skipped.
VARIANTS = {
    "default": ({}, 5),
    "recon_pretrain": (dict(lambda_adv=0.0), 4),
    "grad_accum": (dict(grad_accum=2), 4),
    "bptt": (dict(bptt=True), 4),
    "mouth_l1": (dict(lambda_l1_mouth=10.0), 4),
    "random_vgg": (dict(use_vgg=True), 4),
    "reference_flow": (dict(flow_supervision="reference"), 4),
}


def _batch(b=2, t=4, seed=0, flow_gt=False):
    rng = np.random.RandomState(seed)
    out = {
        "labels": rng.rand(b, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "reals": rng.rand(b, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "face_centers": (rng.rand(b, t, 2) * 32).astype(np.float32),
    }
    if flow_gt:
        out["flow_gt"] = rng.randn(b, t - 1, 32, 32, 2).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state_and_step(overrides, seed=0):
    """A fresh JAX state and its jitted step. The heads kernel is scaled by
    0.1: lecun heads give flows of ~30 px, and the warp's gradient jumps
    wherever a sample position crosses a pixel, so float noise in such a
    flow changes gradients by whole percents in both packages."""
    import jax
    import jax.numpy as jnp

    from text2video_tpu.train import trainer as jt

    cfg = jt.TrainConfig(**dict(BASE, **overrides), dtype=jnp.float32)
    state = jt.create_trainer_state(cfg, seed=seed)
    g = jax.tree_util.tree_map(np.array, state.g_params)
    g["params"]["heads"]["kernel"] *= 0.1
    state = state.replace(g_params=jax.tree_util.tree_map(jnp.asarray, g))
    return state, jax.jit(jt.make_train_step(cfg))


def _jax_step(overrides, batch):
    """(state before, state after, metrics) of one JAX step, leaves as
    numpy."""
    state, step = _jax_state_and_step(overrides)
    new_state, metrics = step(state, batch)
    return _to_np(state), _to_np(new_state), {k: float(v)
                                              for k, v in metrics.items()}


# The flow loss's photometric term |warp(real_prev, flow) - real_cur| has a
# kink at 0. An element nearer to it than two lowerings' f32 noise (flows
# differ by up to ~1e-5) takes the gradient's sign from that noise and moves
# every G gradient by up to ~1e-2 of the largest. A batch held to the 1e-4
# gradient bound keeps every element this far from the kink.
KINK_MARGIN = 2e-5


def photometric_margin(before, batch, cfg=CFG) -> float:
    """The least |warp(real_prev, flow) - real_cur| of the flow loss over
    ``batch``, from the port's f32 forward of the generator of ``before``
    (a JAX ``TrainerState``, leaves as numpy)."""
    from text2video_tpu_torch.ops.warp import flow_warp

    state = trainer_state_from_flax(before, cfg, device="cpu")
    b = _torch_batch(batch)
    with torch.no_grad():
        _, flows = tt._generate_clip(state.generator, cfg, b["labels"],
                                     b["reals"])
    reals = b["reals"].float()
    hw = reals.shape[2:]
    d = (flow_warp(reals[:, :-1].reshape(-1, *hw),
                   flows[:, 1:].reshape(-1, *flows.shape[2:]))
         - reals[:, 1:].reshape(-1, *hw))
    return float(d.abs().min())


def _discs_from_flax(d_tree):
    return {f"{key}.{k}": v for key, tree in d_tree.items()
            for k, v in discriminator_from_flax(tree).items()}


def _check_grads(named_params, ref, what):
    """Each parameter's ``.grad`` against the JAX gradient, to 1e-4 of the
    tensor's largest gradient. A bias in front of an instance norm has a
    gradient of exactly zero (the norm subtracts it), which both packages
    compute as float noise of a few f32 ulps of the network's largest
    gradient: such a tensor is held to 1e-4 of a hundredth of that largest
    gradient instead."""
    named_params = list(named_params)
    floor = 1e-2 * max(float(ref[name].abs().max())
                       for name, _ in named_params)
    assert floor > 0, f"{what}: zero reference gradients"
    for name, p in named_params:
        r = ref[name]
        assert p.grad is not None, f"{what} {name}: no gradient"
        scale = max(float(r.abs().max()), floor)
        err = float((p.grad - r).abs().max())
        assert err <= 1e-4 * scale, f"{what} {name}: {err} vs max {scale}"


def _check_params(named_params, ref, lr, what):
    """After one Adam step: no element further than one step-1 sign flip
    (2 lr), and almost all equal (the sign noise of near-zero gradients that
    tests/test_train_step.py documents)."""
    diffs = torch.cat([(p.detach() - ref[name]).abs().ravel()
                       for name, p in named_params])
    assert float(diffs.max()) <= 2.5 * lr, f"{what}: {float(diffs.max())}"
    assert float((diffs > 1e-5).float().mean()) < 0.06, what


def check_variant(variant):
    """Losses, G and D gradients and the Adam update of one step, the port
    against JAX, for ``VARIANTS[variant]``."""
    overrides, t = VARIANTS[variant]
    batch = _batch(t=t, flow_gt=overrides.get("flow_supervision")
                   == "reference")
    before, after, ref_metrics = _jax_step(overrides, batch)
    cfg = dataclasses.replace(CFG, **overrides)
    state = trainer_state_from_flax(before, cfg, device="cpu")
    state, metrics = tt.make_train_step(cfg)(state, _torch_batch(batch))

    assert state.step == int(after.step) == 1
    assert set(metrics) == set(ref_metrics) == set(tt.METRICS)
    for k, ref in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), ref, rtol=2e-4,
                                   atol=1e-5, err_msg=k)
    # Adam's first moment after one step from zero is (1 - beta1) * grad.
    g_ref = {k: v / (1 - cfg.beta1)
             for k, v in params_from_flax(after.g_opt[0].mu).items()}
    _check_grads(state.generator.named_parameters(), g_ref, "G")
    _check_params(state.generator.named_parameters(),
                  params_from_flax(after.g_params), cfg.lr, "G")
    d_named = list(state.discriminators.named_parameters())
    d_after = _discs_from_flax(after.d_params)
    if cfg.lambda_adv > 0:
        d_ref = {k: v / (1 - cfg.beta1)
                 for k, v in _discs_from_flax(after.d_opt[0].mu).items()}
        if t < 5:  # the stride-2 temporal D saw no clip: no gradient
            unused = [n for n, _ in d_named if n.startswith("temporal2.")]
            assert unused and all(not d_ref[n].any() for n in unused)
            assert all(not p.grad.any() for n, p in d_named if n in unused)
            d_named = [(n, p) for n, p in d_named if n not in unused]
        _check_grads(d_named, d_ref, "D")
        _check_params(d_named, d_after, cfg.lr * cfg.d_lr_scale, "D")
    else:
        for k in ("g_adv", "g_fm", "d_loss"):
            assert float(metrics[k]) == 0.0 == ref_metrics[k]
        assert int(after.d_opt[0].count) == 0
        for name, p in d_named:  # untouched, and no gradient kept
            assert p.grad is None
            assert torch.equal(p.detach(), d_after[name]), name
        assert not state.d_opt.state_dict()["state"] or all(
            float(s["step"]) == 0
            for s in state.d_opt.state_dict()["state"].values())
