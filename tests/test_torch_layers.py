"""The port's layers against the flax layers, f32, same parameters."""

import numpy as np
import pytest
import torch

from text2video_tpu_torch.models import layers as tl

torch.set_num_threads(1)

ATOL = 2e-5


def _params_to_module(module, tree, mapping):
    """Load flax leaves into a torch module: mapping flax path -> torch name."""
    sd = {}
    for fpath, tname in mapping.items():
        node = tree["params"]
        for key in fpath.split("/"):
            node = node[key]
        sd[tname] = torch.as_tensor(np.asarray(node, np.float32))
    module.load_state_dict(sd, strict=True)
    return module


def _conv_block_map(fprefix, tprefix):
    pre = f"{fprefix}/" if fprefix else ""
    return {
        f"{pre}Conv_0/kernel": f"{tprefix}conv.kernel",
        f"{pre}Conv_0/bias": f"{tprefix}conv.bias",
        f"{pre}InstanceNorm_0/scale": f"{tprefix}norm.scale",
        f"{pre}InstanceNorm_0/bias": f"{tprefix}norm.bias",
    }


def _randomize(tree, rng):
    """Non-trivial biases / norm affines so every parameter matters."""
    import jax

    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * rng.randn(*v.shape).astype(np.float32),
        tree,
    )


def test_reflect_pad_matches_jax():
    import jax.numpy as jnp

    from text2video_tpu.models.layers import reflect_pad

    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    for pad in (0, 1, 3):
        ref = np.asarray(reflect_pad(jnp.asarray(x), pad))
        out = tl.reflect_pad(torch.from_numpy(x), pad).numpy()
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (7, 1)])
def test_conv_block_matches_flax(kernel, stride):
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.layers import ConvBlock

    rng = np.random.RandomState(kernel + stride)
    x = rng.randn(2, 12, 16, 5).astype(np.float32)
    ref_mod = ConvBlock(8, kernel=kernel, stride=stride, dtype=jnp.float32)
    tree = _randomize(ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(ref_mod.apply(tree, jnp.asarray(x)))
    mod = tl.ConvBlock(5, 8, kernel=kernel, stride=stride, dtype=torch.float32)
    _params_to_module(mod, tree, _conv_block_map("", ""))
    out = mod(torch.from_numpy(x)).detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_instance_norm_matches_flax():
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.layers import InstanceNorm

    rng = np.random.RandomState(3)
    x = (rng.randn(2, 6, 10, 8) * 3 + 1).astype(np.float32)
    ref_mod = InstanceNorm(dtype=jnp.float32)
    tree = _randomize(ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(ref_mod.apply(tree, jnp.asarray(x)))
    mod = tl.InstanceNorm(8, dtype=torch.float32)
    _params_to_module(mod, tree, {"scale": "scale", "bias": "bias"})
    out = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_resblock_matches_flax(fused):
    """The port's ResBlock, through the fused conv + statistics op (its plain
    version here) and through the plain conv + InstanceNorm, against the JAX
    form of the same name, ResBlock(fused=True/False)."""
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.layers import ResBlock

    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 12, 64).astype(np.float32)
    ref_mod = ResBlock(64, dtype=jnp.float32, fused=fused)
    tree = _randomize(ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(ref_mod.apply(tree, jnp.asarray(x)))
    mod = tl.ResBlock(64, dtype=torch.float32, fused=fused)
    mapping = {}
    for j in (0, 1):
        mapping.update(_conv_block_map(f"ConvBlock_{j}", f"block{j}."))
    _params_to_module(mod, tree, mapping)
    with torch.no_grad():  # the fused op refuses a graph that needs grad
        out = mod(torch.from_numpy(x)).numpy()
        other = tl.ResBlock(64, dtype=torch.float32, fused=not fused)
        other.load_state_dict(mod.state_dict(), strict=True)
        np.testing.assert_allclose(other(torch.from_numpy(x)).numpy(), out,
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_upsample_matches_flax():
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.layers import Upsample

    rng = np.random.RandomState(5)
    x = rng.randn(1, 6, 8, 16).astype(np.float32)
    ref_mod = Upsample(8, dtype=jnp.float32)
    tree = _randomize(ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(ref_mod.apply(tree, jnp.asarray(x)))
    mod = tl.Upsample(16, 8, dtype=torch.float32)
    _params_to_module(mod, tree, _conv_block_map("ConvBlock_0", "block."))
    out = mod(torch.from_numpy(x)).detach().numpy()
    assert out.shape == (1, 12, 16, 8)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_conv_init_is_seeded_lecun_normal():
    conv = tl.Conv(64, 32, kernel=3, dtype=torch.float32)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    k0 = conv.kernel.detach().clone()
    conv.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(k0, conv.kernel)
    std = (1.0 / (9 * 64)) ** 0.5
    assert abs(k0.std().item() - std) < 0.05 * std
    assert k0.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert not conv.bias.detach().any()


@pytest.mark.parametrize("kernel,stride,padding,hw", [
    (3, 1, 1, (9, 12)), (4, 2, 2, (9, 12)), (4, 1, 2, (6, 7))])
def test_zero_padded_conv_matches_flax(kernel, stride, padding, hw):
    """``Conv(padding=p)`` is flax's ``nn.Conv`` with explicit zero padding
    (``SAME`` for the 3x3; the discriminators' 4x4 with pad 2)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(6)
    x = rng.randn(2, *hw, 5).astype(np.float32)
    ref_mod = nn.Conv(7, (kernel, kernel), strides=(stride, stride),
                      padding=((padding, padding), (padding, padding)))
    tree = _randomize(ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(ref_mod.apply(tree, jnp.asarray(x)))
    mod = tl.Conv(5, 7, kernel=kernel, stride=stride, dtype=torch.float32,
                  padding=padding)
    _params_to_module(mod, tree, {"kernel": "kernel", "bias": "bias"})
    out = mod(torch.from_numpy(x)).detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_conv_under_grad_casts_the_live_parameter():
    """bf16 compute, f32 masters: under grad the gradient reaches the
    parameter itself; without grad the cached detached copy serves, and
    both give the same values."""
    conv = tl.Conv(8, 16, kernel=3, dtype=torch.bfloat16)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(
        np.random.RandomState(7).randn(1, 6, 8, 8).astype(np.float32))
    assert conv.trains()
    y = conv(x)
    assert y.dtype == torch.bfloat16 and y.requires_grad
    y.float().square().mean().backward()
    for p in (conv.kernel, conv.bias):
        assert p.grad is not None and p.grad.dtype == torch.float32
        assert p.grad.abs().sum() > 0
    with torch.no_grad():
        assert not conv.trains()
        assert torch.equal(conv(x), y.detach())
    conv.requires_grad_(False)
    assert not conv.trains() and not conv(x).requires_grad
