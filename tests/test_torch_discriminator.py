"""The port's discriminators, ``face_crop``, ``downscale2x`` and VGG19
features against the JAX functions, f32, converted parameters, inputs from a
numpy seed."""

import numpy as np
import pytest
import torch

from text2video_tpu_torch.convert import discriminator_from_flax, vgg_from_flax
from text2video_tpu_torch.models import discriminator as td
from text2video_tpu_torch.models import vgg as tvgg
from text2video_tpu_torch.models.layers import downscale2x

torch.set_num_threads(1)

ATOL = 1e-5  # f32 sums in another order


def _randomize(tree, rng):
    """Non-zero biases and norm affines, so a swapped leaf cannot go unseen."""
    import jax

    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.randn(*v.shape).astype(np.float32),
        tree)


@pytest.mark.parametrize("hw", [(32, 32), (33, 45), (17, 30)])
def test_downscale2x_matches_jax(hw):
    """The zero pad counts in the average, at even and odd sizes."""
    import jax.numpy as jnp

    from text2video_tpu.models.layers import downscale2x as jax_down

    x = np.random.RandomState(0).randn(2, *hw, 5).astype(np.float32)
    ref = np.asarray(jax_down(jnp.asarray(x)))
    out = downscale2x(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw,num_d", [((32, 32), 2), ((33, 45), 2),
                                      ((16, 19), 1)])
def test_multiscale_discriminator_matches_jax(hw, num_d):
    """Logits and every feature map of every scale; odd sizes exercise the
    4x4 convs' zero pad 2 at stride 2 and the pyramid's odd halves."""
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.discriminator import MultiscaleDiscriminator

    rng = np.random.RandomState(1)
    x = (rng.rand(2, *hw, 6) * 2 - 1).astype(np.float32)
    ref_mod = MultiscaleDiscriminator(num_d=num_d, base_ch=8,
                                      dtype=jnp.float32)
    tree = _randomize(jax.jit(ref_mod.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x)), rng)
    ref = jax.jit(ref_mod.apply)(tree, jnp.asarray(x))
    mod = td.MultiscaleDiscriminator(6, num_d=num_d, base_ch=8,
                                     dtype=torch.float32)
    sd = discriminator_from_flax(tree)
    assert len(sd) == len(jax.tree_util.tree_leaves(tree))
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    assert len(out) == len(ref) == num_d
    for (lo, fo), (lr, fr) in zip(out, ref):
        assert lo.dtype == torch.float32 and lo.shape[-1] == 1
        np.testing.assert_allclose(lo.numpy(), np.asarray(lr), atol=ATOL,
                                   rtol=0)
        assert len(fo) == len(fr) == 4
        for a, b in zip(fo, fr):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       rtol=0)
    with pytest.raises(KeyError):
        discriminator_from_flax({"params": {"tower0": {}}})


def test_discriminator_init_is_seeded_and_trains():
    """``reset_parameters`` is deterministic in its generator, and a backward
    reaches every parameter of every tower (bf16 compute, f32 masters)."""
    def make(seed):
        m = td.MultiscaleDiscriminator(6, num_d=2, base_ch=8,
                                       dtype=torch.bfloat16)
        m.reset_parameters(torch.Generator().manual_seed(seed))
        return m

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.scale0.logits.kernel, c.scale0.logits.kernel)
    x = torch.from_numpy(
        np.random.RandomState(2).rand(1, 32, 32, 6).astype(np.float32))
    sum(lo.float().square().mean() for lo, _ in a(x)).backward()
    for name, p in a.named_parameters():
        assert p.dtype == torch.float32
        assert p.grad is not None and p.grad.abs().sum() > 0, name


def test_face_crop_matches_jax_and_clamps_at_each_border():
    import jax.numpy as jnp

    from text2video_tpu.models.discriminator import face_crop as jax_crop

    rng = np.random.RandomState(3)
    h, w, crop = 20, 28, 8
    centers = np.asarray([
        [14.0, 10.0],    # inside
        [13.9, 9.2],     # truncated, not rounded
        [1.0, 10.0],     # left border
        [27.5, 10.0],    # right border
        [14.0, 0.5],     # top
        [14.0, 19.9],    # bottom
        [-6.0, -3.0],    # outside, top left
        [40.0, 33.0],    # outside, bottom right
    ], np.float32)
    imgs = rng.randn(len(centers), h, w, 3).astype(np.float32)
    ref = np.asarray(jax_crop(jnp.asarray(imgs), jnp.asarray(centers), crop))
    t_imgs = torch.from_numpy(imgs).requires_grad_()
    out = td.face_crop(t_imgs, torch.from_numpy(centers), crop)
    assert tuple(out.shape) == (len(centers), crop, crop, 3)
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    # Gradients flow to the cropped pixels only.
    out.sum().backward()
    assert t_imgs.grad.sum().item() == out.numel()
    assert set(np.unique(t_imgs.grad.numpy())) == {0.0, 1.0}


@pytest.mark.parametrize("hw", [(32, 32), (35, 50)])
def test_vgg_features_match_jax(hw):
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.vgg import VGG19Features

    rng = np.random.RandomState(4)
    x = (rng.rand(1, *hw, 3) * 2 - 1).astype(np.float32)
    ref_mod = VGG19Features(dtype=jnp.float32)
    tree = _randomize(jax.jit(ref_mod.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x)), rng)
    ref = jax.jit(ref_mod.apply)(tree, jnp.asarray(x))
    mod = tvgg.VGG19Features(dtype=torch.float32)
    mod.load_state_dict(vgg_from_flax(tree), strict=True)
    assert not any(p.requires_grad for p in mod.parameters())
    tx = torch.from_numpy(x).requires_grad_()
    out = mod(tx)
    assert len(out) == len(ref) == 5
    for a, b in zip(out, ref):
        assert tuple(a.shape) == b.shape
        scale = max(float(np.abs(np.asarray(b)).max()), 1.0)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL * scale, rtol=0)
    out[-1].sum().backward()  # the filters are fixed; the input gets grad
    assert tx.grad.abs().sum() > 0


def test_vgg_params_seeded_and_loaded_from_npz(tmp_path):
    a, b = tvgg.init_params(0), tvgg.init_params(0)
    assert a.keys() == b.keys() and len(a) == 32
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1_1.kernel"],
                           tvgg.init_params(1)["conv1_1.kernel"])
    assert a["conv5_4.kernel"].shape == (3, 3, 512, 512)
    k = np.random.RandomState(5).randn(3, 3, 3, 64).astype(np.float32)
    np.savez(tmp_path / "vgg.npz", **{"conv1_1/kernel": k,
                                      "conv1_1/bias": np.ones(64, np.float32)})
    loaded = tvgg.load_params(str(tmp_path / "vgg.npz"))
    np.testing.assert_array_equal(loaded["conv1_1.kernel"].numpy(), k)
    assert loaded["conv1_1.bias"].eq(1).all()
    assert torch.equal(loaded["conv1_2.kernel"], a["conv1_2.kernel"])
    tvgg.VGG19Features(torch.float32).load_state_dict(loaded, strict=True)
