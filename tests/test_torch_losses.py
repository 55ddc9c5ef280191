"""The port's training objectives against the JAX functions on the same
numpy inputs (relative 1e-5), and where each stops the gradient."""

import numpy as np
import pytest
import torch

from text2video_tpu_torch.models import losses as tl
from text2video_tpu_torch.ops.warp import flow_tv

torch.set_num_threads(1)

RTOL = 1e-5


def _disc_outs(rng, scales=2):
    """[(logits, [features])] per scale, as a MultiscaleDiscriminator
    returns them."""
    outs = []
    for s in range(scales):
        n = 9 - 3 * s
        outs.append((rng.randn(2, n, n, 1).astype(np.float32),
                     [rng.randn(2, n + i, n + i, 4 + i).astype(np.float32)
                      for i in range(3)]))
    return outs


def _to(outs, conv):
    return [(conv(lo), [conv(f) for f in fs]) for lo, fs in outs]


def _close(out, ref):
    np.testing.assert_allclose(float(out), float(ref), rtol=RTOL, atol=0)


def test_lsgan_and_feature_matching_match_jax():
    import jax.numpy as jnp

    from text2video_tpu.models import losses as jl

    rng = np.random.RandomState(0)
    real, fake = _disc_outs(rng), _disc_outs(rng)
    jr, jf = _to(real, jnp.asarray), _to(fake, jnp.asarray)
    tr, tf = _to(real, torch.from_numpy), _to(fake, torch.from_numpy)
    _close(tl.lsgan_d(tr, tf), jl.lsgan_d(jr, jf))
    _close(tl.lsgan_g(tf), jl.lsgan_g(jf))
    _close(tl.feature_matching(tr, tf), jl.feature_matching(jr, jf))
    assert tl.lsgan_d(tr, tf).dtype == torch.float32


def test_perceptual_and_l1_match_jax():
    import jax.numpy as jnp

    from text2video_tpu.models import losses as jl

    rng = np.random.RandomState(1)
    ff = [rng.randn(2, 8 - i, 8 - i, 4 * (i + 1)).astype(np.float32)
          for i in range(5)]
    fr = [rng.randn(*f.shape).astype(np.float32) for f in ff]
    _close(tl.perceptual([torch.from_numpy(f) for f in ff],
                         [torch.from_numpy(f) for f in fr]),
           jl.perceptual([jnp.asarray(f) for f in ff],
                         [jnp.asarray(f) for f in fr]))
    _close(tl.l1(torch.from_numpy(ff[0]), torch.from_numpy(fr[0])),
           jl.l1(jnp.asarray(ff[0]), jnp.asarray(fr[0])))


@pytest.mark.parametrize("n", [1, 5])
def test_flow_losses_match_jax(n):
    import jax.numpy as jnp

    from text2video_tpu.models import losses as jl
    from text2video_tpu.ops.warp import flow_tv as jax_tv

    rng = np.random.RandomState(2)
    flow = (rng.randn(n, 12, 16, 2) * 2).astype(np.float32)
    flow_gt = (rng.randn(n, 12, 16, 2) * 2).astype(np.float32)
    prev = (rng.rand(n, 12, 16, 3) * 2 - 1).astype(np.float32)
    cur = (rng.rand(n, 12, 16, 3) * 2 - 1).astype(np.float32)
    t = torch.from_numpy
    _close(flow_tv(t(flow)), jax_tv(jnp.asarray(flow)))
    _close(tl.flow_loss(t(flow), t(prev), t(cur)),
           jl.flow_loss(jnp.asarray(flow), jnp.asarray(prev),
                        jnp.asarray(cur)))
    _close(tl.flow_supervised_loss(t(flow), t(flow_gt)),
           jl.flow_supervised_loss(jnp.asarray(flow), jnp.asarray(flow_gt)))


def test_real_side_is_detached():
    """Feature matching, the perceptual loss and L1 send no gradient to
    their targets; LSGAN's D loss sends it to both sides; the flow loss
    differentiates the flow through the warp's blend weights."""
    rng = np.random.RandomState(3)

    def grad_leaves(outs):
        return _to(outs, lambda a: torch.from_numpy(a).requires_grad_())

    real, fake = grad_leaves(_disc_outs(rng)), grad_leaves(_disc_outs(rng))
    tl.feature_matching(real, fake).backward()
    assert all(f.grad is None for _, fs in real for f in fs)
    assert all(f.grad.abs().sum() > 0 for _, fs in fake for f in fs)
    tl.lsgan_d(real, fake).backward()
    assert all(lo.grad.abs().sum() > 0 for lo, _ in real + fake)

    a = torch.from_numpy(rng.randn(2, 6, 6, 3).astype(np.float32))
    b = a + 1.0
    a.requires_grad_(), b.requires_grad_()
    (tl.l1(a, b) + tl.perceptual([a], [b])).backward()
    assert b.grad is None and a.grad.abs().sum() > 0

    flow = torch.from_numpy(
        rng.randn(2, 6, 6, 2).astype(np.float32)).requires_grad_()
    prev = torch.from_numpy(rng.rand(2, 6, 6, 3).astype(np.float32))
    tl.flow_loss(flow, prev, prev.flip(1)).backward()
    assert flow.grad.abs().sum() > 0
