"""conv3x3_stats (plain version, CPU) against JAX's conv3x3_stats (Pallas
kernel in interpret mode)."""

import numpy as np
import pytest
import torch

from text2video_tpu_torch.ops import fused_resblock as tfr

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "shape,kscale",
    [((2, 16, 24, 64), None), ((1, 12, 28, 128), 0.05),
     ((1, 8, 112, 128), 0.05), ((1, 4, 16, 128), 0.05)],
)
def test_conv3x3_stats_matches_jax(shape, kscale):
    import jax.numpy as jnp

    from text2video_tpu.ops.fused_resblock import conv3x3_stats

    rng = np.random.RandomState(sum(shape))
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, c, c) * (kscale or (1.0 / (9 * c)) ** 0.5)).astype(
        np.float32)
    b = rng.randn(c).astype(np.float32)
    y0, m0, v0 = (np.asarray(a) for a in conv3x3_stats(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    before = tfr.launches
    y, m, v = tfr.conv3x3_stats(*map(torch.from_numpy, (x, k, b)))
    assert tfr.launches == before  # a CPU tensor takes the plain version
    assert y.shape == shape and y.dtype == torch.float32
    assert m.shape == v.shape == (shape[0], c)
    np.testing.assert_allclose(y.numpy(), y0, atol=2e-5, rtol=0)
    np.testing.assert_allclose(m.numpy(), m0, atol=1e-4, rtol=0)
    np.testing.assert_allclose(v.numpy(), v0, atol=1e-4, rtol=0)


def test_conv3x3_stats_bf16_contract():
    """bf16: y is the f32 accumulator rounded once; the statistics come
    from the f32 accumulator, not from the rounded y."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 6, 8, 64).astype(np.float32))
    k = torch.from_numpy((rng.randn(3, 3, 64, 64) / 24).astype(np.float32))
    b = torch.from_numpy(rng.randn(64).astype(np.float32))
    y16, m16, v16 = tfr.conv3x3_stats(x.bfloat16(), k, b)
    y32, m32, v32 = tfr.conv3x3_stats(x.bfloat16().float(),
                                      k.bfloat16().float(), b)
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, y32.bfloat16())
    torch.testing.assert_close(m16, m32, atol=1e-6, rtol=0)
    torch.testing.assert_close(v16, v32, atol=1e-5, rtol=0)
