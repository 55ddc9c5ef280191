"""flow_warp against the JAX gather form."""

import numpy as np
import pytest
import torch

from text2video_tpu_torch.ops.warp import flow_warp

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flow_warp_matches_jax(dtype):
    import jax.numpy as jnp

    from text2video_tpu.ops.warp import flow_warp as jax_flow_warp

    rng = np.random.RandomState(0)
    img = (rng.rand(2, 9, 13, 3) * 2 - 1).astype(np.float32)
    # Large enough to leave the canvas, so the border clamp is exercised.
    flow = (rng.randn(2, 9, 13, 2) * 6).astype(np.float32)
    jdt = getattr(jnp, dtype)
    ref = np.asarray(
        jax_flow_warp(jnp.asarray(img).astype(jdt), jnp.asarray(flow)),
        np.float32)
    out = flow_warp(torch.from_numpy(img).to(getattr(torch, dtype)),
                    torch.from_numpy(flow))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-6, rtol=0)
