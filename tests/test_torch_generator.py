"""CompositeGenerator: the port (plain tail) against the JAX generator (phase
form) with parameters converted by params_from_flax."""

import numpy as np
import pytest
import torch

from text2video_tpu_torch.convert import params_from_flax
from text2video_tpu_torch.models.generator import CompositeGenerator

torch.set_num_threads(1)

H, W, BASE, BLOCKS = 32, 48, 8, 2


def _flax_params(seed=0):
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.generator import CompositeGenerator as JaxGen

    gen = JaxGen(base_ch=BASE, n_blocks=BLOCKS, dtype=jnp.float32)
    params = jax.jit(gen.init)(jax.random.PRNGKey(seed),
                               jnp.zeros((1, H, W, 9)),
                               jnp.zeros((1, H, W, 6)), jnp.ones((1,)))
    rng = np.random.RandomState(seed)
    # Random biases and norm affines, so a swapped leaf cannot go unseen.
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.randn(*v.shape).astype(np.float32),
        params,
    )
    # lecun-init heads give flows of ~30 px, where f32 itself resolves only
    # ~1e-4 (both packages sit that far from an f64 forward); a tenth of the
    # kernel keeps the flow at a few pixels, as a trained model's is.
    params["params"]["heads"]["kernel"] *= 0.1
    return params


def _port(params):
    gen = CompositeGenerator(15, base_ch=BASE, n_blocks=BLOCKS,
                             dtype=torch.float32)
    gen.load_state_dict(params_from_flax(params), strict=True)
    return gen.eval()


@pytest.mark.parametrize("fused", [False, True])
def test_generator_matches_jax(fused):
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.generator import CompositeGenerator as JaxGen

    params = _flax_params()
    rng = np.random.RandomState(1)
    labels = (rng.rand(2, H, W, 9) * 2 - 1).astype(np.float32)
    prev = (rng.rand(2, H, W, 6) * 2 - 1).astype(np.float32)
    has_prev = np.asarray([0.0, 1.0], np.float32)
    jgen = JaxGen(base_ch=BASE, n_blocks=BLOCKS, dtype=jnp.float32,
                  phase_form=True, fused_resblocks=fused)
    ref = [np.asarray(a) for a in jax.jit(jgen.apply)(
        params, jnp.asarray(labels), jnp.asarray(prev), jnp.asarray(has_prev))]
    with torch.inference_mode():
        out = _port(params)(*map(torch.from_numpy, (labels, prev, has_prev)))
    for name, o, r in zip(("frame", "flow", "mask"), out, ref):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o.numpy(), r, atol=1e-4, rtol=0,
                                   err_msg=name)
    assert np.all(ref[2][0] == 1.0)  # has_prev 0 forces the mask open


def test_converter_covers_every_flax_leaf():
    import jax

    params = _flax_params()
    sd = params_from_flax(params)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(sd) == len(leaves)
    assert sum(v.numel() for v in sd.values()) == sum(
        np.size(v) for v in leaves)
    gen = _port(params)
    assert set(sd) == set(gen.state_dict())
    # Kernels keep the flax HWIO layout.
    np.testing.assert_array_equal(
        gen.trunk.res[1].block0.conv.kernel.detach().numpy(),
        params["params"]["GlobalTrunk_0"]["ResBlock_1"]["ConvBlock_0"][
            "Conv_0"]["kernel"])
    bad = {"params": dict(params["params"], Extra_0={})}
    with pytest.raises(KeyError):
        params_from_flax(bad)
