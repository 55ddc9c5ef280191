"""CompositeGenerator: the port (its default, the phase form) against the JAX
generator (its default, the phase form) with parameters converted by
params_from_flax; the local-enhancer variant in either form on both sides;
the plain-resblock form that trains, and its gradients. The phase forms
function by function: tests/test_torch_phase_conv.py."""

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
    gen = _port(params)
    assert gen.phase_form  # the default, as in JAX
    with torch.inference_mode():
        out = gen(*map(torch.from_numpy, (labels, prev, has_prev)))
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


def _inputs(seed=1, b=2):
    rng = np.random.RandomState(seed)
    return ((rng.rand(b, H, W, 9) * 2 - 1).astype(np.float32),
            (rng.rand(b, H, W, 6) * 2 - 1).astype(np.float32),
            np.asarray([0.0, 1.0][:b], np.float32))


def test_plain_resblocks_equal_fused_with_one_state_dict():
    """``fused_resblocks=False`` (the form that trains) holds the same
    parameters under the same names and computes the same function."""
    fused = _port(_flax_params())
    plain = CompositeGenerator(15, base_ch=BASE, n_blocks=BLOCKS,
                               dtype=torch.float32, fused_resblocks=False)
    plain.load_state_dict(fused.state_dict(), strict=True)
    args = list(map(torch.from_numpy, _inputs()))
    with torch.inference_mode():
        for a, b in zip(fused(*args), plain.eval()(*args)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("phase_form", [True, False])
def test_local_enhancer_generator_matches_jax(phase_form):
    """``n_local_enhancers=1``: the trunk at half resolution, one refinement
    stage on top, through ``params_from_flax``."""
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.generator import CompositeGenerator as JaxGen

    jgen = JaxGen(base_ch=BASE, n_blocks=BLOCKS, n_local_enhancers=1,
                  n_local_blocks=2, dtype=jnp.float32, phase_form=phase_form)
    labels, prev, has_prev = _inputs(seed=2)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(3), jnp.asarray(labels),
                                jnp.asarray(prev), jnp.asarray(has_prev))
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.randn(*v.shape).astype(np.float32),
        params)
    # Flows of about a pixel: f32 resolves a 4 px flow to ~4e-5 px, and on
    # noise images that much flow moves the warped frame by as much.
    params["params"]["heads"]["kernel"] *= 0.03
    ref = [np.asarray(a) for a in jax.jit(jgen.apply)(
        params, jnp.asarray(labels), jnp.asarray(prev), jnp.asarray(has_prev))]
    gen = CompositeGenerator(15, base_ch=BASE, n_blocks=BLOCKS,
                             dtype=torch.float32, n_local_enhancers=1,
                             n_local_blocks=2, phase_form=phase_form)
    sd = params_from_flax(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    gen.load_state_dict(sd, strict=True)
    assert gen.heads.kernel.shape == (7, 7, BASE // 2, 6)
    with torch.inference_mode():
        out = gen.eval()(*map(torch.from_numpy, (labels, prev, has_prev)))
    for name, o, r in zip(("frame", "flow", "mask"), out, ref):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o.numpy(), r, atol=2e-5, rtol=0,
                                   err_msg=name)
    assert np.abs(ref[1]).max() > 0.5  # the warp is exercised
    with pytest.raises(KeyError):  # a stage without its upsample
        params_from_flax({"params": {
            k: v for k, v in params["params"].items() if k != "Upsample_0"}})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_reaches_the_f32_master_parameters(dtype):
    """Under grad a conv casts its live f32 parameter inside the graph, so
    every parameter of the plain-resblock generator gets an f32 gradient,
    in the bf16 generator too."""
    gen = CompositeGenerator(15, base_ch=BASE, n_blocks=BLOCKS, dtype=dtype,
                             fused_resblocks=False)
    gen.reset_parameters(torch.Generator().manual_seed(0))
    frame, flow, mask = gen(*map(torch.from_numpy, _inputs()))
    assert frame.requires_grad
    (frame.square().mean() + flow.abs().mean() + mask.mean()).backward()
    for name, p in gen.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all(), name
    for conv in (gen.trunk.stem.conv, gen.trunk.res[0].block1.conv,
                 gen.heads):
        assert conv.kernel.grad.abs().sum() > 0
    # Without grad the same module serves from its cached detached copies.
    with torch.no_grad():
        out = gen(*map(torch.from_numpy, _inputs()))[0]
    assert not out.requires_grad
    assert torch.equal(out, frame.detach())


def test_fused_generator_cannot_train_silently():
    """The fused op has no backward: a graph that needs one raises, on the
    CPU too, where the plain version would differentiate."""
    from text2video_tpu_torch.ops.fused_resblock import conv3x3_stats

    gen = CompositeGenerator(15, base_ch=BASE, n_blocks=BLOCKS,
                             dtype=torch.float32)
    gen.reset_parameters(torch.Generator().manual_seed(0))
    args = list(map(torch.from_numpy, _inputs()))
    with pytest.raises(RuntimeError, match="no backward"):
        gen(*args)
    x = torch.randn(1, 4, 6, 64)
    k, b = torch.randn(3, 3, 64, 64), torch.randn(64)
    conv3x3_stats(x, k, b)  # nothing requires grad: served
    for i in range(3):
        tensors = [x.clone(), k.clone(), b.clone()]
        tensors[i].requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            conv3x3_stats(*tensors)
        with torch.no_grad():
            conv3x3_stats(*tensors)
