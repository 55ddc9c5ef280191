"""The port's Renderer against the JAX Renderer, f32, same weights, over a
short rollout (random weights make the warp recurrence chaotic, so parity is
held over a few frames only)."""

import numpy as np
import pytest
import torch

from text2video_tpu import config as jconfig
from text2video_tpu_torch import config as tconfig
from text2video_tpu_torch.convert import params_from_flax
from text2video_tpu_torch.render import Renderer, resize_labels

torch.set_num_threads(1)

H, W, T, BUCKET = 32, 48, 5, 4  # 5 frames in chunks of 4: the carry crosses


@pytest.fixture(scope="module")
def renderers():
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.generator import CompositeGenerator
    from text2video_tpu.render import Renderer as JaxRenderer

    gen = CompositeGenerator(base_ch=8, n_blocks=1, dtype=jnp.float32)
    params = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 9)),
                               jnp.zeros((1, H, W, 6)), jnp.ones((1,)))
    params = jax.tree_util.tree_map(np.array, params)
    # A tenth of the lecun heads keeps flows at a few pixels (see
    # test_torch_generator.py).
    params["params"]["heads"]["kernel"] *= 0.1
    jr = JaxRenderer(generator=gen, params=params,
                     config=jconfig.RenderConfig(wire_format="yuv420"),
                     time_bucket=BUCKET)
    tr = Renderer.create(config=tconfig.RenderConfig(wire_format="yuv420"),
                         base_ch=8, n_blocks=1, dtype=torch.float32,
                         device="cpu")
    tr.generator.load_state_dict(params_from_flax(params), strict=True)
    tr.time_bucket = BUCKET
    return jr, tr


def _labels_u8():
    return np.random.RandomState(0).randint(0, 256, (T, H, W, 3), np.uint8)


def _chunks(labels):
    pad = np.zeros((BUCKET * 2 - T, H, W, 3), np.uint8)
    full = np.concatenate([labels, pad])
    return [full[:BUCKET], full[BUCKET:]]


def test_generate_device_matches_jax(renderers):
    import jax.numpy as jnp

    jr, tr = renderers
    labels = _labels_u8()[None].astype(np.float32) / 127.5 - 1.0
    ref = np.concatenate(
        [np.asarray(c) for c in jr.generate_device(jnp.asarray(labels))],
        axis=1)
    # The port takes the uint8 maps and scales them a chunk at a time.
    chunks = tr.generate_device(torch.from_numpy(_labels_u8()[None]))
    assert [tuple(c.shape) for c in chunks] == [(1, BUCKET, H, W, 3)] * 2
    out = torch.cat(chunks, dim=1).numpy()
    assert out.dtype == np.uint8
    diff = np.abs(out[:, :T].astype(int) - ref[:, :T].astype(int))
    assert diff.max() <= 1, diff.max()
    assert out[:, :T].std() > 1.0  # not a constant image


def test_device_chunks_and_yuv_stream_match_jax(renderers):
    import jax.numpy as jnp

    jr, tr = renderers
    chunks = _chunks(_labels_u8())
    ref = jr.render_from_device_chunks([jnp.asarray(c) for c in chunks], T)
    out = tr.render_from_device_chunks([torch.from_numpy(c) for c in chunks],
                                       T)
    assert out.shape == ref.shape == (T, H, W, 3)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1

    ref_planes = list(jr.render_stream_yuv([jnp.asarray(c) for c in chunks],
                                           T))
    out_planes = list(tr.render_stream_yuv(
        [torch.from_numpy(c) for c in chunks], T))
    assert [p[0].shape[0] for p in out_planes] == [BUCKET, T - BUCKET]
    for rp, op in zip(ref_planes, out_planes):
        for r, o in zip(rp, op):
            assert o.shape == r.shape and o.dtype == np.uint8
            assert np.abs(o.astype(int) - r.astype(int)).max() <= 1


def test_render_host_labels_matches_jax(renderers):
    jr, tr = renderers
    labels = _labels_u8()
    ref = jr.render(labels)
    out = tr.render(labels)
    assert out.shape == ref.shape == (T, H, W, 3) and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_resize_labels_matches_jax_antialiased_downscale():
    import jax
    import jax.numpy as jnp

    x = np.random.RandomState(2).rand(1, 2, 40, 60, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2, 24, 36, 3),
                                      method="linear"))
    out = resize_labels(torch.from_numpy(x), 24, 36).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("path", ["generate_device", "device_chunks",
                                  "yuv_stream", "render_many"])
def test_generator_runs_once_per_frame(renderers, path):
    """The padding frames of the last chunk cost no generator step."""
    _, tr = renderers
    calls = []
    hook = tr.generator.register_forward_hook(lambda *a: calls.append(1))
    labels = _labels_u8()
    try:
        if path == "generate_device":
            tr.generate_device(torch.from_numpy(labels)[None])
        elif path == "device_chunks":
            tr.render_from_device_chunks(
                [torch.from_numpy(c) for c in _chunks(labels)], T)
        elif path == "yuv_stream":
            list(tr.render_stream_yuv(
                [torch.from_numpy(c) for c in _chunks(labels)], T))
        else:
            tr.render_many(np.stack([labels, labels]))
    finally:
        hook.remove()
    assert len(calls) == T
