"""The port's Renderer against the JAX Renderer, f32, same weights, over a
short rollout (random weights make the warp recurrence chaotic, so parity is
held over a few frames only), and the port's entry points against each other
at the chunk edges of its one scan loop."""

import dataclasses

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
    # The port takes the uint8 maps and scales them a chunk at a time; its
    # frames come unpadded, the JAX package's in padded chunks.
    out = tr.generate_device(torch.from_numpy(_labels_u8()[None]))
    assert out.shape == (1, T, H, W, 3) and out.dtype == torch.uint8
    out = out.numpy()
    diff = np.abs(out.astype(int) - ref[:, :T].astype(int))
    assert diff.max() <= 1, diff.max()
    assert out.std() > 1.0  # not a constant image


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


def _counted(gen, fn):
    """(fn(), how many times ``gen`` ran)."""
    calls = []
    hook = gen.register_forward_hook(lambda *a: calls.append(1))
    try:
        return fn(), len(calls)
    finally:
        hook.remove()


@pytest.mark.parametrize("path", ["generate_device", "device_chunks",
                                  "yuv_stream", "render_many"])
def test_generator_runs_once_per_frame(renderers, path):
    """The padding frames of the last chunk cost no generator step."""
    _, tr = renderers
    labels = _labels_u8()
    chunks = [torch.from_numpy(c) for c in _chunks(labels)]
    paths = {
        "generate_device": lambda: tr.generate_device(
            torch.from_numpy(labels)[None]),
        "device_chunks": lambda: tr.render_from_device_chunks(chunks, T),
        "yuv_stream": lambda: list(tr.render_stream_yuv(chunks, T)),
        "render_many": lambda: tr.render_many(np.stack([labels, labels])),
    }
    assert _counted(tr.generator, paths[path])[1] == T


# (frames, label chunk lengths as the rasterizer would hand them, max_frames,
# frames each chunk of the stream yields). BUCKET is 4 and n_frames_ctx - 1
# is 2.
EDGES = {
    "t1": (1, [1], None, [1]),
    "t2": (2, [2], None, [2]),
    "bucket-1": (BUCKET - 1, [BUCKET - 1], None, [BUCKET - 1]),
    "bucket": (BUCKET, [BUCKET], None, [BUCKET]),
    "bucket+1_last_under_ctx": (BUCKET + 1, [BUCKET, 1], None, [BUCKET, 1]),
    "2bucket+3": (2 * BUCKET + 3, [BUCKET, BUCKET, 3], None,
                  [BUCKET, BUCKET, 3]),
    "2bucket": (2 * BUCKET, [BUCKET, BUCKET], None, [BUCKET, BUCKET]),
    "padded_last": (6, [BUCKET, BUCKET], None, [BUCKET, 2]),
    # Chunks of exactly n_frames_ctx - 1: neither padded nor re-sliced.
    "last_at_ctx": (6, [BUCKET, 2], None, [BUCKET, 2]),
    "mid_at_ctx": (8, [BUCKET, 2, 2], None, [BUCKET, 2, 2]),
    "over_max_frames": (7, [BUCKET, 3], 5, [BUCKET, 1]),
    # A chunk of 1 mid-stream re-slices the timeline into chunks of 4.
    "short_mid_stream": (7, [BUCKET, 1, 2], None, [BUCKET, 3]),
    "short_mid_stream_over_max": (9, [2, 1, BUCKET, 2], 6, [BUCKET, 2]),
}


def _renderer_with(tr, max_frames):
    if max_frames is None:
        return tr
    return Renderer(generator=tr.generator, time_bucket=BUCKET,
                    config=dataclasses.replace(tr.config,
                                               max_frames=max_frames))


def _entry_points_agree(tr, labels, chunk_lens, counts):
    """``render``, ``generate_device``, ``render_many_device``,
    ``render_many`` and ``render_from_device_chunks`` give the same uint8
    frames, bit for bit,
    ``sum(counts)`` of them; the yuv420 stream yields ``counts``; and each
    runs the generator once a frame."""
    t, n = labels.shape[0], sum(counts)
    full = np.concatenate([labels, np.zeros((sum(chunk_lens) - t, H, W, 3),
                                            np.uint8)])
    cuts = np.cumsum([0] + chunk_lens)

    def chunks():
        return [torch.from_numpy(full[a:b]) for a, b in zip(cuts, cuts[1:])]

    outs = {
        "render": lambda: tr.render(labels),
        "generate_device": lambda: tr.generate_device(
            torch.from_numpy(labels)[None])[0].numpy(),
        "render_many_device": lambda: tr.render_many_device(
            torch.from_numpy(labels)[None])[0],
        "render_many": lambda: tr.render_many(labels[None])[0],
        "render_from_device_chunks": lambda: tr.render_from_device_chunks(
            chunks(), t),
        "yuv_stream": lambda: [y.shape[0] for y, _, _ in
                               tr.render_stream_yuv(chunks(), t)],
    }
    frames = {}
    for name, fn in outs.items():
        frames[name], calls = _counted(tr.generator, fn)
        assert calls == n, (name, calls, n)
    assert frames.pop("yuv_stream") == counts
    ref = frames["render"]
    assert ref.shape == (n, H, W, 3) and ref.dtype == np.uint8
    for name, out in frames.items():
        assert out.dtype == np.uint8 and np.array_equal(out, ref), name
    return ref


@pytest.mark.parametrize("case", [*EDGES, "batch2_unequal_lengths"])
def test_entry_points_agree_at_chunk_edges(renderers, case):
    _, tr = renderers
    if case != "batch2_unequal_lengths":
        t, chunk_lens, max_frames, counts = EDGES[case]
        labels = np.random.RandomState(t).randint(0, 256, (t, H, W, 3),
                                                  np.uint8)
        out = _entry_points_agree(_renderer_with(tr, max_frames), labels,
                                  chunk_lens, counts)
        assert out.std() > 1.0  # not a constant image
        return
    # Two utterances of 6 and 3 frames in one batch, the shorter one padded
    # with blank labels, as ``run_audio_batch`` pads them.
    rows = np.zeros((2, 6, H, W, 3), np.uint8)
    rows[0] = np.random.RandomState(6).randint(0, 256, (6, H, W, 3), np.uint8)
    rows[1, :3] = np.random.RandomState(3).randint(0, 256, (3, H, W, 3),
                                                   np.uint8)
    for row, lens in zip(rows, ([BUCKET, 2], [3])):
        _entry_points_agree(tr, row[:sum(lens)], lens, lens)
    batch, calls = _counted(tr.generator, lambda: tr.generate_device(
        torch.from_numpy(rows)))
    assert calls == 6 and batch.shape == (2, 6, H, W, 3)
    many, calls = _counted(tr.generator, lambda: tr.render_many_device(
        torch.from_numpy(rows)))
    assert calls == 6 and np.array_equal(batch.numpy(), many)
    assert np.array_equal(many, tr.render_many(rows))
