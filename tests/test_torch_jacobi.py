"""Jacobi decoding: one sweep of the port against one sweep of the JAX
``jacobi_device`` (f32, same weights; the JAX sweep runs its resblocks through
the Pallas kernel in interpret mode, as its own tests do on the CPU), and the
port's Jacobi against the port's scan under the structural bounds of
``tests/test_render_jacobi.py``."""

import numpy as np
import pytest
import torch

from text2video_tpu import config as jconfig
from text2video_tpu_torch import config as tconfig
from text2video_tpu_torch.convert import params_from_flax
from text2video_tpu_torch.ops.colorspace import rgb_norm_to_yuv420
from text2video_tpu_torch.render import Renderer

torch.set_num_threads(1)

H, W, BUCKET = 32, 32, 4


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
                     config=jconfig.RenderConfig(), time_bucket=BUCKET)
    tr = Renderer.create(base_ch=8, n_blocks=1, dtype=torch.float32,
                         device="cpu")
    tr.generator.load_state_dict(params_from_flax(params), strict=True)
    tr.time_bucket = BUCKET
    return jr, tr


def _labels_u8(t, seed):
    return np.random.RandomState(seed).randint(0, 256, (t, H, W, 3), np.uint8)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


@pytest.mark.parametrize("t", [6, 7])  # 7: the last bucket holds 3 frames
def test_one_sweep_matches_jax(renderers, t):
    """Same inputs, same weights, one sweep: frames in [-1, 1] agree to
    2e-5 (f32 sums in another order). The JAX side pads the tail bucket;
    the port runs it at its real length."""
    import jax.numpy as jnp

    jr, tr = renderers
    labels = _labels_u8(t, 3).astype(np.float32) / 127.5 - 1.0
    ref = np.asarray(jr.jacobi_device(jnp.asarray(labels), 1))
    out = tr.jacobi_device(torch.from_numpy(labels), 1)
    assert out.dtype == torch.float32 and tuple(out.shape) == (t, H, W, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
    assert out.numpy().std() > 0.01


@pytest.mark.parametrize("t,seed", [(6, 0), (7, 2)])
def test_full_sweeps_match_scan(renderers, t, seed):
    """``sweeps = T`` reproduces the scan up to float noise amplified along
    the chain: frame 0 within 1 level, the first half within 2, the clip at
    35 dB or better."""
    _, tr = renderers
    labels = _labels_u8(t, seed)
    seq = tr.render(labels)
    jac = tr.render_jacobi(labels, sweeps=t)
    assert jac.shape == (t, H, W, 3) and jac.dtype == np.uint8
    diff = np.abs(seq.astype(int) - jac.astype(int))
    assert diff[0].max() <= 1, diff[0].max()
    assert diff[: t // 2].max() <= 2, diff[: t // 2].max()
    assert _psnr(seq, jac) >= 35.0, _psnr(seq, jac)


def test_few_sweeps_approximate(renderers):
    """More sweeps come closer to the scan, and after s sweeps the first s
    frames match it."""
    _, tr = renderers
    labels = _labels_u8(8, 1)
    seq = tr.render(labels)
    jac3 = tr.render_jacobi(labels, sweeps=3)
    jac1 = tr.render_jacobi(labels, sweeps=1)
    assert _psnr(seq, jac3) >= _psnr(seq, jac1)
    assert np.abs(seq[:3].astype(int) - jac3[:3].astype(int)).max() <= 2
    # Fewer than one sweep is one sweep.
    np.testing.assert_array_equal(tr.render_jacobi(labels, sweeps=0), jac1)


def test_generator_runs_once_per_bucket_and_sweep(renderers):
    """``time_bucket`` frames a call, the last bucket at its real length:
    no generator call sees padding frames."""
    _, tr = renderers
    batches = []
    hook = tr.generator.register_forward_hook(
        lambda mod, args, out: batches.append(args[0].shape[0]))
    try:
        tr.render_jacobi(_labels_u8(7, 2), sweeps=3)
    finally:
        hook.remove()
    assert batches == [4, 3] * 3


def _jacobi_chunks(t):
    labels = _labels_u8(t, 4)
    full = np.concatenate([labels, np.zeros((1, H, W, 3), np.uint8)])
    return labels, [torch.from_numpy(full[:BUCKET]),
                    torch.from_numpy(full[BUCKET:])]


def test_decode_mode_jacobi_through_the_render_paths(renderers):
    """``decode_mode="jacobi"`` on the ``"yuv420"`` wire:
    ``render_from_device_chunks`` gives ``render_jacobi``'s frames, and
    ``render_stream_yuv`` the planes of ``rgb_norm_to_yuv420`` on the Jacobi
    frames, chunk by chunk, cut at ``t``."""
    _, tr = renderers
    t, sweeps = 7, 2
    labels, chunks = _jacobi_chunks(t)
    jr = Renderer(generator=tr.generator, time_bucket=BUCKET,
                  config=tconfig.RenderConfig(decode_mode="jacobi",
                                              jacobi_sweeps=sweeps,
                                              wire_format="yuv420"))
    want = tr.render_jacobi(labels, sweeps=sweeps)
    np.testing.assert_array_equal(jr.render_from_device_chunks(chunks, t),
                                  want)
    frames = tr.jacobi_device(
        torch.from_numpy(labels).float() / 127.5 - 1.0, sweeps)
    planes = list(jr.render_stream_yuv(chunks, t))
    assert [p[0].shape[0] for p in planes] == [BUCKET, t - BUCKET]
    for i, got in enumerate(planes):
        ref = rgb_norm_to_yuv420(frames[i * BUCKET: (i + 1) * BUCKET])
        for g, r in zip(got, ref):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, r.numpy())
    # max_frames cuts the timeline before decoding.
    jr.config = tconfig.RenderConfig(decode_mode="jacobi", jacobi_sweeps=1,
                                     max_frames=5)
    assert jr.render_from_device_chunks(chunks, t).shape[0] == 5


def test_decode_mode_jacobi_through_the_dct_wire(renderers):
    """``decode_mode="jacobi"`` on the default ``"dct"`` wire:
    ``render_stream_coeffs`` gives the Jacobi frames' coefficients
    (``encode_yuv`` of their float YUV420 planes, packed and unpacked),
    chunk by chunk, and ``render_stream_yuv`` those decoded."""
    from text2video_tpu_torch.ops import dct
    from text2video_tpu_torch.ops.colorspace import rgb_norm_to_yuv420_float

    _, tr = renderers
    t, sweeps = 7, 2
    labels, chunks = _jacobi_chunks(t)
    cfg = tconfig.RenderConfig(decode_mode="jacobi", jacobi_sweeps=sweeps)
    assert cfg.wire_format == "dct" and cfg.wire_packed
    jr = Renderer(generator=tr.generator, time_bucket=BUCKET, config=cfg)
    frames = tr.jacobi_device(
        torch.from_numpy(labels).float() / 127.5 - 1.0, sweeps)
    coeffs = list(jr.render_stream_coeffs(chunks, t))
    planes = list(jr.render_stream_yuv(chunks, t))
    assert [c[0][0].shape[0] for c in coeffs] == [BUCKET, t - BUCKET]
    lq, cq = dct.quant_tables(cfg.wire_quality)
    for i, ((got, hw), yuv) in enumerate(zip(coeffs, planes)):
        assert hw == (H, W)
        ref = dct.encode_yuv(
            *rgb_norm_to_yuv420_float(frames[i * BUCKET: (i + 1) * BUCKET]),
            quality=cfg.wire_quality, k_luma=cfg.wire_k_luma,
            k_chroma=cfg.wire_k_chroma)
        for g, r, w_ac, q, p in zip(
                got, ref, (dct.W_AC_LUMA, dct.W_AC_CHROMA, dct.W_AC_CHROMA),
                (lq, cq, cq), yuv):
            want = dct._unpack_plane_shift_numpy(
                dct.pack_plane_shift(r, w_ac).numpy(), tuple(r.shape), w_ac)
            np.testing.assert_array_equal(g, want)
            np.testing.assert_array_equal(p, dct.decode_plane_np(g, q))
