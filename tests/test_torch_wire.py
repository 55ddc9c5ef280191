"""The port's DCT wire (``ops/dct.py``, ``io/wire_native.py``, the renderer's
coefficient stream, the muxer's coefficient path, the pipeline's default)
against the JAX package's ``text2video_tpu/ops/dct.py`` and renderer.

The JAX side is driven through its numpy references and its renderer with
``wire_packed=False``: its native codec (``text2video_tpu/io/wire_native.py``)
is never called here, because its build runs cmake in the shared
``native/build/`` without a lock. The port's codec is built from the same
``native/wire/wire.cc`` into ``build/torch_native/``."""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from text2video_tpu_torch import config as tconfig
from text2video_tpu_torch.io import wire_native
from text2video_tpu_torch.ops import dct as tdct

torch.set_num_threads(1)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def _smooth(n, h, w, seed):
    """GAN-frame-like planes: smooth gradients and a few soft blobs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for i in range(n):
        p = 110 + 60 * np.sin(xx / (23.0 + i)) + 40 * np.cos(yy / 17.0)
        for _ in range(4):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            p += 35 * np.exp(-(((yy - cy) / 9.0) ** 2
                               + ((xx - cx) / 9.0) ** 2))
        out.append(p)
    return np.clip(np.stack(out), 0, 255).astype(np.float32)


def _plane(name):
    rng = np.random.RandomState(3)
    return {
        "smooth": lambda: _smooth(8, 96, 128, 0),
        "noise": lambda: rng.uniform(0, 255, (8, 96, 128)).astype(np.float32),
        "chroma": lambda: _smooth(8, 48, 64, 1),
        "flat0": lambda: np.zeros((2, 16, 24), np.float32),
        "flat255": lambda: np.full((2, 16, 24), 255.0, np.float32),
        "odd": lambda: _smooth(3, 44, 52, 2),  # pads to 48x56
    }[name]()


def _jax_encode(plane, quant, k):
    import jax
    import jax.numpy as jnp

    from text2video_tpu.ops import dct as jdct

    fn = jax.jit(lambda x: jdct.encode_plane(x, quant, k))
    return np.asarray(fn(jnp.asarray(plane)))


def _jax_pack(coeffs, w_ac):
    import jax
    import jax.numpy as jnp

    from text2video_tpu.ops import dct as jdct

    fn = jax.jit(lambda c: jdct.pack_plane_shift(c, w_ac))
    return np.asarray(fn(jnp.asarray(coeffs)))


# ---- tables and kernels -----------------------------------------------------

def test_tables_and_kernels_equal_jax():
    from text2video_tpu.ops import dct as jdct

    np.testing.assert_array_equal(tdct.ZIGZAG, jdct.ZIGZAG)
    np.testing.assert_array_equal(tdct.dct_matrix8(), jdct.dct_matrix8())
    for quality in range(1, 101):
        for ours, theirs in zip(tdct.quant_tables(quality),
                                jdct.quant_tables(quality)):
            assert ours.dtype == theirs.dtype == np.float32
            np.testing.assert_array_equal(ours, theirs)
    for quality, k in ((75, 12), (75, 6), (80, 20), (80, 8), (10, 64)):
        for quant in tdct.quant_tables(quality):
            np.testing.assert_array_equal(tdct._encode_kernel(quant, k),
                                          jdct._encode_kernel(quant, k))
            np.testing.assert_array_equal(tdct._decode_kernel(quant, k),
                                          jdct._decode_kernel(quant, k))
    assert (tdct.W_AC_LUMA, tdct.W_AC_CHROMA) == (jdct.W_AC_LUMA,
                                                  jdct.W_AC_CHROMA)
    for n in (1, 7, 8, 9, 3072):
        assert tdct.packed_plane_bytes(n, 12, 5) == jdct.packed_plane_bytes(
            n, 12, 5)


# ---- device encode and pack, bit for bit ------------------------------------

@pytest.mark.parametrize("name", ["smooth", "noise", "chroma", "flat0",
                                  "flat255", "odd"])
def test_encode_plane_bit_equal_jax(name):
    """The [blocks, 64] @ [64, k] product, rounded half to even, equals
    JAX's stride-8 convolution bit for bit, padded sizes included."""
    plane = _plane(name)
    for quality, which, k in ((75, 0, 12), (75, 1, 6), (80, 0, 20),
                              (95, 1, 8)):
        quant = tdct.quant_tables(quality)[which]
        ref = _jax_encode(plane, quant, k)
        out = tdct.encode_plane(torch.from_numpy(plane), quant, k).numpy()
        assert out.dtype == np.int8 and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)


def test_encode_yuv_bit_equal_jax_and_bf16_input():
    """encode_yuv at the wire's defaults; a bf16 plane (the serving
    generator's dtype) is cast to f32 first, as JAX's encode does."""
    import jax.numpy as jnp

    from text2video_tpu.ops import dct as jdct

    y, u, v = _smooth(2, 96, 128, 4), _smooth(2, 48, 64, 5), _smooth(
        2, 48, 64, 6)
    ref = jdct.encode_yuv(y, u, v, quality=75, k_luma=12, k_chroma=6)
    out = tdct.encode_yuv(*map(torch.from_numpy, (y, u, v)), quality=75,
                          k_luma=12, k_chroma=6)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    y16 = torch.from_numpy(y).bfloat16()
    ref16 = jdct.encode_plane(jnp.asarray(y16.float().numpy(), jnp.bfloat16),
                              tdct.quant_tables(75)[0], 12)
    np.testing.assert_array_equal(
        tdct.encode_plane(y16, tdct.quant_tables(75)[0], 12).numpy(),
        np.asarray(ref16))


@pytest.mark.parametrize("w_ac", [4, 5])
def test_block_shift_equals_jax_float_rule(w_ac):
    """The integer shift rule equals JAX's ceil(log2(max(m, 1) / lim))
    clipped to 0..3 for every possible max |AC|."""
    import jax.numpy as jnp

    m = np.arange(128, dtype=np.int32)
    lim = (1 << (w_ac - 1)) - 1
    ref = np.asarray(jnp.clip(jnp.ceil(jnp.log2(
        jnp.maximum(jnp.asarray(m, jnp.float32), 1.0) / lim)), 0, 3
    ).astype(jnp.int32))
    np.testing.assert_array_equal(
        tdct.block_shift(torch.from_numpy(m), w_ac).numpy(), ref)


PACK_SHAPES = [(3, 8, 8, 12), (1, 5, 7, 12), (2, 3, 3, 6), (1, 1, 3, 6)]


def _coeffs(shape, seed):
    """Random int8 coefficients with the extremes and all-zero blocks."""
    rng = np.random.RandomState(seed)
    c = rng.randint(-127, 128, size=shape).astype(np.int8)
    flat = c.reshape(-1, shape[-1])
    flat[0] = 127
    flat[-1, 1:] = 0
    if len(flat) > 2:
        flat[1, 1:] = rng.randint(-3, 4, size=shape[-1] - 1)
    return c


@pytest.mark.parametrize("w_ac", [4, 5])
def test_pack_plane_shift_byte_equal_jax(w_ac):
    """Block counts that are not multiples of 8 (35, 18, 3 blocks)."""
    for i, shape in enumerate(PACK_SHAPES):
        coeffs = _coeffs(shape, i)
        ref = _jax_pack(coeffs, w_ac)
        out = tdct.pack_plane_shift(torch.from_numpy(coeffs), w_ac).numpy()
        assert out.dtype == np.uint8 and out.shape == ref.shape
        assert out.size == tdct.packed_plane_bytes(
            int(np.prod(shape[:-1])), shape[-1], w_ac)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("w_ac", [4, 5])
def test_unpacks_equal_jax_numpy_unpack(w_ac):
    """The port's numpy reference and its native unpack (the wire path's)
    both equal JAX's numpy unpack of JAX's packed bytes."""
    from text2video_tpu.ops import dct as jdct

    for i, shape in enumerate(PACK_SHAPES):
        packed = _jax_pack(_coeffs(shape, i), w_ac)
        ref = jdct._unpack_plane_shift_numpy(packed, shape, w_ac)
        np.testing.assert_array_equal(
            tdct._unpack_plane_shift_numpy(packed, shape, w_ac), ref)
        native = tdct.unpack_plane_shift_np(packed, shape, w_ac)
        assert native.dtype == np.int8
        np.testing.assert_array_equal(native, ref)
        np.testing.assert_array_equal(
            wire_native.unpack_plane(packed, shape, w_ac), ref)


def test_decode_plane_equal_jax():
    from text2video_tpu.ops import dct as jdct

    lq, cq = tdct.quant_tables(75)
    for quant, k, seed in ((lq, 12, 0), (cq, 6, 1)):
        coeffs = np.random.RandomState(seed).randint(
            -30, 31, size=(2, 6, 7, k)).astype(np.int8)
        np.testing.assert_array_equal(tdct.decode_plane_np(coeffs, quant),
                                      jdct.decode_plane_np(coeffs, quant))
    yq, uq, vq = (np.random.RandomState(s).randint(-20, 21, size=sh)
                  .astype(np.int8) for s, sh in
                  ((2, (1, 4, 6, 12)), (3, (1, 2, 3, 6)), (4, (1, 2, 3, 6))))
    for o, r in zip(tdct.decode_yuv_np(yq, uq, vq, quality=75),
                    jdct.decode_yuv_np(yq, uq, vq, quality=75)):
        np.testing.assert_array_equal(o, r)


# ---- the native codec ------------------------------------------------------

def _wire_coeffs(t, h, w, quality=75, kl=12, kc=6):
    y = _smooth(t, h, w, 10)
    u = _smooth(t, h // 2, w // 2, 11)
    v = _smooth(t, h // 2, w // 2, 12)
    return tuple(c.numpy() for c in tdct.encode_yuv(
        *map(torch.from_numpy, (y, u, v)), quality=quality, k_luma=kl,
        k_chroma=kc))


def test_native_library_builds_into_torch_native():
    path = wire_native.ensure_built()
    assert wire_native.available()
    rel = os.path.relpath(path, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    assert rel.startswith(os.path.join("build", "torch_native"))
    assert os.path.basename(path) == "libt2v_wire.so"


@pytest.mark.parametrize("hw", [(96, 128), (40, 56)])
def test_native_jpegs_decode_near_decode_bgr(hw):
    """JPEGs assembled from the coefficients are baseline JFIF that cv2
    decodes within 38 dB of the fused BGR decode (the bound of JAX's
    tests/test_wire_native.py). 40x56 is an odd MCU grid (3x4 MCUs over
    5x7 luma blocks), held to its size as JAX's test_odd_dims_jpeg holds
    it: at that size the blobs are edges, where libjpeg's chroma upsampling
    and the fused decoder's nearest neighbour part most."""
    h, w = hw
    yq, uq, vq = _wire_coeffs(3, h, w)
    bgr = wire_native.decode_bgr(yq, uq, vq, h, w, quality=75)
    jpegs = wire_native.to_jpegs(yq, uq, vq, h, w, quality=75)
    assert len(jpegs) == 3
    for f, data in enumerate(jpegs):
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert img is not None and img.shape == (h, w, 3)
        if hw == (96, 128):
            assert _psnr(img, bgr[f]) > 38.0


def test_decode_bgr_matches_numpy_path():
    """The fused native decode against decode_plane_np + cv2's I420->BGR
    (JAX's bound: mean |diff| < 1, above 40 dB)."""
    from text2video_tpu_torch.io.video import yuv420_to_bgr

    h, w = 96, 128
    yq, uq, vq = _wire_coeffs(3, h, w)
    ref = yuv420_to_bgr(*tdct.decode_yuv_np(yq, uq, vq, quality=75))
    out = wire_native.decode_bgr(yq, uq, vq, h, w, quality=75)
    assert out.shape == ref.shape == (3, h, w, 3)
    assert np.abs(ref.astype(int) - out.astype(int)).mean() < 1.0
    assert _psnr(ref, out) > 40.0


def _mp4_frames(path):
    cap = cv2.VideoCapture(path)
    frames = []
    ok, img = cap.read()
    while ok:
        frames.append(img)
        ok, img = cap.read()
    cap.release()
    return frames


@pytest.mark.parametrize("with_audio", [False, True])
def test_streaming_muxer_add_coeffs(tmp_path, with_audio):
    """add_coeffs writes an mp4 of every frame, its samples the native
    codec's JPEG bytes; with audio also the wav and the AVI (or the audio
    mp4 where an ffmpeg binary exists)."""
    from text2video_tpu_torch.io.video import StreamingMuxer

    h, w = 48, 64
    chunks = [_wire_coeffs(4, h, w), _wire_coeffs(3, h, w)]
    audio = (np.sin(np.arange(4480) / 5.0) * 0.2).astype(np.float32) \
        if with_audio else None
    m = StreamingMuxer(str(tmp_path / "clip"), w, h, fps=25.0, audio=audio,
                       wire_quality=75)
    for c in chunks:
        m.add_coeffs(*c)
    files = m.close()
    assert m.n_frames == 7
    frames = _mp4_frames(files[0])
    assert files[0].endswith(".mp4") and len(frames) == 7
    assert frames[0].shape == (h, w, 3)
    with open(files[0], "rb") as f:
        body = f.read()
    for c in chunks:
        for jpeg in wire_native.to_jpegs(*c, h, w, quality=75):
            assert jpeg in body
    if with_audio:
        assert len(files) == 3 and files[1].endswith(".wav")
        assert files[2].endswith((".avi", "_audio.mp4"))
    else:
        assert len(files) == 1
    assert all(os.path.getsize(f) > 0 for f in files)


# ---- the renderer's coefficient stream against JAX's -----------------------

H, W, T, BUCKET = 40, 56, 6, 4  # chroma 20x28 pads to 24x32


@pytest.fixture(scope="module")
def renderers():
    import jax
    import jax.numpy as jnp

    from text2video_tpu import config as jconfig
    from text2video_tpu.models.generator import CompositeGenerator
    from text2video_tpu.render import Renderer as JaxRenderer

    from text2video_tpu_torch.convert import params_from_flax
    from text2video_tpu_torch.render import Renderer

    gen = CompositeGenerator(base_ch=8, n_blocks=1, dtype=jnp.float32)
    params = jax.jit(gen.init)(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 9)),
                               jnp.zeros((1, H, W, 6)), jnp.ones((1,)))
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["heads"]["kernel"] *= 0.1  # see test_torch_generator
    jr = JaxRenderer(generator=gen, params=params,
                     config=jconfig.RenderConfig(wire_packed=False),
                     time_bucket=BUCKET)
    ours = {}
    for packed in (False, True):
        tr = Renderer.create(config=tconfig.RenderConfig(wire_packed=packed),
                             base_ch=8, n_blocks=1, dtype=torch.float32,
                             device="cpu")
        tr.generator.load_state_dict(params_from_flax(params), strict=True)
        tr.time_bucket = BUCKET
        ours[packed] = tr
    return jr, ours


def _label_chunks():
    labels = np.random.RandomState(5).randint(0, 256, (T, H, W, 3), np.uint8)
    full = np.concatenate([labels, np.zeros((2 * BUCKET - T, H, W, 3),
                                            np.uint8)])
    return [full[:BUCKET], full[BUCKET:]]


@pytest.fixture(scope="module")
def streams(renderers):
    import jax.numpy as jnp

    jr, ours = renderers
    chunks = _label_chunks()
    ref = list(jr.render_stream_coeffs([jnp.asarray(c) for c in chunks], T))
    out = {p: list(tr.render_stream_coeffs(
        [torch.from_numpy(c) for c in chunks], T)) for p, tr in ours.items()}
    return ref, out


def test_render_stream_coeffs_matches_jax(streams):
    """Raw int8 coefficients, f32 frames of the same weights: never more
    than 1 level apart and at least 99% equal, chunk by chunk (the carry
    crosses a chunk; the last chunk holds 2 frames)."""
    ref, out = streams
    ours = out[False]
    assert [c[0][0].shape[0] for c in ours] == [BUCKET, T - BUCKET]
    assert [hw for _, hw in ours] == [(H, W)] * 2
    n_eq = n_all = 0
    for (rc, rhw), (oc, ohw) in zip(ref, ours):
        assert tuple(rhw) == ohw
        for r, o in zip(rc, oc):
            r = np.asarray(r)
            assert o.dtype == np.int8 and o.shape == r.shape
            assert np.abs(o.astype(int) - r.astype(int)).max() <= 1
            n_eq += int((o == r).sum())
            n_all += o.size
    assert oc[1].shape[1:] == (3, 4, 6)  # 20x28 chroma, edge-padded
    assert n_eq / n_all >= 0.99, n_eq / n_all


def test_packed_stream_equals_packing_the_raw_stream(streams):
    """wire_packed only changes the bytes on the wire: the packed stream
    unpacks to the raw stream's coefficients packed and unpacked."""
    _, out = streams
    for (pc, _), (rc, _) in zip(out[True], out[False]):
        for w_ac, p, r in zip(
                (tdct.W_AC_LUMA, tdct.W_AC_CHROMA, tdct.W_AC_CHROMA), pc, rc):
            want = tdct._unpack_plane_shift_numpy(
                tdct.pack_plane_shift(torch.from_numpy(r), w_ac).numpy(),
                r.shape, w_ac)
            np.testing.assert_array_equal(p, want)


def test_dct_render_stream_yuv_matches_jax(renderers, streams):
    """The dct render_stream_yuv: the port's planes are its coefficients
    decoded and cropped, and near JAX's decoded planes."""
    import jax.numpy as jnp

    jr, ours = renderers
    _, out = streams
    chunks = _label_chunks()
    ref = list(jr.render_stream_yuv([jnp.asarray(c) for c in chunks], T))
    got = list(ours[False].render_stream_yuv(
        [torch.from_numpy(c) for c in chunks], T))
    lq, cq = tdct.quant_tables(75)
    for (coeffs, _), planes, rplanes in zip(out[False], got, ref):
        for c, q, p, r, hw in zip(coeffs, (lq, cq, cq), planes, rplanes,
                                  ((H, W), (H // 2, W // 2),
                                   (H // 2, W // 2))):
            assert p.shape == r.shape == (c.shape[0], *hw)
            np.testing.assert_array_equal(
                p, tdct.decode_plane_np(c, q)[..., :hw[0], :hw[1]])
            assert _psnr(p, np.asarray(r)) > 40.0


# ---- the pipeline's default -------------------------------------------------

@pytest.mark.parametrize("wire", ["dct", "yuv420"])
def test_synthesize_streams_the_configured_wire(monkeypatch, tmp_path, wire):
    """With the default RenderConfig, synthesize pulls coefficients through
    render_stream_coeffs and the muxer assembles JPEGs with the native
    codec; wire_format="yuv420" streams planes and encodes them with cv2."""
    from text2video_tpu_torch import pipeline
    from text2video_tpu_torch.golden import golden_pose_inputs
    from text2video_tpu_torch.io import video
    from text2video_tpu_torch.render import Renderer

    profile, pdict, table, ts = golden_pose_inputs(n_frames=6)
    port_stage = pipeline.PoseStage
    monkeypatch.setattr(
        pipeline, "PoseStage",
        lambda p, device="cpu": port_stage(p, pdict, table, device))
    calls = []

    def spy(cls, name):
        fn = getattr(cls, name)

        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)

        monkeypatch.setattr(cls, name, wrapped)

    spy(Renderer, "render_stream_coeffs")
    spy(Renderer, "render_stream_yuv")
    spy(video.wire_native, "to_jpegs")
    spy(video, "_encode_jpeg")
    config = tconfig.RenderConfig(load_size=64)
    if wire != "dct":
        config = dataclasses.replace(config, wire_format=wire)
    renderer = Renderer.create(config=config, base_ch=4, n_blocks=1,
                               dtype=torch.float32, device="cpu")
    renderer.time_bucket = 4
    cfg = tconfig.PipelineConfig(person=profile, out_dir=str(tmp_path))
    run = pipeline.Text2VideoPipeline(cfg, renderer).synthesize(ts, "utt")
    assert run.num_frames == 6
    if wire == "dct":
        assert calls.count("render_stream_coeffs") == 1
        assert calls.count("to_jpegs") == 2  # one a chunk
        assert "render_stream_yuv" not in calls and "_encode_jpeg" not in calls
    else:
        assert calls.count("render_stream_yuv") == 1
        assert calls.count("_encode_jpeg") == 6
        assert "render_stream_coeffs" not in calls and "to_jpegs" not in calls
    assert len(_mp4_frames(run.files[0])) == 6
    assert {"render", "render_pull", "mux"} <= set(run.stage_seconds)
