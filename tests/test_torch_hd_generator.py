"""The coarse-to-fine generator (pix2pixHD's global trunk at half resolution
and one local enhancer) on the port's serving path, against the
benchmark's plain reference (``benchmark/reference/hd.py``: plain PyTorch,
float32, written from the model's description) on seeded random weights at
a small size: one forward in either form, the batched scan stepped from the
program's own carry, and a renderer checkpoint's round trip. The JAX package's local enhancer is held against the
port in ``tests/test_torch_generator.py``; the replayed step on a card in
``tests/test_torch_step_graph.py``."""

import json

import numpy as np
import pytest
import torch

from benchmark.lib import weights
from benchmark.reference.hd import generator_shapes, reference_generator
from text2video_tpu_torch import checkpoints as ckpt
from text2video_tpu_torch import config as tconfig
from text2video_tpu_torch.config import RenderConfig
from text2video_tpu_torch.models.generator import CompositeGenerator
from text2video_tpu_torch.render import Renderer, _quantize_u8

torch.set_num_threads(1)

H, W, BASE, BLOCKS, LOCAL_BLOCKS = 32, 48, 8, 1, 3
T, BUCKET = 6, 4  # two chunks, the second partial: the carry crosses
# f32 on both sides, summed in other orders: the port's phase forms and the
# reference's full-resolution convs part by a few ulps of activations of
# order 1 (7.8e-6 seen); with the heads at 0.03 of lecun the flows stay
# near a pixel, where f32 resolves the warp to ~1e-5.
ATOL = 2e-5


def _cfg(local: int = 1) -> dict:
    return {"base_ch": BASE, "n_downsample": 3, "n_blocks": BLOCKS,
            "local_enhancers": local, "local_blocks": LOCAL_BLOCKS}


def _state(local: int = 1, seed: int = 2147483651) -> dict:
    # The heads at 0.03 of lecun, as the benchmark's HD configuration draws
    # them: flows of about a pixel, not ~30.
    return weights.make(generator_shapes(_cfg(local)), seed, "cpu",
                        {"heads.kernel": 0.03})


def _inputs(seed=1, b=2, size=(H, W)):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((b, *size, 9), generator=g) * 2 - 1,
            torch.rand((b, *size, 6), generator=g) * 2 - 1,
            torch.tensor([0.0, 1.0][:b]))


def _labels_u8(b=2, t=T, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (b, t, H, W, 3), np.uint8))


def _renderer(local: int = 1, state=None) -> Renderer:
    tr = Renderer.create(config=RenderConfig(), base_ch=BASE,
                         n_blocks=BLOCKS, dtype=torch.float32, device="cpu",
                         n_local_enhancers=local,
                         n_local_blocks=LOCAL_BLOCKS)
    tr.generator.load_state_dict(state or _state(local), strict=True)
    tr.time_bucket = BUCKET
    return tr


@pytest.mark.parametrize("phase_form,local", [
    (True, 1), (False, 1),
    (True, 2),  # the second enhancer merges the first's base_ch / 2
])
def test_forward_matches_the_reference(phase_form, local):
    state = _state(local)
    gen = CompositeGenerator(15, base_ch=BASE, n_blocks=BLOCKS,
                             dtype=torch.float32, n_local_enhancers=local,
                             n_local_blocks=LOCAL_BLOCKS,
                             phase_form=phase_form)
    gen.load_state_dict(state, strict=True)
    assert len(gen.local) == local
    assert len(gen.local[0].res) == LOCAL_BLOCKS
    ref = reference_generator(_cfg(local), "f32", state, "cpu")
    # The trunk's 3 downsamples at 1 / 2**local of the canvas.
    args = _inputs(size=(H << (local - 1), W << (local - 1)))
    with torch.inference_mode():
        got, want = gen.eval()(*args), ref(*args)
    for name, o, r in zip(("frame", "flow", "mask"), got, want):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o.numpy(), r.numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)
    assert want[1].abs().max() > 0.5  # the warp is exercised
    assert torch.all(want[2][0] == 1.0)  # has_prev 0 forces the mask open


def test_render_many_device_steps_match_the_reference():
    """Every step of a batched scan over two chunks, recomputed by the
    reference from the inputs the program fed it; the carry is the
    program's own frames, bit for bit, and the uint8 frames returned are
    the steps' frames quantized."""
    state = _state()
    tr = _renderer(state=state)
    steps = []
    tr.generator.register_step_tap(
        lambda *a: steps.append(tuple(x.clone() for x in a)))
    frames = tr.render_many_device(_labels_u8())
    assert frames.shape == (2, T, H, W, 3) and frames.dtype == np.uint8
    assert len(steps) == T
    ref = reference_generator(_cfg(), "f32", state, "cpu")
    for t, (labels, prev, has_prev, frame) in enumerate(steps):
        assert has_prev.tolist() == [float(t > 0)] * 2
        want = [steps[t - k][3] if t >= k else torch.zeros_like(frame)
                for k in (1, 2)]
        assert torch.equal(prev, torch.cat(want, dim=-1))
        with torch.inference_mode():
            np.testing.assert_allclose(
                frame.numpy(), ref(labels, prev, has_prev)[0].numpy(),
                atol=ATOL, rtol=0, err_msg=f"step {t}")
        assert np.array_equal(frames[:, t], _quantize_u8(frame).numpy())
    assert frames.std() > 1.0


@pytest.mark.parametrize("local", [0, 1])
def test_renderer_checkpoint_round_trip(local, tmp_path):
    """``save_renderer`` records the enhancers where the generator has one
    (a meta without them reads as none), and ``load_renderer`` builds the
    same generator and loads it under ``strict=True``."""
    tr = _renderer(local)
    path = str(tmp_path / "ckpt")
    ckpt.save_renderer(tr, path, height=H)
    meta = {"base_ch": BASE, "n_blocks": BLOCKS, "height": H}
    if local:
        meta.update(n_local_enhancers=local, n_local_blocks=LOCAL_BLOCKS)
    assert ckpt.load_config(path) == meta
    with open(tmp_path / "ckpt" / "config.json") as f:
        assert json.load(f) == meta
    loaded = ckpt.load_renderer(path, tconfig.get_profile("henan"),
                                device="cpu")
    gen = loaded.generator
    assert len(gen.local) == local and gen.dtype == torch.bfloat16
    if local:
        assert len(gen.local[0].res) == LOCAL_BLOCKS
    want = tr.generator.state_dict()
    assert gen.state_dict().keys() == want.keys()
    assert all(torch.equal(v, want[k]) for k, v in gen.state_dict().items())
    loaded.time_bucket = BUCKET
    frames = loaded.render_many_device(_labels_u8(b=1))
    assert frames.shape == (1, T, H, W, 3) and frames.std() > 1.0
