"""Batched serving's frames on their way to the host
(``render.py::Renderer._scan_rows``): on a card the call's uint8 frames come
back in one copy into pinned host memory. Tests marked ``card`` hold them
bit-equal to the device's; they skip where there is no CUDA card (decided
inside the test). This file imports neither JAX nor the JAX package, so the
card's tests run on the card's machine with
``python -m pytest --noconftest -m card tests/test_torch_frames_pull.py``."""

import numpy as np
import pytest
import torch

from text2video_tpu_torch.config import RenderConfig
from text2video_tpu_torch.render import Renderer


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_renderer(dev) -> Renderer:
    tr = Renderer.create(config=RenderConfig(), seed=0, device=dev)
    # A tenth of the lecun heads keeps flows at a few pixels, as trained
    # weights have them (a 30 px flow turns the frames to noise).
    with torch.no_grad():
        tr.generator.heads.kernel.mul_(0.1)
    tr.time_bucket = 4
    return tr


@pytest.mark.card
@pytest.mark.parametrize("batch,h,w", [(1, 384, 512), (4, 512, 896)])
def test_pinned_pull_bit_equals_the_device_frames(batch, h, w):
    dev = _card()
    tr = _card_renderer(dev)
    t = 2 * tr.time_bucket + 2  # two chunks and a partial one
    rng = np.random.RandomState(batch)
    host_labels = rng.randint(0, 256, (batch, t, h, w, 3), np.uint8)
    labels = torch.from_numpy(host_labels).to(dev)
    want = tr.generate_device(labels).cpu().numpy()
    got = tr.render_many_device(labels)
    assert got.shape == want.shape == (batch, t, h, w, 3)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert torch.from_numpy(got).is_pinned()
    # Back to back, the second call's pull lands in another block, and the
    # host labels take the same path.
    again = tr.render_many_device(labels)
    assert np.array_equal(again, got)
    assert np.array_equal(tr.render_many(host_labels), got)
    assert got.std() > 1.0  # not a constant image
