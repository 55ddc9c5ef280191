"""The port's device rasterizer against the JAX device path: exact."""

import numpy as np
import torch

from text2video_tpu_torch.golden import golden_table
from text2video_tpu_torch.ops import rasterize as trast

torch.set_num_threads(1)


def test_rasterize_golden_frames_exact():
    """All 87 golden pose frames at 512x384, chunk 32 (last chunk padded):
    every pixel equal to text2video_tpu.ops.rasterize.rasterize_batch."""
    from text2video_tpu.ops.rasterize import rasterize_batch

    table = golden_table()
    args = (table.face, table.pose, table.hands[:, 0], table.hands[:, 1])
    ref = rasterize_batch(*args, (512, 384), chunk=32)
    chunks = trast.rasterize_batch(*args, (512, 384), chunk=32, to_host=False,
                                   device="cpu")
    assert [tuple(c.shape) for c in chunks] == [(32, 384, 512, 3)] * 3
    out = torch.cat(chunks).numpy()
    assert out.dtype == np.uint8
    assert (out[:87] > 0).mean() > 0.005  # a skeleton was drawn
    np.testing.assert_array_equal(out[:87], ref)


def test_rasterize_zero_keypoints_corner_circles():
    """No valid keypoint: only the two hand-centre circles at (0, 0) (the
    reference's quarter-disk artefact), equal to the JAX path."""
    from text2video_tpu.ops.rasterize import rasterize_batch

    t = 3
    args = (np.zeros((t, 210)), np.zeros((t, 75)), np.zeros((t, 63)),
            np.zeros((t, 63)))
    ref = rasterize_batch(*args, (64, 48), chunk=4)
    out = trast.rasterize_batch(*args, (64, 48), chunk=4, device="cpu")
    np.testing.assert_array_equal(out, ref)
    drawn = out.any(axis=-1)
    assert drawn[:, :6, :6].all() and not drawn[:, 9:, :].any()
    # The right-hand circle (blue, drawn last) overwrites the left (green).
    np.testing.assert_array_equal(out[0, 0, 0], [255, 0, 0])


def test_rasterize_small_canvas_matches_jax():
    """fadg0's keypoints (512x384 coordinates) drawn on a 64x64 canvas:
    segments longer than the 128-sample budget have no sample n-1. The JAX
    path's take_along_axis fills that endpoint with INT32_MIN and its int32
    disk stamp wraps and clips it onto the canvas edges; the port's labels
    are pixel-equal to that, corners included."""
    from text2video_tpu.ops.rasterize import rasterize_batch

    table = golden_table()
    sel = slice(0, 16)
    args = (table.face[sel], table.pose[sel], table.hands[sel, 0],
            table.hands[sel, 1])
    pose = table.pose[sel].reshape(16, 25, 3)
    span = np.abs(pose[:, 1, :2] - pose[:, 8, :2]).max(axis=-1)
    assert (span > 128).all()  # the trunk outruns the sample budget
    ref = rasterize_batch(*args, (64, 64), chunk=16)
    out = trast.rasterize_batch(*args, (64, 64), chunk=16, device="cpu")
    assert out.shape == ref.shape == (16, 64, 64, 3)
    np.testing.assert_array_equal(out, ref)
    assert out[:, -1, -1].any(axis=-1).all()  # a disk stamped at the edge
