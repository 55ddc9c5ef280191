"""The port's bit-exact host drawing (``text2video_tpu_torch/ops/
rasterize.py::rasterize_frame_host``) against the pixels the original
pipeline drew (the golden PNGs in ``tests/goldens/fadg0_Shehadyour``) and
against the JAX package's host drawing; the port's device drawing on the CPU
against it at the JAX package's SSIM bound (``tests/test_rasterize.py``)."""

import json
import os

import cv2
import numpy as np
import pytest

from text2video_tpu.ops import rasterize as jr
from text2video_tpu_torch.io.openpose import frame_from_raw
from text2video_tpu_torch.ops import rasterize as tr

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
FADG0 = os.path.join(GOLDENS, "fadg0_Shehadyour")
HENAN = os.path.join(GOLDENS, "henan_111", "pose")
SIZE = (512, 384)
HENAN_SIZE = (1920, 1080)


def _frame(path):
    with open(path) as f:
        return frame_from_raw(json.load(f))


def _draw(mod, kf, size):
    return mod.rasterize_frame_host(kf.face, kf.pose, kf.hand_l, kf.hand_r,
                                    size)


GOLDEN_PNGS = [(sub_json, sub_png, os.path.splitext(name)[0])
               for sub_json, sub_png in (("pose", "png"),
                                         ("pose_smooth", "png_smooth"))
               for name in sorted(os.listdir(os.path.join(FADG0, sub_png)))]


@pytest.mark.parametrize("sub_json,sub_png,stem", GOLDEN_PNGS)
def test_host_drawing_pixel_equal_golden_png(sub_json, sub_png, stem):
    """The 22 frames the original pipeline drew (raw and smoothed poses)."""
    kf = _frame(os.path.join(FADG0, sub_json, stem + ".json"))
    golden = cv2.imread(os.path.join(FADG0, sub_png, stem + ".png"))
    np.testing.assert_array_equal(_draw(tr, kf, SIZE), golden)


def test_host_drawing_byte_equal_jax_on_golden_poses():
    """All 87 golden pose frames at 512x384."""
    names = sorted(os.listdir(os.path.join(FADG0, "pose")))
    assert len(names) == 87
    for name in names:
        kf = _frame(os.path.join(FADG0, "pose", name))
        np.testing.assert_array_equal(_draw(tr, kf, SIZE),
                                      _draw(jr, kf, SIZE), err_msg=name)


def test_host_drawing_zero_keypoints_corner_circles():
    """No segment drawn; both hand centres sit at (0, 0), where the blue
    circle lands last (the reference's quirk), as in JAX."""
    face, pose, hand = np.zeros(210), np.zeros(75), np.zeros(63)
    out = tr.rasterize_frame_host(face, pose, hand, hand, SIZE)
    np.testing.assert_array_equal(
        out, jr.rasterize_frame_host(face, pose, hand, hand, SIZE))
    assert out[0, 0].tolist() == [255, 0, 0]
    assert not out[100:, 100:].any()


def test_host_drawing_uint8_wraparound():
    """``rasterize_frame_host`` adds the person onto a zero canvas with
    uint8 ``+=``: equal to ``rasterize_person_host`` and to JAX's."""
    kf = _frame(os.path.join(FADG0, "pose", "00040.json"))
    person = tr.rasterize_person_host(kf.pose.reshape(25, 3),
                                      kf.face.reshape(70, 3),
                                      kf.hand_l.reshape(21, 3),
                                      kf.hand_r.reshape(21, 3), SIZE)
    np.testing.assert_array_equal(_draw(tr, kf, SIZE), person)
    np.testing.assert_array_equal(person, jr.rasterize_person_host(
        kf.pose.reshape(25, 3), kf.face.reshape(70, 3),
        kf.hand_l.reshape(21, 3), kf.hand_r.reshape(21, 3), SIZE))


def _henan_frames():
    names = sorted(os.listdir(HENAN))[:2]
    return [_frame(os.path.join(HENAN, n)) for n in names]


def test_host_drawing_byte_equal_jax_henan_1080p():
    """Two henan frames at 1920x1080 (hands, long segments)."""
    for kf in _henan_frames():
        np.testing.assert_array_equal(_draw(tr, kf, HENAN_SIZE),
                                      _draw(jr, kf, HENAN_SIZE))


def test_tables_equal_jax():
    assert tr.HAND_SUBEDGES == jr.HAND_SUBEDGES == jr.hand_subedges()
    assert tr.FACE_SUBEDGES == jr.FACE_SUBEDGES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_validate_equal_jax(seed):
    """Seeded keypoints whose confidences straddle every threshold."""
    rng = np.random.RandomState(seed)
    for n, fn in ((25, "validate_pose"), (70, "validate_face"),
                  (21, "validate_hand")):
        pts = rng.uniform(0, 500, (n, 3))
        pts[:, 2] = rng.choice([0.0, 0.005, 0.01, 0.02, 0.1, 0.11, 0.9], n)
        out = getattr(tr, fn)(pts)
        np.testing.assert_array_equal(out, getattr(jr, fn)(pts))
        assert out.shape == (n, 2)


def _tracks(kfs):
    return [np.stack([getattr(k, a) for k in kfs])
            for a in ("face", "pose", "hand_l", "hand_r")]


@pytest.mark.parametrize("which", ["fadg0_png", "henan_1080p"])
def test_device_drawing_on_cpu_ssim_against_host(which):
    """The port's device drawing (``rasterize_batch``, ``device="cpu"``)
    against its host drawing, frame by frame, at the JAX package's bound:
    the 11 golden PNG frames at 512x384 and two henan frames at
    1920x1080."""
    if which == "fadg0_png":
        size = SIZE
        kfs = [_frame(os.path.join(FADG0, "pose", stem + ".json"))
               for _, sub_png, stem in GOLDEN_PNGS if sub_png == "png"]
    else:
        size, kfs = HENAN_SIZE, _henan_frames()
    imgs = tr.rasterize_batch(*_tracks(kfs), size, chunk=len(kfs),
                              device="cpu")
    for img, kf in zip(imgs, kfs):
        s = tr.whole_ssim(img, _draw(tr, kf, size))
        assert s >= tr.SSIM_MIN, s
