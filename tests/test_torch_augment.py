"""Label augmentation of the port (``train/augment.py`` and the augmented
branch of ``train_gan``) against ``text2video_tpu/train/augment.py`` on the
CPU.

``jax.random`` and ``torch.Generator`` give different numbers, so parity is
per draw: each test repeats the JAX function's own key handling, makes the
normal and uniform draws with those keys and hands them to the port's pure
functions as arrays. The drawing function is tested on its own, for its
statistics and its determinism."""

import dataclasses

import numpy as np
import pytest
import torch

from text2video_tpu_torch.golden import write_training_assets
from text2video_tpu_torch.ops import rasterize as trast
from text2video_tpu_torch.train import augment as taug
from text2video_tpu_torch.train import trainer as tt
from text2video_tpu_torch.train.data import PoseClipDataset
from text2video_tpu_torch.train.loop import train_gan

torch.set_num_threads(1)

N_PTS = (70, 25, 21, 21)
SCALE_MAX = 544.0 / 512.0 - 1.0


def _tracks(m, seed=0, spread=100.0):
    """Four keypoint tracks with every point confident but a few."""
    rng = np.random.RandomState(seed)
    out = []
    for n in N_PTS:
        t = rng.rand(m, n, 3).astype(np.float32) * spread
        t[..., 2] = 1.0
        t[rng.rand(m, n) < 0.1, 2] = 0.0
        out.append(t.reshape(m, n * 3))
    return out


def _jax_draws(key, m, jitter, drop, face_drop):
    """The draws ``text2video_tpu.train.augment.augment_tracks`` makes from
    ``key`` (augment.py:38,53-54), as the port's ``AugmentDraws``."""
    import jax

    kj, kd, kf = jax.random.split(key, 3)
    kjs, kds = jax.random.split(kj, 4), jax.random.split(kd, 4)

    def t(x):
        return torch.from_numpy(np.array(x))

    return taug.AugmentDraws(
        jitter=tuple(t(jax.random.normal(kjs[i], (m, n, 2), np.float32))
                     for i, n in enumerate(N_PTS)) if jitter else None,
        drop=tuple(t(jax.random.uniform(kds[i], (m, n, 1)))
                   for i, n in enumerate(N_PTS)) if drop else None,
        face=t(jax.random.uniform(kf, (m, 1))) if face_drop else None,
    )


@pytest.mark.parametrize("jitter,drop,face_drop", [
    (2.0, 0.0, 0.0), (0.0, 0.3, 0.0), (0.0, 0.0, 0.5), (1.5, 0.05, 0.1)])
def test_augment_tracks_matches_jax_on_the_same_draws(jitter, drop, face_drop):
    """Confidences (drop, face drop) exactly, coordinates within 1e-6."""
    import jax
    import jax.numpy as jnp

    from text2video_tpu.train.augment import augment_tracks

    m = 32
    tracks = _tracks(m)
    key = jax.random.PRNGKey(3)
    ref = augment_tracks(*map(jnp.asarray, tracks), key, drop_prob=drop,
                         jitter_px=jitter, face_drop_prob=face_drop)
    out = taug.augment_tracks(
        *map(torch.from_numpy, tracks),
        _jax_draws(key, m, jitter, drop, face_drop), drop_prob=drop,
        jitter_px=jitter, face_drop_prob=face_drop)
    changed = False
    for a, b, src, n in zip(out, ref, tracks, N_PTS):
        a = a.numpy().reshape(m, n, 3)
        b = np.asarray(b).reshape(m, n, 3)
        np.testing.assert_array_equal(a[..., 2], b[..., 2])
        np.testing.assert_allclose(a[..., :2], b[..., :2], atol=1e-6, rtol=0)
        changed |= not np.array_equal(a, src.reshape(m, n, 3))
    assert changed


def test_augment_tracks_semantics_and_draw_statistics():
    """The port's own draws: jitter moves only confident points by about
    ``jitter_px``; drops zero about ``drop_prob`` of the confidences and no
    coordinate; face drop blanks whole frames; a seeded generator repeats."""
    m = 64
    tracks = [torch.from_numpy(t) for t in _tracks(m)]
    face = tracks[0].reshape(m, 70, 3)
    gen = torch.Generator().manual_seed(0)

    d = taug.draw_augment(8, 8, gen, jitter_px=2.0)
    assert d.drop is None and d.face is None and d.crop is None
    assert [tuple(x.shape) for x in d.jitter] == [(m, n, 2) for n in N_PTS]
    f2 = taug.augment_tracks(*tracks, d, jitter_px=2.0)[0].reshape(m, 70, 3)
    moved = (f2[..., :2] - face[..., :2])
    conf = face[..., 2] > 0
    assert torch.equal(f2[..., 2], face[..., 2])
    assert (moved[~conf] == 0).all() and (moved[conf] != 0).any()
    assert 1.8 < float(moved[conf].std()) < 2.2

    d = taug.draw_augment(8, 8, gen, drop_prob=0.5)
    f3 = taug.augment_tracks(*tracks, d, drop_prob=0.5)[0].reshape(m, 70, 3)
    assert torch.equal(f3[..., :2], face[..., :2])
    assert 0.4 < float((f3[..., 2][conf] == 0).float().mean()) < 0.6

    d = taug.draw_augment(8, 8, gen, face_drop_prob=0.5)
    f4, p4, _, _ = taug.augment_tracks(*tracks, d, face_drop_prob=0.5)
    blank = (f4.reshape(m, 70, 3)[..., 2] == 0).all(dim=1)
    assert 0.2 < float(blank.float().mean()) < 0.8
    assert torch.equal(f4.reshape(m, 70, 3)[~blank], face[~blank])
    assert torch.equal(p4, tracks[1])  # only the face is blanked

    kw = dict(drop_prob=0.1, jitter_px=1.0, face_drop_prob=0.1,
              scale_crop=True)
    a = taug.draw_augment(2, 4, torch.Generator().manual_seed(5), **kw)
    b = taug.draw_augment(2, 4, torch.Generator().manual_seed(5), **kw)
    c = taug.draw_augment(2, 4, torch.Generator().manual_seed(6), **kw)
    assert a.crop.shape == (2, 2) and 0 <= float(a.crop.min()) < 1
    assert all(torch.equal(x, y) for x, y in zip(a.jitter, b.jitter))
    assert torch.equal(a.crop, b.crop) and torch.equal(a.face, b.face)
    assert not torch.equal(a.jitter[0], c.jitter[0])
    moved = a.to("cpu")
    assert torch.equal(moved.drop[1], a.drop[1]) and moved.crop is not None


def test_scale_crop_scales_match_jax():
    from text2video_tpu.train.augment import scale_crop_scales

    assert taug.scale_crop_scales(SCALE_MAX) == scale_crop_scales(SCALE_MAX)


@pytest.mark.parametrize("si", [0, 1, 2])
def test_scale_crop_matches_jax(si):
    """At scales 1, 1 + m/2, 1 + m: the resized and cropped reals within
    1e-5 on values in [-1, 1] (the frame's edges included: the crop at
    ``u`` = 0 and just under 1 takes them), the offsets equal, the
    transformed tracks and centres within 1e-5."""
    import jax.numpy as jnp

    from text2video_tpu.train.augment import (
        make_scale_crop_branches,
        scale_crop_transform_track,
    )

    b, t, h, w = 3, 2, 48, 64
    rng = np.random.RandomState(si)
    reals = (rng.rand(b, t, h, w, 3).astype(np.float32) * 2 - 1)
    u = np.array([[0.0, 0.0], [0.999999, 0.999999], [0.3, 0.7]], np.float32)
    s = taug.scale_crop_scales(SCALE_MAX)[si]
    ref_crop, ref_off, ref_s = make_scale_crop_branches(
        b, t, h, w, taug.scale_crop_scales(SCALE_MAX))[si](
            jnp.asarray(reals), jnp.asarray(u))
    crop, off = taug.scale_crop_reals(torch.from_numpy(reals),
                                      torch.from_numpy(u), s)
    assert crop.shape == (b, t, h, w, 3) and crop.is_contiguous()
    np.testing.assert_array_equal(off.numpy(), np.asarray(ref_off))
    np.testing.assert_allclose(crop.numpy(), np.asarray(ref_crop), atol=1e-5,
                               rtol=0)
    if si:
        assert off.numpy()[1].tolist() == [round(w * s) - w,
                                           round(h * s) - h]
        assert off.numpy()[0].tolist() == [0, 0]

    tracks = _tracks(b * t, seed=5, spread=float(w))
    off_flat = np.repeat(np.asarray(ref_off), t, axis=0)[:, None, :]
    zeroed = 0
    for track, n in zip(tracks, N_PTS):
        ref = np.asarray(scale_crop_transform_track(
            jnp.asarray(track), n, ref_s, jnp.asarray(off_flat), h, w))
        out = taug.scale_crop_transform_track(
            torch.from_numpy(track), n, s, torch.from_numpy(off_flat), h,
            w).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(out.reshape(-1, n, 3)[..., 2],
                                      ref.reshape(-1, n, 3)[..., 2])
        zeroed += int(((out.reshape(-1, n, 3)[..., 2] == 0)
                       & (track.reshape(-1, n, 3)[..., 2] > 0)).sum())
    assert zeroed > 0  # y runs to 64 on a 48-row canvas: points left it
    centers = rng.rand(b, t, 2).astype(np.float32) * w
    ref_c = (jnp.asarray(centers) * ref_s + (ref_s - 1.0) / 2.0
             - ref_off[:, None, :])  # text2video_tpu/train/loop.py:237
    np.testing.assert_allclose(
        taug.scale_crop_centers(torch.from_numpy(centers), s, off).numpy(),
        np.asarray(ref_c), atol=1e-5, rtol=0)


def _green_centroid(img):
    """(x, y) centroid of the green channel of [H, W, 3]: the jaw draws
    white; the rasterizer also stamps a red disk at the origin for
    all-invalid point groups, which must not pollute the measurement."""
    wgt = img[..., 1].astype(np.float64)
    ys, xs = np.mgrid[0:img.shape[0], 0:img.shape[1]]
    return (float((xs * wgt).sum() / wgt.sum()),
            float((ys * wgt).sum() / wgt.sum()))


def test_scale_crop_registration():
    """Scale/crop keeps labels and reals registered: the labels drawn from
    the transformed keypoints land where the zoomed and cropped image
    content moved (the registration test of the JAX package, on the port)."""
    h, w, m = 96, 128, 2
    face = np.zeros((m, 70, 3), np.float32)
    for i in range(17):  # the jaw chain along a diagonal inside the canvas
        face[:, i] = (40.0 + 3.0 * i, 30.0 + 1.5 * i, 1.0)
    face = torch.from_numpy(face.reshape(m, 210))
    pose, hl, hr = (torch.zeros((m, n)) for n in (75, 63, 63))
    ns = trast._round_up(max(w, h), 128)
    label1 = trast._rasterize_chunk(face, pose, hl, hr, width=w, height=h,
                                    n_samples=ns).float()
    u = torch.tensor([[0.3, 0.7]])
    for s in taug.scale_crop_scales(SCALE_MAX)[1:]:
        crop, off = taug.scale_crop_reals(label1[None], u, s)
        off_flat = off.repeat_interleave(m, dim=0)[:, None, :]
        f2 = taug.scale_crop_transform_track(face, 70, s, off_flat, h, w)
        label2 = trast._rasterize_chunk(f2, pose, hl, hr, width=w, height=h,
                                        n_samples=ns).numpy()
        for t in range(m):
            cx1, cy1 = _green_centroid(crop[0, t].numpy())
            cx2, cy2 = _green_centroid(label2[t])
            assert abs(cx1 - cx2) < 1.5 and abs(cy1 - cy2) < 1.5, (
                s, t, (cx1, cy1), (cx2, cy2))
        # The crop moved the content (not the identity).
        c0 = _green_centroid(label1[0].numpy())
        c1 = _green_centroid(crop[0, 0].numpy())
        assert abs(c0[0] - c1[0]) + abs(c0[1] - c1[1]) > 1.0


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return write_training_assets(str(tmp_path_factory.mktemp("aug")),
                                 n_frames=16, canvas=(128, 96))


def _dataset(assets, **kw):
    kw.setdefault("cache_labels", False)
    return PoseClipDataset(*assets, canvas=(128, 96),
                           source_canvas=(512, 384), clip_len=4,
                           device="cpu", **kw)


def test_augmented_labels_pixel_equal_to_jax_rasterizer(assets):
    """``augmented_batch`` on real tracks with jitter, drops, a blanked face
    and a zoom that pushes points off the canvas: its labels equal, pixel
    for pixel, the JAX rasterizer's on the same perturbed tracks, its reals
    and centres the JAX formulas'."""
    import jax.numpy as jnp

    from text2video_tpu.ops.rasterize import _rasterize_chunk, _round_up
    from text2video_tpu.train.augment import scale_crop_transform_track

    ds = _dataset(assets)
    w, h = ds.canvas
    reals_u8, centers = ds.flat_reals_centers()
    tracks = [torch.from_numpy(x) for x in ds.flat_track_arrays()]
    idx = np.stack([ds.sample_clip_indices(np.random.RandomState(1))
                    for _ in range(2)])
    b, t = idx.shape
    kw = dict(drop_prob=0.05, jitter_px=1.5, face_drop_prob=0.4)
    draws = taug.draw_augment(b, t, torch.Generator().manual_seed(2),
                              scale_crop=True, **kw)
    draws.face[0] = 0.0  # the first frame's face is blanked for certain
    draws.crop[0] = torch.tensor([0.999, 0.999])  # the far corner
    s = 1.5  # a zoom that leaves part of the face outside the window
    batch, off = taug.augmented_batch(
        tracks, torch.from_numpy(reals_u8), torch.from_numpy(centers),
        torch.from_numpy(idx), draws, ds.canvas, scale=s, **kw)
    assert batch["labels"].shape == batch["reals"].shape == (b, t, h, w, 3)
    assert batch["face_centers"].shape == (b, t, 2)
    assert not any(v.requires_grad for v in batch.values())

    # The same perturbed tracks, through the JAX transform and rasterizer.
    flat = idx.reshape(-1)
    pert = taug.augment_tracks(*(x[flat] for x in tracks), draws, **kw)
    off_flat = np.repeat(off.numpy(), t, axis=0)[:, None, :]
    moved = [scale_crop_transform_track(
        jnp.asarray(x.numpy()), n, jnp.float32(s), jnp.asarray(off_flat), h,
        w) for x, n in zip(pert, N_PTS)]
    face_conf = np.asarray(moved[0]).reshape(b * t, 70, 3)[..., 2]
    assert (face_conf[0] == 0).all()  # blanked
    gone = (face_conf == 0) & (pert[0].numpy().reshape(b * t, 70, 3)[..., 2]
                               > 0)
    assert gone[1:].any()  # points pushed off the canvas
    ref = np.asarray(_rasterize_chunk(
        *moved, width=w, height=h, n_samples=_round_up(max(w, h), 128)))
    labels_u8 = np.round((batch["labels"].numpy() + 1.0) * 127.5).astype(
        np.uint8).reshape(b * t, h, w, 3)
    np.testing.assert_array_equal(labels_u8, ref)
    assert (ref > 0).mean() > 0.002  # something was drawn
    # The blanked frame draws no white (face) pixel.
    assert not (ref[0] == 255).all(axis=-1).any()
    assert (ref[1:] == 255).all(axis=-1).any()

    # Without the zoom: labels of the perturbed tracks as they are.
    batch1, off1 = taug.augmented_batch(
        tracks, torch.from_numpy(reals_u8), torch.from_numpy(centers),
        torch.from_numpy(idx), draws, ds.canvas, **kw)
    ref1 = np.asarray(_rasterize_chunk(
        *(jnp.asarray(x.numpy()) for x in pert), width=w, height=h,
        n_samples=_round_up(max(w, h), 128)))
    np.testing.assert_array_equal(
        np.round((batch1["labels"].numpy() + 1.0) * 127.5).astype(
            np.uint8).reshape(b * t, h, w, 3), ref1)
    assert float(off1.abs().max()) == 0.0
    np.testing.assert_array_equal(
        batch1["reals"].numpy(),
        reals_u8[idx].astype(np.float32) / 127.5 - 1.0)
    np.testing.assert_array_equal(batch1["face_centers"].numpy(),
                                  centers[idx])


CFG = tt.TrainConfig(height=96, width=128, face_crop=16, base_ch=8,
                     n_blocks=1, d_base_ch=8, dtype=torch.float32)
ALL_AUG = dict(aug_jitter_px=1.5, aug_drop_prob=0.05,
               aug_face_drop_prob=0.1, aug_scale_crop=True)


def _metric_lines(log):
    return [ln.split(" | ")[0] for ln in log if ln.startswith("step ")]


@pytest.mark.parametrize("fields", [
    {"aug_jitter_px": 1.0}, {"aug_drop_prob": 0.1},
    {"aug_face_drop_prob": 0.1}, {"aug_scale_crop": True}, ALL_AUG],
    ids=["jitter", "drop", "face_drop", "scale_crop", "all"])
def test_train_gan_with_label_augmentation(assets, fields):
    """Two augmented steps on device data: finite metrics, the augmented
    branch logged, and a second run from the same seed repeats them."""
    cfg = dataclasses.replace(CFG, **fields)
    runs = []
    for _ in range(2):
        log = []
        state = train_gan(_dataset(assets), cfg, steps=2, batch_size=2,
                          seed=3, log_every=1, device_data=True,
                          log_fn=log.append, device="cpu")
        assert state.step == 2
        assert any("device-resident dataset (augmented)" in ln for ln in log)
        lines = _metric_lines(log)
        assert len(lines) == 2 and "g_loss=" in lines[0]
        assert "nan" not in " ".join(lines) and "inf" not in " ".join(lines)
        runs.append(lines)
    assert runs[0] == runs[1]


def test_train_gan_ignores_augmentation_on_host_data(assets):
    """Without ``device_data`` the flags change nothing (as in the JAX loop),
    and ``aug_scale_crop`` says so in the JAX loop's words."""
    logs = {}
    for name, cfg in (("plain", CFG),
                      ("aug", dataclasses.replace(CFG, **ALL_AUG))):
        logs[name] = []
        train_gan(_dataset(assets, cache_labels=True), cfg, steps=1,
                  batch_size=1, seed=3, log_every=1,
                  log_fn=logs[name].append, device="cpu")
    assert _metric_lines(logs["plain"]) == _metric_lines(logs["aug"])
    assert not any("augmented" in ln for ln in logs["aug"])
    assert ("aug_scale_crop requires --device-data (labels re-rasterize on "
            "device from the transformed tracks); ignoring the flag"
            ) in logs["aug"]
    assert not any("aug_scale_crop" in ln for ln in logs["plain"])
