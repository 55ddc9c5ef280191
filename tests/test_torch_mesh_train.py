"""Data-parallel training in the port over two gloo ranks on the CPU
(``tests/torch_mesh_workers.py::train_ops``, one spawn with a deadline): one
step from a converted JAX ``TrainerState`` against the port's single-process
step and against the JAX package's step with the batch sharded over a
2-device "data" axis (the ``n_data=2`` analogue of
``tests/test_train_step.py::test_train_step_sharded_matches_single_device``);
then ``train-gan`` run twice over the ranks through the CLI, and its
checkpoint read by one process."""

import json
import os

import numpy as np
import pytest
import torch
from torch_train_parity import (
    BASE,
    CFG,
    KINK_MARGIN,
    _batch,
    _check_grads,
    _check_params,
    _discs_from_flax,
    _jax_state_and_step,
    _to_np,
    _torch_batch,
    photometric_margin,
)

from text2video_tpu_torch import checkpoints
from text2video_tpu_torch.convert import params_from_flax
from text2video_tpu_torch.parallel import spawn
from text2video_tpu_torch.train import trainer as tt

torch.set_num_threads(1)

WORLD = 2
SPAWN_TIMEOUT_S = 300.0
TRAIN_ARGS = ["--width", "128", "--height", "96", "--source-width", "512",
              "--source-height", "384", "--clip-len", "4", "--base-ch", "8",
              "--batch-size", "2", "--device-data", "--device", "cpu"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the JAX state before, the JAX sharded step's state after, its
    metrics, the batch, the ranks' output directory, the training set)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from text2video_tpu.parallel.mesh import make_mesh

    from text2video_tpu_torch.convert import trainer_state_from_flax
    from text2video_tpu_torch.golden import write_training_assets

    root = tmp_path_factory.mktemp("train")
    # Seed 0's batch put an element of the flow loss 8.9e-7 from its kink.
    batch = _batch(b=2 * WORLD, t=4, seed=4)
    state, step = _jax_state_and_step({})
    mesh = make_mesh(n_data=WORLD, n_model=1)
    repl = NamedSharding(mesh, P())
    after, metrics = step(
        jax.device_put(state, repl),
        {k: jax.device_put(v, NamedSharding(mesh, P("data")))
         for k, v in batch.items()})
    before = _to_np(state)

    checkpoints.save_state(str(root / "init"),
                           trainer_state_from_flax(before, CFG, device="cpu"),
                           CFG)
    with open(root / "cfg.json", "w") as f:
        json.dump(BASE, f)
    np.savez(root / "batch.npz", **batch)
    images, keypoints = write_training_assets(str(root / "data"), 24,
                                              (128, 96))
    with open(root / "train_argv.json", "w") as f:
        json.dump(["train-gan", "--images", images, "--keypoints",
                   keypoints, "--steps", "2"] + TRAIN_ARGS, f)
    out = root / "out"
    out.mkdir()
    spawn("torch_mesh_workers:train_ops", WORLD,
          (str(root / "store"), str(root), str(out)),
          timeout_s=SPAWN_TIMEOUT_S)
    ranks = [dict(np.load(out / f"step_rank{r}.npz")) for r in range(WORLD)]
    return dict(before=before, after=_to_np(after),
                metrics={k: float(v) for k, v in metrics.items()},
                batch=batch, ranks=ranks, out=str(out),
                data=(images, keypoints))


def _named(got, prefix):
    return [(k[len(prefix):], torch.from_numpy(v)) for k, v in got.items()
            if k.startswith(prefix)]


class _Param:
    """A (name, tensor) pair as ``_check_grads`` reads a parameter."""

    def __init__(self, value, grad):
        self.value, self.grad = value, grad

    def detach(self):
        return self.value


def _params(got, net):
    grads = dict(_named(got, f"{net}.grad."))
    return [(k, _Param(v, grads[k])) for k, v in _named(got, f"{net}.")
            if not k.startswith("grad.")]


def test_dp_step_ranks_agree_and_match_single_process(run):
    """Both ranks hold the same bits after the step. Against one process
    stepping the whole batch of 4 from the same state, in f32: metrics within
    rtol 1e-5 (measured ~1e-7: the mean of two means of 2 against one mean of
    4), every gradient within 1e-5 of its tensor's largest (measured 3.5e-6),
    and the Adam update as ``_check_params`` bounds it (a near-zero gradient
    may flip sign and move its weight by 2 lr)."""
    from text2video_tpu_torch.convert import trainer_state_from_flax

    a, b = run["ranks"]
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    state = trainer_state_from_flax(run["before"], CFG, device="cpu")
    state, metrics = tt.make_train_step(CFG)(state, _torch_batch(run["batch"]))
    for k, v in metrics.items():
        np.testing.assert_allclose(float(a["metric." + k]), float(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for net, mod in (("G", state.generator), ("D", state.discriminators)):
        named = list(mod.named_parameters())
        ref = {k: p.grad for k, p in named}
        floor = 1e-2 * max(float(g.abs().max()) for g in ref.values())
        for k, g in _named(a, f"{net}.grad."):
            scale = max(float(ref[k].abs().max()), floor)
            assert float((g - ref[k]).abs().max()) <= 1e-5 * scale, (net, k)
        _check_params(_params(a, net), {k: p.detach() for k, p in named},
                      CFG.lr, net)


def test_dp_step_matches_jax_sharded_step(run):
    """Against the JAX package's step with the batch sharded over a 2-device
    "data" axis: metrics at that test's bound (rtol 2e-3, atol 2e-5), G and D
    gradients (Adam's first moment / (1 - beta1)) and the updated weights at
    ``tests/torch_train_parity.py``'s."""
    assert photometric_margin(run["before"], run["batch"]) > KINK_MARGIN
    a = run["ranks"][0]
    for k, ref in run["metrics"].items():
        np.testing.assert_allclose(float(a["metric." + k]), ref, rtol=2e-3,
                                   atol=2e-5, err_msg=k)
    after = run["after"]
    g_ref = {k: v / (1 - CFG.beta1)
             for k, v in params_from_flax(after.g_opt[0].mu).items()}
    _check_grads(_params(a, "G"), g_ref, "G")
    _check_params(_params(a, "G"), params_from_flax(after.g_params), CFG.lr,
                  "G")
    d_ref = {k: v / (1 - CFG.beta1)
             for k, v in _discs_from_flax(after.d_opt[0].mu).items()}
    d_named = [(k, p) for k, p in _params(a, "D")
               if not k.startswith("temporal2.")]  # no clip reaches it at T=4
    _check_grads(d_named, d_ref, "D")


def _state(ckpt_dir):
    path = os.path.join(checkpoints.latest_step_dir(ckpt_dir),
                        checkpoints.STATE_NAME)
    return torch.load(path, map_location="cpu", weights_only=True)


def _equal(x, y) -> bool:
    if isinstance(x, torch.Tensor):
        return torch.equal(x, y)
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_equal(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(_equal(p, q) for p, q in zip(x, y))
    return x == y


@pytest.mark.parametrize("rank", range(WORLD))
def test_dp_step_records_the_gradient_sync(run, rank):
    """Traced, each rank's step records its phases under ``train.step``,
    the gradient sync over the data axis between the backward passes and
    the optimizer."""
    with open(os.path.join(run["out"], f"spans_rank{rank}.json")) as f:
        spans = json.load(f)
    assert spans == ["train.g_forward", "train.g_backward",
                     "train.d_forward", "train.d_backward",
                     "train.grad_sync", "train.optimizer"]


def test_dp_train_gan_repeats(run):
    """``train-gan`` over the ranks (the CLI under a process group that is
    already up), twice from seed 0: rank 0's checkpoints hold bit-equal
    weights and Adam moments at step 2."""
    a = _state(os.path.join(run["out"], "dp_a"))
    b = _state(os.path.join(run["out"], "dp_b"))
    assert a["step"] == b["step"] == 2
    assert _equal(a, b)


def test_dp_checkpoint_loads_in_one_process(run, tmp_path):
    """Rank 0's directory serves in a single-process ``load_renderer`` and a
    single-process ``train-gan`` resumes from it."""
    import shutil

    from text2video_tpu_torch import cli
    from text2video_tpu_torch.config import get_profile

    src = os.path.join(run["out"], "dp_a")
    r = checkpoints.load_renderer(src, get_profile("fadg0"), device="cpu")
    labels = np.random.RandomState(0).randint(0, 256, (3, 96, 128, 3),
                                              np.uint8)
    frames = r.render(labels)
    assert frames.shape == (3, 96, 128, 3) and frames.std() > 0
    ckpt = str(tmp_path / "resume")
    shutil.copytree(src, ckpt)
    images, keypoints = run["data"]
    assert cli.main(["train-gan", "--images", images, "--keypoints",
                     keypoints, "--steps", "1", "--ckpt", ckpt]
                    + TRAIN_ARGS) == 0
    assert _state(ckpt)["step"] == 3


def test_train_gan_model_axis_raises(run):
    """A single process asked for a model axis (``--n-model 2``,
    ``train_gan(n_model=2)``) raises ``ValueError`` naming torchrun: the
    axis needs several processes (``tests/test_torch_mesh_model.py`` runs
    it over four)."""
    from text2video_tpu_torch import cli
    from text2video_tpu_torch.train.loop import train_gan

    images, keypoints = run["data"]
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(["train-gan", "--images", images, "--keypoints", keypoints,
                  "--steps", "1", "--ckpt", "unused", "--n-model", "2"]
                 + TRAIN_ARGS)
    with pytest.raises(ValueError, match="torchrun"):
        train_gan(None, CFG, n_model=2, device="cpu")


def test_augmented_rows_are_the_global_batch_rows(run):
    """A data-parallel rank keeps its clips of the global augmented batch:
    ``augmented_batch`` on rank r's indices with ``draws.rows`` (jitter,
    drops, face drops, zoom and crop) gives exactly rows r of the batch made
    whole, as one process makes it."""
    from text2video_tpu_torch.train import augment as aug
    from text2video_tpu_torch.train.data import PoseClipDataset

    images, keypoints = run["data"]
    ds = PoseClipDataset(images, keypoints, canvas=(128, 96),
                         source_canvas=(512, 384), clip_len=4,
                         cache_labels=False, device="cpu")
    reals, centers = (torch.from_numpy(x) for x in ds.flat_reals_centers())
    tracks = [torch.from_numpy(x) for x in ds.flat_track_arrays()]
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(np.stack([ds.sample_clip_indices(rng)
                                     for _ in range(4)]))
    kw = dict(drop_prob=0.1, jitter_px=1.5, face_drop_prob=0.2)
    scale = aug.scale_crop_scales(544.0 / 512.0 - 1.0)[-1]
    draws = aug.draw_augment(4, 4, torch.Generator().manual_seed(0),
                             scale_crop=True, **kw)
    whole, _ = aug.augmented_batch(tracks, reals, centers, idx, draws,
                                   (128, 96), scale=scale, **kw)
    for r in range(WORLD):
        rows = slice(2 * r, 2 * r + 2)
        part, _ = aug.augmented_batch(tracks, reals, centers, idx[rows],
                                      draws.rows(rows, 4), (128, 96),
                                      scale=scale, **kw)
        for k, v in part.items():
            assert torch.equal(v, whole[k][rows]), k
