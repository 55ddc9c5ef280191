"""GAN training loop: steps, metrics, checkpoints (counterpart of
``text2video_tpu/train/loop.py`` on one device).

The reference trains vid2vid with ``train.py --dataset_mode pose ...
--batchSize 8``. Here: the train step of ``train/trainer.py``, host-side
clip sampling (``train/data.py``), wall-clock and loss logging, periodic
saves with auto-resume (``checkpoints.py``), and with ``device_data`` the
augmented branch: keypoint tracks resident on the device, perturbed and drawn
into label maps every step (``train/augment.py``).

Over several processes (torchrun, or a process group the caller started) the
run is data-parallel over a mesh's "data" axis, as the JAX package shards its
batch: every rank draws the same global batch from the seeded sampler (and the
same augmentation draws), keeps its rows, and the step averages the gradients
over the ranks in a fixed order (``train/trainer.py``), so every rank holds the
same weights. Rank 0 logs, saves checkpoints and snapshots; every rank resumes.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from text2video_tpu_torch import checkpoints as ckpt
from text2video_tpu_torch import device as devices
from text2video_tpu_torch.parallel import mesh as meshes
from text2video_tpu_torch.train import augment as aug
from text2video_tpu_torch.train import trainer
from text2video_tpu_torch.train.data import PoseClipDataset
from text2video_tpu_torch.train.trainer import (
    TrainConfig,
    TrainerState,
    create_trainer_state,
    make_train_step,
)


class _StallWatchdog:
    """Ends the process when training stops making progress.

    A device call that never returns hangs the blocking read inside the step
    loop, and no Python-level timeout can interrupt it. The watchdog thread
    exits the process (code 3) when no progress is petted within ``timeout``
    seconds; with the loop's auto-resume, an outer retry
    (``until train-gan ...; do :; done`` keyed on the exit code) turns a hang
    into a bounded delay instead of a lost run.
    """

    EXIT_CODE = 3
    # The dataset upload and the first step come before the first pet.
    FIRST_DEADLINE_EXTRA = 1800.0

    def __init__(self, timeout: float, log_fn: Callable[[str], None]):
        self.timeout = timeout
        self.log_fn = log_fn
        self._lock = threading.Lock()
        self._deadline = time.time() + timeout + self.FIRST_DEADLINE_EXTRA
        self._stopped = False
        threading.Thread(target=self._run, daemon=True).start()

    def pet(self) -> None:
        with self._lock:
            self._deadline = time.time() + self.timeout

    def stop(self) -> None:
        with self._lock:
            self._stopped = True

    def _run(self) -> None:
        while True:
            time.sleep(5.0)
            with self._lock:
                if self._stopped:
                    return
                if time.time() > self._deadline:
                    self.log_fn(
                        f"watchdog: no training progress in "
                        f"{self.timeout:.0f}s, exiting {self.EXIT_CODE} for "
                        "resume")
                    os._exit(self.EXIT_CODE)


def _to_device(batch: Dict[str, np.ndarray],
               device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``; for a card, through pinned memory with
    asynchronous copies (the step's first kernel waits for them on the
    stream)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def _quiet(_: str) -> None:
    """The log of a rank other than 0: nothing."""


# Step i of a run draws from generators seeded with this stride times
# (seed + 1) plus i: no two steps of a run share a stream.
_AUG_SEED_STRIDE = 1_000_003


def _unit(x_u8: torch.Tensor) -> torch.Tensor:
    return x_u8.float() / 127.5 - 1.0


def distributed() -> bool:
    """Whether this process is one of several: a process group is up, or
    torchrun's environment names a world."""
    return dist.is_available() and (dist.is_initialized()
                                    or "WORLD_SIZE" in os.environ)


def _data_mesh(batch_size: int, n_data: Optional[int], n_model: int, device,
               log_fn: Callable[[str], None]):
    """The training mesh of a distributed run (``meshes.make_mesh``), with
    the JAX package's default for ``n_data``: the largest divisor of the
    batch that fits the processes. None on a process outside it."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ["WORLD_SIZE"]))
    if n_data is None:
        avail = max(world // n_model, 1)
        n_data = max(d for d in range(1, avail + 1) if batch_size % d == 0)
    mesh = meshes.make_mesh(n_data=n_data, n_model=n_model, device=device)
    if mesh is None:
        log_fn(f"rank {dist.get_rank()} of {world} is outside the "
               f"{n_data}-way data mesh; leaving")
    return mesh


def train_gan(
    dataset: PoseClipDataset,
    cfg: Optional[TrainConfig] = None,
    steps: int = 1000,
    batch_size: int = 2,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    save_every: int = 200,
    log_every: int = 10,
    n_data: Optional[int] = None,
    n_model: int = 1,
    device_data: bool = False,
    sample_every: int = 0,
    stall_timeout: float = 0.0,
    vgg_params=None,
    log_fn: Callable[[str], None] = print,
    device=None,
) -> Optional[TrainerState]:
    """Train the pose2frame GAN on ``device`` (the card unless the caller
    names another); returns the final state.

    ``device_data=True`` keeps the whole dataset resident on the device as
    uint8 (one upload) and gathers clips by index there, so a step moves only
    a [B, T] index array; the dataset must fit the device's memory. Otherwise
    each batch is made on the host and copied through pinned memory.

    With ``device_data`` and any of ``cfg.aug_jitter_px``, ``aug_drop_prob``,
    ``aug_face_drop_prob``, ``aug_scale_crop`` set, the keypoint tracks stay
    on the device instead of the label maps, and every step perturbs them
    and draws its labels there (``train/augment.py``); the draws of step
    ``i`` are seeded from ``seed + 1`` and ``i``. Without ``device_data``
    these fields are ignored.

    With ``ckpt_dir`` the run resumes from the newest finished step there,
    saves every ``save_every`` steps and at the end, and with
    ``sample_every`` writes [real | fake | label] strips beside the
    checkpoints. ``stall_timeout > 0`` arms a :class:`_StallWatchdog`.

    Data parallelism: when this process is one of several
    (:func:`distributed`: torchrun, or a process group already up), the run
    shards its batch over a mesh's "data" axis (``n_data`` ranks, by default
    the largest divisor of ``batch_size`` that fits the processes;
    ``batch_size`` must divide). A process outside the mesh logs and
    returns None. ``n_model > 1`` raises ``NotImplementedError`` (the model
    axis is not ported). A single process trains alone, as before.
    """
    if n_model != 1:
        raise NotImplementedError(
            f"n_model={n_model}: {meshes.MODEL_AXIS_TODO}")
    mesh = None
    if distributed():
        mesh = _data_mesh(batch_size, n_data, n_model, device, log_fn)
        if mesh is None:
            return None
    elif n_data not in (None, 1):
        raise ValueError(f"n_data={n_data} needs several processes "
                         "(torchrun)")
    if mesh is not None:
        if batch_size % mesh.n_data:
            raise ValueError(f"batch {batch_size} does not divide over the "
                             f"mesh's {mesh.n_data} data shards")
        device = mesh.device
        per = batch_size // mesh.n_data
        rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
        if not mesh.is_main:
            log_fn = _quiet
    else:
        rows = slice(None)
    writes = mesh is None or mesh.is_main
    device = devices.resolve(device)
    w, h = dataset.canvas
    cfg = cfg or TrainConfig(height=h, width=w)
    accum = trainer.safe_grad_accum(cfg, batch_size, dataset.clip_len)
    if accum != cfg.grad_accum:
        log_fn(f"grad_accum {cfg.grad_accum} -> {accum} "
               "(trainer.safe_grad_accum)")
        cfg = dataclasses.replace(cfg, grad_accum=accum)
    state = create_trainer_state(cfg, seed=seed, vgg_params=vgg_params,
                                 device=device)
    if ckpt_dir is not None and ckpt.latest_step_dir(ckpt_dir):
        state = ckpt.restore_state(ckpt_dir, state)
        log_fn(f"resumed from step {state.step}")
    if mesh is None:
        step_fn = make_train_step(cfg)
    else:
        # Every rank starts from rank 0's weights (they are equal already:
        # one seed, or one checkpoint).
        meshes.replicate([*state.generator.parameters(),
                          *state.discriminators.parameters()], mesh)
        step_fn = make_train_step(cfg, mesh=mesh)
        log_fn(f"data-parallel over {mesh.n_data} ranks ({mesh.backend}), "
               f"{per} of each batch's {batch_size} clips a rank")

    augment = device_data and (
        cfg.aug_jitter_px > 0 or cfg.aug_drop_prob > 0
        or cfg.aug_face_drop_prob > 0 or cfg.aug_scale_crop)
    if cfg.aug_scale_crop and not device_data:
        log_fn("aug_scale_crop requires --device-data (labels re-rasterize "
               "on device from the transformed tracks); ignoring the flag")
    if augment:
        # Keypoint tracks stay resident (tiny) and each step draws its label
        # maps from the perturbed tracks: no label upload at all.
        reals_u8, centers_np = dataset.flat_reals_centers()
        tracks = [torch.from_numpy(x).to(device)
                  for x in dataset.flat_track_arrays()]
        reals_all = torch.from_numpy(reals_u8).to(device)
        centers_all = torch.from_numpy(centers_np).to(device)
        scales = aug.scale_crop_scales(cfg.aug_scale_max)
        aug_gen = torch.Generator(device=device)
        aug_kw = dict(drop_prob=cfg.aug_drop_prob,
                      jitter_px=cfg.aug_jitter_px,
                      face_drop_prob=cfg.aug_face_drop_prob)
        log_fn(f"device-resident dataset (augmented): "
               f"{reals_u8.nbytes / 1e6:.0f} MB frames + keypoint tracks; "
               "labels rasterize on device per step")
    elif device_data:
        labels_u8, reals_u8, centers_np = dataset.flat_arrays()
        labels_all = torch.from_numpy(labels_u8).to(device)
        reals_all = torch.from_numpy(reals_u8).to(device)
        centers_all = torch.from_numpy(centers_np).to(device)
        log_fn(f"device-resident dataset: {labels_u8.nbytes / 1e6:.0f} MB "
               f"labels + {reals_u8.nbytes / 1e6:.0f} MB frames uploaded "
               "once")

    # Visual training snapshots (the role of vid2vid's HTML snapshot pages):
    # one fixed clip through the current generator, written as a
    # [real | fake | label] strip beside the checkpoints.
    sample_batch = None
    if sample_every > 0 and ckpt_dir is not None and writes:
        sample_batch = dataset.batch(np.random.RandomState(123), 1)

    def save_snapshot(step_num: int) -> None:
        import cv2

        with torch.no_grad():
            fakes, _ = trainer._generate_clip(
                state.generator, cfg,
                torch.from_numpy(sample_batch["labels"]).to(device),
                torch.from_numpy(sample_batch["reals"]).to(device))
        fakes = fakes.cpu().numpy()

        def to_u8(x):
            return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)

        strip = np.concatenate([
            np.concatenate(list(to_u8(sample_batch["reals"][0])), axis=1),
            np.concatenate(list(to_u8(fakes[0])), axis=1),
            np.concatenate(list(to_u8(sample_batch["labels"][0])), axis=1),
        ], axis=0)
        os.makedirs(ckpt_dir, exist_ok=True)
        cv2.imwrite(os.path.join(ckpt_dir, f"sample_{step_num:08d}.jpg"),
                    cv2.cvtColor(strip, cv2.COLOR_RGB2BGR))

    rng = np.random.RandomState(seed)
    t0 = time.time()
    frames_done = 0
    last_saved = -1
    watchdog = (_StallWatchdog(stall_timeout, log_fn)
                if stall_timeout > 0 else None)
    for i in range(steps):
        # Every rank draws the whole batch from the same streams and keeps
        # its rows: the global batch is the single process's.
        if device_data:
            idx = torch.from_numpy(np.stack(
                [dataset.sample_clip_indices(rng)
                 for _ in range(batch_size)])[rows]).to(device)
        if augment:
            # One scale a step, chosen on the host: the step's shapes never
            # wait for the device.
            step_seed = (_AUG_SEED_STRIDE * (seed + 1) + i) % 2**32
            scale = (scales[np.random.RandomState(step_seed).randint(
                len(scales))] if cfg.aug_scale_crop else None)
            aug_gen.manual_seed(step_seed)
            draws = aug.draw_augment(batch_size, dataset.clip_len, aug_gen,
                                     scale_crop=scale is not None, **aug_kw)
            batch, _ = aug.augmented_batch(
                tracks, reals_all, centers_all, idx,
                draws.rows(rows, dataset.clip_len), dataset.canvas,
                scale=scale, **aug_kw)
        elif device_data:
            batch = {"labels": _unit(labels_all[idx]),
                     "reals": _unit(reals_all[idx]),
                     "face_centers": centers_all[idx]}
        else:
            batch = _to_device({k: v[rows] for k, v in dataset.batch(
                rng, batch_size,
                with_flow=cfg.flow_supervision == "reference").items()},
                device)
        state, metrics = step_fn(state, batch)
        frames_done += batch_size * dataset.clip_len
        if (i + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            log_fn(f"step {state.step}: "
                   + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()))
                   + f" | {frames_done / dt:.1f} frames/s")
            if watchdog is not None:
                watchdog.pet()  # the float() above waited for the step
        if sample_batch is not None and (i + 1) % sample_every == 0:
            save_snapshot(state.step)
        if ckpt_dir is not None and (i + 1) % save_every == 0:
            if writes:
                ckpt.save_state(ckpt_dir, state, cfg)
            last_saved = state.step
    if ckpt_dir is not None and state.step != last_saved and writes:
        ckpt.save_state(ckpt_dir, state, cfg)
    if mesh is not None:
        # No rank leaves before rank 0's checkpoint is on disk: a run that
        # resumes from it right after must find it on every rank.
        meshes.barrier(mesh)
    if watchdog is not None:
        watchdog.stop()
    return state
