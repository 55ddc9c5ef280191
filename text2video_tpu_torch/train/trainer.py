"""The GAN train step (counterpart of ``text2video_tpu/train/trainer.py``).

One optimisation step consumes a clip batch, ``labels``/``reals`` of shape
[B, T, H, W, 3] plus per-frame face centres [B, T, 2], mirroring the
reference's 12-frame clip sampling (``--n_frames_total 12``). The generator
unrolls autoregressively over T in a Python loop; the discriminators score
each frame, temporal discriminators score stacked triples at several
strides, and a face discriminator scores crops around the mouth centre
(``--add_face_disc``).

G and D are updated from ONE generator unroll: the G objective unrolls the
generator and keeps the fakes; the D objective applies only the
discriminators to those fakes, detached, which matches vid2vid's
detach-the-images alternation without a second unroll. G's gradient is taken
with respect to G's parameters only, D's with respect to D's.

The generator trains through plain convs (``fused_resblocks=False``): the
fused conv + statistics op has no backward, here as in the JAX package.

A step runs in PyTorch's deterministic mode (:func:`deterministic_algorithms`),
so two runs from one seed on one card give bit-equal losses and weights, as
the JAX package's training does.

Over a mesh (``make_train_step(cfg, mesh=)``), each rank of the "data" axis
takes its rows of the global batch; before the optimizer steps, the
gradients and metrics are averaged over the ranks in rank order
(``parallel.mesh.mean_ordered``), so every rank applies the same update bits
and the averaged gradient is the global batch's, as the JAX package's
sharded step computes it. Under a "model" axis the wide conv kernels are
held as output-channel shards (``parallel.mesh.shard_params``): each
micro-batch gathers them whole once (``parallel.model_axis``), the ranks of
a model group run the same rows, and each averages and updates only its
shards.

While a ``torch.profiler`` profile runs, a step records the span
``train.step`` (``utils/profiling.py``; its request the step's index) and
under it a span a phase, in order: ``train.model_gather`` (with sharded
kernels), ``train.g_forward``, ``train.g_backward``, ``train.d_forward``,
``train.d_backward`` (each micro-batch), ``train.grad_sync`` (over a data
axis) and ``train.optimizer``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from text2video_tpu_torch import device as devices
from text2video_tpu_torch.models import losses as L
from text2video_tpu_torch.models import vgg as vgg_model
from text2video_tpu_torch.models.discriminator import (
    MultiscaleDiscriminator,
    face_crop,
)
from text2video_tpu_torch.models.generator import CompositeGenerator
from text2video_tpu_torch.parallel import model_axis
from text2video_tpu_torch.parallel.mesh import mean_ordered
from text2video_tpu_torch.utils import profiling

METRICS = ("g_loss", "g_adv", "g_fm", "g_vgg", "g_flow", "g_mouth_l1",
           "d_loss")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    height: int = 384
    width: int = 512
    n_frames_ctx: int = 3  # label maps fed to G (current + 2 previous)
    use_prev_frames: int = 2
    temporal_window: int = 3  # frames stacked for the temporal D
    # Temporal D rates: stride 1 plus coarser strides (vid2vid scores
    # temporally downsampled stacks at several rates). Each has its own D.
    temporal_strides: Tuple[int, ...] = (1, 2)
    face_crop: int = 96
    base_ch: int = 64
    n_blocks: int = 9
    d_base_ch: int = 64
    num_d: int = 2
    lr: float = 2e-4
    beta1: float = 0.5
    # Discriminator learning-rate multiplier (reverse-TTUR): full-size Ds
    # memorize a single-person dataset and saturate; a slower D keeps the
    # game informative on small data.
    d_lr_scale: float = 1.0
    # Weight on every adversarial G term (image/temporal/face). 0.0 turns
    # the GAN game off: no discriminator is applied or updated and feature
    # matching is off, which is pure reconstruction (L1/VGG/flow)
    # pretraining. The stable curriculum on a tiny per-person dataset is a
    # reconstruction pretrain (lambda_adv=0), then a short adversarial
    # finetune (resume with lambda_adv>0; D starts fresh).
    lambda_adv: float = 1.0
    lambda_fm: float = 10.0
    lambda_vgg: float = 10.0
    lambda_flow: float = 10.0
    lambda_face: float = 1.0
    lambda_temp: float = 1.0
    # Direct L1(fake, real). vid2vid has none (feature matching plays that
    # role) but has ImageNet VGG19 weights; without them VGG runs on random
    # filters, so the defaults are L1 on, VGG off. Real VGG19 weights
    # (models/vgg.load_params -> create_trainer_state vgg_params) with
    # use_vgg=True restore the vid2vid-faithful perceptual term.
    lambda_l1: float = 10.0
    # Extra L1 on the mouth crop (the ``face_crop`` window around the
    # batch's mouth centres): anchors the region lip sync rides on through
    # the adversarial phase. 0 = off.
    lambda_l1_mouth: float = 0.0
    use_vgg: bool = False
    # Recompute each frame's generator forward (and VGG) in the backward
    # pass: the T-step unroll otherwise keeps every frame's activations.
    remat: bool = True
    # Label augmentation (train/augment.py; device-data training only).
    aug_jitter_px: float = 0.0
    aug_drop_prob: float = 0.0
    aug_face_drop_prob: float = 0.0
    aug_scale_crop: bool = False
    aug_scale_max: float = 544.0 / 512.0 - 1.0
    # "photometric": self-supervised warp loss; "reference": supervise
    # against Farneback flow between the sampled real frames (host data
    # path only).
    flow_supervision: str = "photometric"
    # Split each step's batch into this many sequential micro-batches and
    # average G's and D's gradients before the one optimizer update. The
    # gradients equal the full batch's (every loss term is a batch mean
    # over equal micro-batches); peak activation memory drops by the factor.
    grad_accum: int = 1
    # Backprop through the autoregressive feedback. False (default) detaches
    # the generated frames fed back as the next step's conditioning, as
    # vid2vid detaches fake_B_prev: full BPTT compounds the CNN's
    # input-to-output Jacobian over the unroll and Adam then sees amplified
    # noise.
    bptt: bool = False
    dtype: torch.dtype = torch.bfloat16


def safe_grad_accum(cfg: TrainConfig, batch_size: int, clip_len: int) -> int:
    """The gradient accumulation a run of ``batch_size`` clips of
    ``clip_len`` frames should use: ``cfg.grad_accum`` as requested (at
    least 1), unchanged.

    The JAX package raises the factor at 896x512-class resolutions, where
    its composed train step returned NaN losses on the TPU backend once a
    micro-batch unrolled more than 16 frames. That frontier belongs to that
    backend. On the card (``chip_smoke.py``, phase ``train_896``, NVIDIA
    H100 80GB HBM3) one step at 896x512, batch 4 x clip 8, ``lambda_adv=0``,
    ``grad_accum=1`` gives finite losses, so no accumulation is forced
    here."""
    del batch_size, clip_len  # no shape needs more on this backend
    return max(int(cfg.grad_accum), 1)


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic mode (``torch.use_deterministic_algorithms``)
    for the length of the block, the previous mode restored after it.

    On a card the mode makes cuDNN pick deterministic convolution algorithms
    and routes the scatter-adds of index and ``gather`` backwards (the face
    crop; the flow warp when ``bptt`` feeds frames back) through ordered
    sums; the reflect pad takes its own ordered backward
    (``layers.reflect_pad``). An op with no deterministic form raises:
    nothing falls back to an atomic path.

    The mode's fill of every new allocation with NaN is turned off for the
    block: no op of the step reads memory it has not written, so the fill
    would only add a kernel per new tensor."""
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def _temporal_key(stride: int) -> str:
    """Key of the stride-``s`` temporal D ("temporal" for stride 1)."""
    return "temporal" if stride == 1 else f"temporal{stride}"


@dataclasses.dataclass
class TrainerState:
    """Everything a step reads and writes. A step updates it in place."""

    step: int
    generator: CompositeGenerator
    # {"image", "face", "temporal", "temporal2", ...}
    discriminators: nn.ModuleDict
    vgg: Optional[vgg_model.VGG19Features]
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device


def _models(cfg: TrainConfig):
    in_ch = 3 * (cfg.n_frames_ctx + cfg.use_prev_frames)
    gen = CompositeGenerator(in_ch, base_ch=cfg.base_ch,
                             n_blocks=cfg.n_blocks, dtype=cfg.dtype,
                             fused_resblocks=False)
    discs = nn.ModuleDict({
        "image": MultiscaleDiscriminator(6, cfg.num_d, cfg.d_base_ch,
                                         dtype=cfg.dtype),
        "face": MultiscaleDiscriminator(6, 1, cfg.d_base_ch // 2,
                                        dtype=cfg.dtype),
    })
    for s in cfg.temporal_strides:
        discs[_temporal_key(s)] = MultiscaleDiscriminator(
            3 * cfg.temporal_window, 1, cfg.d_base_ch, dtype=cfg.dtype)
    vgg = vgg_model.VGG19Features(dtype=cfg.dtype) if cfg.use_vgg else None
    return gen, discs, vgg


def _adam(params, lr: float, cfg: TrainConfig) -> torch.optim.Adam:
    """``optax.adam(lr, b1=beta1, b2=0.999)``: eps 1e-8 outside the root,
    bias-corrected, no weight decay."""
    return torch.optim.Adam(params, lr=lr, betas=(cfg.beta1, 0.999),
                            eps=1e-8)


def create_trainer_state(
    cfg: TrainConfig,
    seed: int = 0,
    vgg_params: Optional[Mapping[str, torch.Tensor]] = None,
    device=None,
) -> TrainerState:
    """A fresh state with seeded random weights on ``device``, the card
    unless the caller names another. ``vgg_params``: a VGG ``state_dict``
    (``models/vgg.load_params``); with ``cfg.use_vgg`` and none given, the
    filters are seeded random ones."""
    device = devices.resolve(device)
    gen, discs, vgg = _models(cfg)
    rng = torch.Generator().manual_seed(seed)
    gen.reset_parameters(rng)
    for d in discs.values():
        d.reset_parameters(rng)
    if vgg is not None:
        vgg.load_state_dict(vgg_params if vgg_params is not None
                            else vgg_model.init_params(seed), strict=True)
        vgg.to(device).eval()
    gen.to(device).train()
    discs.to(device).train()
    return TrainerState(
        step=0, generator=gen, discriminators=discs, vgg=vgg,
        g_opt=_adam(gen.parameters(), cfg.lr, cfg),
        d_opt=_adam(discs.parameters(), cfg.lr * cfg.d_lr_scale, cfg),
    )


def _generate_clip(gen: CompositeGenerator, cfg: TrainConfig,
                   labels: torch.Tensor, reals: torch.Tensor):
    """Unroll G over the clip. labels/reals: [B, T, H, W, 3] in [-1, 1].

    The conditioning matches inference (``render.py``): previous *generated*
    frames in the carry, previous labels as context. The carry is f32 here,
    not the generator dtype. Returns fakes [B, T, H, W, 3] f32 and flows
    [B, T, H, W, 2]."""
    b, t, h, w, _ = labels.shape
    dev = labels.device
    prev_i = torch.zeros((b, h, w, 3 * cfg.use_prev_frames), device=dev)
    prev_l = torch.zeros((b, h, w, 3 * (cfg.n_frames_ctx - 1)), device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    frames, flows = [], []
    for i in range(t):
        lab = labels[:, i].float()
        ctx = torch.cat([lab, prev_l], dim=-1)
        has_prev = torch.full((b,), float(i > 0), device=dev)
        if remat:
            frame, flow, _ = checkpoint(gen, ctx, prev_i, has_prev,
                                        use_reentrant=False)
        else:
            frame, flow, _ = gen(ctx, prev_i, has_prev)
        frame = frame.float()
        fed_back = frame if cfg.bptt else frame.detach()
        prev_i = torch.cat([fed_back, prev_i[..., :-3]], dim=-1)
        prev_l = torch.cat([lab, prev_l[..., :-3]], dim=-1)
        frames.append(frame)
        flows.append(flow)
    return torch.stack(frames, dim=1), torch.stack(flows, dim=1)


def _flatten_bt(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _temporal_stack(x: torch.Tensor, window: int,
                    stride: int = 1) -> torch.Tensor:
    """[B, T, H, W, C] -> [B*n, H, W, C*window] stacks of ``window`` frames
    spaced ``stride`` apart (stride 1 = consecutive frames)."""
    b, t, h, w, c = x.shape
    span = (window - 1) * stride + 1
    n = t - span + 1
    if n <= 0:
        raise ValueError(
            f"clip length {t} too short for temporal window {window} at "
            f"stride {stride}")
    stacked = torch.cat(
        [x[:, i * stride: i * stride + n] for i in range(window)], dim=-1)
    return stacked.reshape(-1, h, w, c * window)


Step = Callable[[TrainerState, Mapping[str, torch.Tensor]],
                Tuple[TrainerState, Dict[str, torch.Tensor]]]


def make_train_step(cfg: TrainConfig, mesh=None) -> Step:
    """Returns ``step(state, batch) -> (state, metrics)``.

    batch: {"labels": [B,T,H,W,3] float in [-1,1], "reals": the same,
    "face_centers": [B,T,2] float pixels, optionally "flow_gt":
    [B,T-1,H,W,2]}, tensors on the state's device. ``state`` is updated in
    place and returned; ``metrics`` are 0-dim f32 tensors on the device
    (reading one waits for the step). After a step every parameter's
    ``.grad`` holds the gradient that the update used.

    With ``mesh``, ``batch`` is this rank's rows of the global batch (an
    equal share on every rank; the ranks of one model group get the same
    rows) and the update uses the mean over the data axis of the ranks'
    gradients; ``metrics`` are the means too. Where the state's wide
    kernels are sharded over the mesh's model axis
    (``parallel.mesh.shard_params`` with the optimizers), each micro-batch
    gathers them whole once, before the forward and outside the remat
    regions, and checks that it gathered each once; the gradients, their
    mean and Adam's update are the shards'. Adam is elementwise, so a
    shard's update is the slice of the whole kernel's, and the step computes
    the bits of a step without the model axis. (The JAX package replicates
    the optimizer state over "model"; keeping the moments sharded gives the
    same numbers.)"""
    adversarial = cfg.lambda_adv > 0.0

    def apply_discriminators(discs, labels_f, frames, frames_f, centers_f):
        """Every discriminator on one set of frames: frames [B,T,H,W,3] f32
        for the temporal stacks, frames_f its [B*T, ...] flattening.
        Returns (image_out, [temporal_out per stride], face_out). A coarser
        stride applies only when the clip fits its stretched window."""
        d_out = discs["image"](torch.cat([labels_f, frames_f], dim=-1))
        t_outs = [
            discs[_temporal_key(s)](
                _temporal_stack(frames, cfg.temporal_window, s))
            for s in cfg.temporal_strides
            if (cfg.temporal_window - 1) * s + 1 <= frames.shape[1]
        ]
        lab_crop = face_crop(labels_f, centers_f, cfg.face_crop)
        crop = face_crop(frames_f, centers_f, cfg.face_crop)
        f_out = discs["face"](torch.cat([lab_crop, crop], dim=-1))
        return d_out, t_outs, f_out

    def g_objective(state: TrainerState, batch):
        """The generator unroll and every G loss; the fakes come back too,
        so the D objective never re-runs the generator."""
        labels, reals = batch["labels"], batch["reals"]
        centers = batch["face_centers"]
        discs = state.discriminators
        fakes, flows = _generate_clip(state.generator, cfg, labels, reals)
        reals_f32 = reals.float()
        labels_f = _flatten_bt(labels).float()
        fakes_f = _flatten_bt(fakes)
        reals_flat = _flatten_bt(reals_f32)
        centers_f = _flatten_bt(centers)
        zero = torch.zeros((), device=labels.device)

        g_adv = g_fm = zero
        if adversarial:
            d_fake, t_fakes, f_fake = apply_discriminators(
                discs, labels_f, fakes, fakes_f, centers_f)
            # The image D's real features are only feature-matching targets.
            with torch.no_grad():
                d_real = discs["image"](
                    torch.cat([labels_f, reals_flat], dim=-1))
            g_adv = cfg.lambda_adv * (
                L.lsgan_g(d_fake)
                + cfg.lambda_temp * sum(L.lsgan_g(t) for t in t_fakes)
                + cfg.lambda_face * L.lsgan_g(f_fake))
            g_fm = L.feature_matching(d_real, d_fake)
        g_vgg = zero
        if cfg.use_vgg:
            if cfg.remat:
                vf = checkpoint(state.vgg, fakes_f, use_reentrant=False)
            else:
                vf = state.vgg(fakes_f)
            with torch.no_grad():
                vr = state.vgg(reals_flat)
            g_vgg = L.perceptual(vf, vr)
        if "flow_gt" in batch:
            g_flow = L.flow_supervised_loss(
                _flatten_bt(flows[:, 1:]),
                _flatten_bt(batch["flow_gt"].float()))
        else:
            g_flow = L.flow_loss(
                _flatten_bt(flows[:, 1:]),
                _flatten_bt(reals_f32[:, :-1]),
                _flatten_bt(reals_f32[:, 1:]))
        g_loss = (g_adv + cfg.lambda_fm * g_fm + cfg.lambda_vgg * g_vgg
                  + cfg.lambda_flow * g_flow)
        if cfg.lambda_l1 > 0.0:
            g_loss = g_loss + cfg.lambda_l1 * L.l1(fakes_f, reals_flat)
        g_mouth = zero
        if cfg.lambda_l1_mouth > 0.0:
            # The batch's "face_centers" are mouth centres (train/data.py).
            g_mouth = L.l1(face_crop(fakes_f, centers_f, cfg.face_crop),
                           face_crop(reals_flat, centers_f, cfg.face_crop))
            g_loss = g_loss + cfg.lambda_l1_mouth * g_mouth
        metrics = {"g_loss": g_loss, "g_adv": g_adv, "g_fm": g_fm,
                   "g_vgg": g_vgg, "g_flow": g_flow, "g_mouth_l1": g_mouth}
        return g_loss, metrics, fakes

    def d_objective(state: TrainerState, batch, fakes):
        """The discriminator losses. ``fakes`` enter detached, so every D
        gradient is live on both the real and the fake terms."""
        labels, reals = batch["labels"], batch["reals"]
        reals_f32 = reals.float()
        labels_f = _flatten_bt(labels).float()
        centers_f = _flatten_bt(batch["face_centers"])
        discs = state.discriminators
        d_fake, t_fakes, f_fake = apply_discriminators(
            discs, labels_f, fakes, _flatten_bt(fakes), centers_f)
        d_real, t_reals, f_real = apply_discriminators(
            discs, labels_f, reals_f32, _flatten_bt(reals_f32), centers_f)
        return (L.lsgan_d(d_real, d_fake)
                + sum(L.lsgan_d(tr, tf) for tr, tf in zip(t_reals, t_fakes))
                + L.lsgan_d(f_real, f_fake))

    def grads_once(state: TrainerState, batch, g_params, d_params):
        """One G and D gradient evaluation on a (micro-)batch, a span each
        phase (outside every remat region)."""
        with profiling.span("train.g_forward"):
            g_loss, metrics, fakes = g_objective(state, batch)
        with profiling.span("train.g_backward"):
            g_grads = torch.autograd.grad(g_loss, g_params,
                                          allow_unused=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        d_grads = None
        d_loss = torch.zeros((), device=g_loss.device)
        if adversarial:
            with profiling.span("train.d_forward"):
                d_loss = d_objective(state, batch, fakes.detach())
            with profiling.span("train.d_backward"):
                d_grads = torch.autograd.grad(d_loss, d_params,
                                              allow_unused=True)
            d_loss = d_loss.detach()
        metrics["d_loss"] = d_loss
        return g_grads, d_grads, metrics

    def accumulate(total, grads, params):
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        if total is None:
            return grads
        return [a + g for a, g in zip(total, grads)]

    def step(state: TrainerState, batch):
        with deterministic_algorithms():
            with profiling.request(state.step), profiling.span("train.step"):
                return deterministic_step(state, batch)

    def deterministic_step(state: TrainerState, batch):
        accum = max(int(cfg.grad_accum), 1)
        g_params = list(state.generator.parameters())
        d_params = list(state.discriminators.parameters())
        b = batch["labels"].shape[0]
        if b % accum:
            raise ValueError(
                f"batch size {b} not divisible by grad_accum {accum}")
        micro = b // accum
        g_total = d_total = None
        metrics: Dict[str, torch.Tensor] = {}
        # The model axis: the step's modules' sharded kernels, each gathered
        # once a micro-batch.
        nets = [state.generator] + ([state.discriminators] if adversarial
                                    else [])
        wide = len(model_axis.sharded_convs(nets))
        gathered = model_axis.gathers
        with torch.enable_grad():
            for i in range(accum):
                mb = (batch if accum == 1 else
                      {k: v[i * micro: (i + 1) * micro]
                       for k, v in batch.items()})
                with model_axis.gathered_kernels(nets, mesh):
                    g_grads, d_grads, m = grads_once(state, mb, g_params,
                                                     d_params)
                g_total = accumulate(g_total, g_grads, g_params)
                if d_grads is not None:
                    d_total = accumulate(d_total, d_grads, d_params)
                metrics = {k: v if not metrics else metrics[k] + v
                           for k, v in m.items()}
        if model_axis.gathers - gathered != accum * wide:
            raise RuntimeError(
                f"{model_axis.gathers - gathered} kernel gathers in a step "
                f"of {accum} micro-batches over {wide} sharded kernels")
        if accum > 1:
            metrics = {k: v / accum for k, v in metrics.items()}
        if mesh is not None and mesh.n_data > 1:
            # One bucket, one all_gather: G's and D's gradients and the
            # metrics, summed in rank order.
            names = sorted(metrics)
            d_list = d_total if d_total is not None else []
            with profiling.span("train.grad_sync"):
                synced = mean_ordered(
                    g_total + d_list + [metrics[k] for k in names], mesh)
            g_total = synced[:len(g_total)]
            if d_total is not None:
                d_total = synced[len(g_total): len(g_total) + len(d_list)]
            metrics = dict(zip(names, synced[len(g_total) + len(d_list):]))
        with profiling.span("train.optimizer"):
            for p, g in zip(g_params, g_total):
                p.grad = g / accum if accum > 1 else g
            state.g_opt.step()
            if adversarial:
                for p, g in zip(d_params, d_total):
                    p.grad = g / accum if accum > 1 else g
                state.d_opt.step()
            else:
                # Reconstruction pretrain: the Ds stay at their init.
                for p in d_params:
                    p.grad = None
        state.step += 1
        return state, metrics

    return step

