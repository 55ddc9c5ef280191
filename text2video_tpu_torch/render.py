"""Autoregressive pose2frame rendering (counterpart of
``text2video_tpu/render.py``): the exact sequential scan and Jacobi
(fixed-point) decoding.

Label maps arrive as device tensors ([B, chunk, H, W, 3]); the generator
runs once per frame in a Python loop — the eager counterpart of the JAX
package's chunked ``lax.scan`` — with the autoregressive state (previous
frames, previous label maps, step) carried from chunk to chunk in the
compute dtype. Frames are quantized to uint8 (or converted to YUV420) on the
device before they go to the host. On a card the step (the generator call,
the frame's cast and the carry's concatenation) is captured once per shape
as a CUDA graph and replayed a frame (:class:`StepGraph`): the same kernels
on the same buffers' values, one graph launch instead of ~570 from Python.

``render_many_device`` renders a batch of utterances in one scan (the
generator step runs at batch B) and returns the frames in one copy into
pinned host memory. ``jacobi_device`` iterates the recurrence
over the whole timeline instead: each sweep runs the generator on
``time_bucket`` frames at once, every frame fed its neighbours of the
previous sweep. The streaming paths send each chunk to the host as one flat
wire tensor in the format of ``RenderConfig.wire_format``: ``"dct"`` (the
default) bit-packed, truncated, quantized DCT coefficients
(``ops/dct.py``), ``"yuv420"`` the uint8 planes.

With a mesh (``parallel.make_mesh``), ``render_many`` shards the batch of
utterances over the "data" axis, each rank scanning its rows, and
``render_jacobi_sharded`` spreads one utterance's timeline over it, each rank
sweeping its block of frames after a halo of the previous sweep's frames from
the rank before it. Over a mesh with a "model" axis both shard over "data"
and replicate over "model", as the JAX package's serving paths do: the ranks
of one model group render the same rows with whole weights.
"""

from __future__ import annotations

import contextlib
import dataclasses
import operator
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from text2video_tpu_torch import device as devices
from text2video_tpu_torch.config import RenderConfig
from text2video_tpu_torch.models.generator import CompositeGenerator
from text2video_tpu_torch.models.layers import param_key
from text2video_tpu_torch.ops import fused_norm, fused_resblock
from text2video_tpu_torch.ops.colorspace import (
    rgb_norm_to_yuv420,
    rgb_norm_to_yuv420_float,
)
from text2video_tpu_torch.ops.dct import (
    W_AC_CHROMA,
    W_AC_LUMA,
    decode_plane_np,
    encode_yuv,
    pack_plane_shift,
    packed_plane_bytes,
    quant_tables,
    unpack_plane_shift_np,
)
from text2video_tpu_torch.parallel.mesh import (
    gather_rows,
    halo_rows,
    padded_rows,
)
from text2video_tpu_torch.utils import profiling

Carry = Tuple[torch.Tensor, torch.Tensor, int]


def resize_labels(labels: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[..., H, W, 3] f32 -> [..., height, width, 3], bilinear with
    antialiasing (``jax.image.resize(..., "linear")`` antialiases when it
    downscales)."""
    lead = labels.shape[:-3]
    x = labels.reshape(-1, *labels.shape[-3:]).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(height, width), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).reshape(*lead, height, width, 3)


def _shift_frames(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[i - k] at row i of the leading axis, zeros before the start."""
    return torch.cat([torch.zeros_like(x[:k]), x[: x.shape[0] - k]], dim=0)


def _quantize_u8(frames: torch.Tensor) -> torch.Tensor:
    """[-1, 1] frames -> uint8, in f32 (a bf16 ulp at 255 is 1); the cast
    truncates."""
    return torch.clamp((frames.float() + 1.0) * 127.5, 0.0,
                       255.0).to(torch.uint8)


def _to_host_async(t: torch.Tensor):
    """Start a device->host copy; returns (host tensor, event or None)."""
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class StepGraph:
    """One generator step of the scan at a fixed shape on a card, captured
    as CUDA graphs and replayed a frame.

    Static buffers: ``labels`` [B, H', W', 3 * n_frames_ctx] and ``prev``
    (two of them) [B, H', W', 3 * use_prev_frames] in the compute dtype,
    ``has_prev`` [B] f32. Graph k runs the generator on ``labels``,
    ``prev[k]`` and ``has_prev``, leaves its f32 frame in ``frames[k]`` and
    writes the next step's carry (the frame in the compute dtype, then
    ``prev[k]`` less its oldest frame) into ``prev[1 - k]``: the two graphs
    take turns, so a step's input still holds after its replay, for the
    step taps. They share one memory pool, so ``frames[k]`` may lie in the
    other graph's scratch: it is read (by the taps, in stream order) before
    the other graph replays, and nothing keeps it past that.

    Before capture two eager steps run on a side stream with the taps
    paused, so that one-time work happens outside the graphs: kernel B1's
    function attributes and driver entry point, cuDNN's plan choice, the
    layers' ``ParamCopy`` builds. Their B1 and norm launches, and those
    counted while capturing, are set-up and are taken off
    ``fused_resblock.launches`` and ``fused_norm.launches`` again; each
    replay adds the ``b1_per_step`` and ``norm_per_step`` calls the graph
    holds. The counter ``scan_graph_captures`` adds one a capture of the
    pair.

    A graph keeps the addresses it captured: the parameters, their
    ``ParamCopy`` tensors and its own pool. ``Renderer`` drops it when a
    parameter moves or is loaded in place (:func:`param_key`); a copy of
    an inference-mode parameter, remade on every call, is remade inside
    the graph."""

    def __init__(self, gen: CompositeGenerator, batch: int, height: int,
                 width: int, label_ch: int, prev_ch: int):
        self.gen = gen
        self.batch = batch
        dt, dev = gen.dtype, next(gen.parameters()).device
        self.device = dev
        self.labels = torch.zeros((batch, height, width, label_ch), dtype=dt,
                                  device=dev)
        self.prev = [torch.zeros((batch, height, width, prev_ch), dtype=dt,
                                 device=dev) for _ in range(2)]
        self.has_prev = torch.zeros((batch,), device=dev)
        self._has_prev = 0.0  # the value in ``has_prev``
        self.graphs = [torch.cuda.CUDAGraph() for _ in range(2)]
        self.frames: List[torch.Tensor] = []
        before = fused_resblock.launches, dict(fused_norm.launches)
        with torch.cuda.device(dev), gen.step_taps_paused():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for k in (0, 1):
                    self._step(k)
            torch.cuda.current_stream(dev).wait_stream(side)
            mark = fused_resblock.launches, dict(fused_norm.launches)
            pool = torch.cuda.graph_pool_handle()
            for k in (0, 1):
                # thread_local: the muxer's worker may call CUDA meanwhile.
                with torch.cuda.graph(self.graphs[k], pool=pool,
                                      capture_error_mode="thread_local"):
                    self.frames.append(self._step(k))
        self.b1_per_step = (fused_resblock.launches - mark[0]) // 2
        self.norm_per_step = {k: (n - mark[1][k]) // 2
                              for k, n in fused_norm.launches.items()}
        fused_resblock.launches = before[0]
        fused_norm.launches.update(before[1])
        profiling.count("scan_graph_captures")

    def _step(self, k: int) -> torch.Tensor:
        frame, _, _ = self.gen(self.labels, self.prev[k], self.has_prev)
        prev = self.prev[k]
        torch.cat([frame.to(prev.dtype), prev[..., :-3]], dim=-1,
                  out=self.prev[1 - k])
        return frame

    def scan(self, labels_ctx_t: torch.Tensor, prev: torch.Tensor,
             step: int, out: torch.Tensor) -> torch.Tensor:
        """Replay ``out.shape[1]`` steps: step i on ``labels_ctx_t[i]`` with
        ``has_prev`` 1 past the utterance's step 0 (``step`` is the chunk's
        first), its frame into ``out[:, i]``. ``prev``: the carry in. Returns
        the carry out, a tensor of its own: no state crosses a chunk in the
        graph's buffers."""
        steps = out.shape[1]
        with torch.cuda.device(self.device):
            self.prev[0].copy_(prev)
            for i in range(steps):
                k = i % 2
                self.labels.copy_(labels_ctx_t[i])
                has_prev = float(step + i > 0)
                if has_prev != self._has_prev:
                    self.has_prev.fill_(has_prev)
                    self._has_prev = has_prev
                self.graphs[k].replay()
                out[:, i].copy_(self.prev[1 - k][..., :3])
                self.gen.fire_step_taps(self.labels, self.prev[k],
                                        self.has_prev, self.frames[k])
            fused_resblock.launches += self.b1_per_step * steps
            for k, n in self.norm_per_step.items():
                fused_norm.launches[k] += n * steps
            profiling.count("scan_graph_steps", self.batch * steps)
            return self.prev[steps % 2].clone()


@dataclasses.dataclass
class Renderer:
    """A generator (on its device, in its compute dtype) and the chunked
    autoregressive render loop around it."""

    generator: CompositeGenerator
    config: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    # Frames per chunk; also the rasterizer's chunk in the pipeline.
    time_bucket: int = 64
    # The scan's step graphs on a card, by (B, H', W', label and carry
    # channels, dtype, device), captured for the parameters whose
    # ``param_key`` is ``_graph_params``.
    _graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)
    _graph_params: tuple = dataclasses.field(default=(), init=False,
                                             repr=False, compare=False)

    @staticmethod
    def create(
        config: Optional[RenderConfig] = None,
        seed: int = 0,
        base_ch: int = 64,
        n_blocks: int = 9,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        phase_form: bool = True,
        n_local_enhancers: int = 0,
        n_local_blocks: int = 3,
    ) -> "Renderer":
        """Renderer with seeded random weights (trained weights come from a
        converted checkpoint, ``convert.py``) on ``device``, the card unless
        the caller names another. ``phase_form=False`` runs the plain
        full-resolution stem, upsamples and heads instead of their phase
        forms (the same function and parameters). ``n_local_enhancers``
        builds the coarse-to-fine generator: the trunk at ``1 /
        2**n_local_enhancers`` of the resolution, each local enhancer with
        ``n_local_blocks`` resblocks."""
        device = devices.resolve(device)
        config = config or RenderConfig()
        gen = CompositeGenerator(
            in_channels=3 * (config.n_frames_ctx + config.use_prev_frames),
            base_ch=base_ch, n_blocks=n_blocks, dtype=dtype,
            n_local_enhancers=n_local_enhancers,
            n_local_blocks=n_local_blocks, phase_form=phase_form,
        )
        gen.reset_parameters(torch.Generator().manual_seed(seed))
        return Renderer(generator=gen.to(device).eval(), config=config)

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device

    def init_carry(self, batch: int, height: int, width: int) -> Carry:
        """(prev_imgs, prev_labels, step) for a fresh utterance, in the
        generator's compute dtype."""
        cfg = self.config
        dt = self.generator.dtype

        def zeros(ch):
            return torch.zeros((batch, height, width, ch), dtype=dt,
                               device=self.device)

        return (zeros(3 * cfg.use_prev_frames),
                zeros(3 * (cfg.n_frames_ctx - 1)), 0)

    def target_hw(self, h: int, w: int) -> Tuple[int, int]:
        """Working resolution for an (h, w) canvas: height scaled to
        config.load_size (multiples of 64), or the canvas itself."""
        ls = self.config.load_size
        if ls is None or h == ls:
            return h, w
        h2 = max(round(ls / 64) * 64, 64)
        w2 = max(round(w * h2 / h / 64) * 64, 64)
        return h2, w2

    @torch.inference_mode()
    def _scan_chunk(self, labels: torch.Tensor, carry: Carry,
                    steps: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Carry]:
        """labels [B, chunk, H, W, 3] in [-1, 1] -> (frames [B, steps, H',
        W', 3] in the compute dtype, carry). The label context (current +
        n_frames_ctx - 1 previous maps) is assembled for the whole chunk
        first; frames before the chunk come from the carry.

        ``steps`` (default: the whole chunk) runs the generator for the
        first ``steps`` frames only: the last chunk of an utterance skips
        its padding frames. The carry is then that of a partial chunk, so
        only the last chunk may be cut.

        On a card each step is a replay of the shape's :class:`StepGraph`;
        on the CPU the generator runs eagerly. The frames and the carry are
        the same bits either way."""
        b, c, h, w, _ = labels.shape
        steps = c if steps is None else steps
        # The host's enqueue of the chunk's launches.
        with profiling.span("render.chunk", frames=steps * b):
            h2, w2 = self.target_hw(h, w)
            labels = labels.float()
            if (h2, w2) != (h, w):
                labels = resize_labels(labels, h2, w2)
            prev_imgs, prev_labels, step = carry
            dt = self.generator.dtype
            lab_t = labels.transpose(0, 1).to(dt)  # [C, B, H', W', 3]
            n_ctx = self.config.n_frames_ctx
            if c < n_ctx - 1:
                raise ValueError(
                    f"chunk of {c} frames < n_frames_ctx-1 ({n_ctx - 1})")
            ctx = [lab_t]
            for k in range(1, n_ctx):
                # shifted_k[i] = label of frame i-k; prev_labels[..., 3m:3m+3]
                # holds frame -1-m.
                head = [prev_labels[None, ..., 3 * (k - i - 1): 3 * (k - i)]
                        for i in range(k)]
                ctx.append(torch.cat(head + [lab_t[: c - k]], dim=0))
            labels_ctx_t = torch.cat(ctx, dim=-1)

            graph = self._step_graph(b, h2, w2, labels_ctx_t.shape[-1],
                                     prev_imgs.shape[-1])
            if graph is not None:
                frames = torch.empty((b, steps, h2, w2, 3), dtype=dt,
                                     device=labels.device)
                prev = graph.scan(labels_ctx_t, prev_imgs, step, frames)
            else:
                prev = prev_imgs.to(dt)
                out = []
                for i in range(steps):
                    has_prev = torch.full((b,), float(step + i > 0),
                                          device=labels.device)
                    frame, _, _ = self.generator(labels_ctx_t[i], prev,
                                                 has_prev)
                    frame = frame.to(dt)
                    prev = torch.cat([frame, prev[..., :-3]], dim=-1)
                    out.append(frame)
                frames = torch.stack(out, dim=1)
            new_prev_labels = torch.cat(
                [lab_t[c - 1 - m] for m in range(n_ctx - 1)], dim=-1)
            carry = (prev, new_prev_labels, step + c)
            return frames, carry

    def _step_graph(self, b: int, h: int, w: int, label_ch: int,
                    prev_ch: int) -> Optional[StepGraph]:
        """The step graph for this shape and the generator's parameters as
        they are now, or None off a card; every graph is dropped when a
        parameter has moved or been loaded since they were captured."""
        if self.device.type != "cuda":
            return None
        gen = self.generator
        params = param_key([*gen.parameters(), *gen.buffers()])
        if params != self._graph_params:
            self._graphs.clear()
            self._graph_params = params
        key = (b, h, w, label_ch, prev_ch, gen.dtype, self.device)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = StepGraph(gen, b, h, w, label_ch,
                                                  prev_ch)
        return graph

    def _scan_frames(self, label_chunks, t: int) -> Iterator[torch.Tensor]:
        """The scan over an utterance batch: [B, n, H, W, 3] uint8 label
        chunks on the device -> its frames in [-1, 1] in the compute dtype,
        [B, n', H', W', 3] a chunk, the n' summing to ``min(t,
        max_frames)``. The carry passes from chunk to chunk, and the
        generator runs once a frame (:meth:`_scan_chunk`). A chunk's frames
        are not held here while the next chunk is scanned: a caller that
        maps them (to uint8, say) keeps only what it made of them."""
        chunks = self._normalize_chunks(label_chunks)
        b, _, h, w, _ = chunks[0].shape
        carry = self.init_carry(b, *self.target_hw(h, w))
        rem = min(t, self.config.max_frames)
        for chunk in chunks:
            if rem <= 0:
                break
            n = min(chunk.shape[1], rem)
            rem -= n
            frames, carry = self._scan_chunk(chunk.float() / 127.5 - 1.0,
                                             carry, n)
            yield frames
            del frames

    # ---- Jacobi (fixed-point) decoding -----------------------------------

    @torch.inference_mode()
    def jacobi_device(self, labels: torch.Tensor, sweeps: int) -> torch.Tensor:
        """[T, H, W, 3] normalized labels on the device -> [T, H', W', 3]
        f32 frames in [-1, 1], by Jacobi iteration on the autoregressive
        chain.

        The scan is the fixed point of ``frames[t] = G(labels[t-ctx+1..t],
        frames[t-prev..t-1])``. A sweep runs the generator over the whole
        timeline, ``time_bucket`` frames a call, each frame fed the previous
        sweep's neighbours (zeros before frame 0 and on the first sweep).
        Frame 0 has no previous frame and is exact after one sweep; every
        further sweep carries the exact prefix at least one frame on, so
        ``sweeps >= T`` reproduces the scan in exact arithmetic. In floats
        the reductions of a batched call are ordered differently from a
        one-frame call's, and the warp recurrence amplifies that.

        As in the scan, the label context is cast once to the generator
        dtype, frames stay in that dtype between sweeps and are upcast once
        at the end. The last bucket runs at its real length: no generator
        call sees padding frames."""
        cfg = self.config
        t, h, w = labels.shape[:3]
        h2, w2 = self.target_hw(h, w)
        labels = labels.float()
        if (h2, w2) != (h, w):
            labels = resize_labels(labels, h2, w2)
        dt = self.generator.dtype
        labels = labels.to(dt)
        labels_ctx = torch.cat(
            [labels] + [_shift_frames(labels, k)
                        for k in range(1, cfg.n_frames_ctx)], dim=-1)
        has_prev = (torch.arange(t, device=labels.device) > 0).float()
        bucket = max(min(self.time_bucket, t), 1)
        frames = torch.zeros((t, h2, w2, 3), dtype=dt, device=labels.device)
        for _ in range(max(int(sweeps), 1)):
            prev_imgs = torch.cat(
                [_shift_frames(frames, k)
                 for k in range(1, cfg.use_prev_frames + 1)], dim=-1)
            outs = []
            for lo in range(0, t, bucket):
                hi = lo + bucket
                frame, _, _ = self.generator(labels_ctx[lo:hi],
                                             prev_imgs[lo:hi], has_prev[lo:hi])
                outs.append(frame.to(dt))
            frames = torch.cat(outs, dim=0)
        return frames.float()

    @torch.inference_mode()
    def _jacobi_block(self, labels: torch.Tensor, sweeps: int,
                      mesh) -> torch.Tensor:
        """This rank's share of :meth:`jacobi_device` over ``mesh``: the
        timeline's ``t`` frames, padded to a multiple of the "data" axis, in
        blocks of ``per`` frames, one a rank. ``labels`` [t, H, W, 3]: the
        whole timeline (uint8, or floats in [-1, 1]) on any device, the same
        on every rank. Returns this rank's [per, H', W', 3] f32 frames, zeros
        past ``t``.

        The label context of the block's first frames reads the
        ``n_frames_ctx - 1`` labels before it from the replicated input.
        Before each sweep the block takes the previous sweep's last
        ``use_prev_frames`` frames of the rank before it (``halo_rows``).
        The generator runs on the block's share of the single process's
        ``time_bucket`` slices of the global timeline, so where the blocks
        start on bucket boundaries every call is one of ``jacobi_device``'s
        and the frames are its bits."""
        cfg = self.config
        t, h, w = labels.shape[:3]
        h2, w2 = self.target_hw(h, w)
        dt, dev = self.generator.dtype, self.device
        per, _ = padded_rows(t, mesh)
        start = mesh.rank * per
        n_local = max(min(start + per, t) - start, 0)
        n_ctx, n_prev = cfg.n_frames_ctx - 1, cfg.use_prev_frames
        if n_local:
            lo = max(start - n_ctx, 0)
            lab = labels[lo: start + n_local].to(dev)
            lab = (lab.float() / 127.5 - 1.0 if lab.dtype == torch.uint8
                   else lab.float())
            if (h2, w2) != (h, w):
                lab = resize_labels(lab, h2, w2)
            lab = lab.to(dt)
            front = n_ctx - (start - lo)  # context before frame 0: zeros
            lab = torch.cat([lab.new_zeros((front,) + lab.shape[1:]), lab])
            labels_ctx = torch.cat(
                [lab[n_ctx - k: n_ctx - k + n_local]
                 for k in range(n_ctx + 1)], dim=-1)
            has_prev = (torch.arange(start, start + n_local,
                                     device=dev) > 0).float()
        bucket = max(min(self.time_bucket, t), 1)
        frames = torch.zeros((per, h2, w2, 3), dtype=dt, device=dev)
        for _ in range(max(int(sweeps), 1)):
            halo, _ = halo_rows(frames, mesh, n_prev, 0)
            ext = torch.cat([halo, frames])
            prev_imgs = torch.cat(
                [ext[n_prev - k: n_prev - k + n_local]
                 for k in range(1, n_prev + 1)], dim=-1)
            outs = []
            g = start
            while g < start + n_local:
                hi = min((g // bucket + 1) * bucket, start + n_local)
                i0, i1 = g - start, hi - start
                frame, _, _ = self.generator(labels_ctx[i0:i1],
                                             prev_imgs[i0:i1],
                                             has_prev[i0:i1])
                outs.append(frame.to(dt))
                g = hi
            # The padding rows past t stay zero.
            frames = torch.cat(outs + [frames[n_local:]], dim=0)
        return frames.float()

    def jacobi_sharded(self, labels: torch.Tensor, sweeps: int,
                       mesh) -> torch.Tensor:
        """:meth:`jacobi_device` with the timeline spread over ``mesh``'s
        "data" axis (:meth:`_jacobi_block`): [t, H, W, 3] labels in [-1, 1],
        the same on every rank -> the whole [t, H', W', 3] f32 frames on
        every rank, on the renderer's device."""
        block = self._jacobi_block(labels, sweeps, mesh)
        return gather_rows(block, mesh, labels.shape[0])

    def render_jacobi_sharded(self, labels_u8: np.ndarray, mesh,
                              sweeps: int = 3) -> np.ndarray:
        """:meth:`render_jacobi` with the timeline spread over ``mesh``'s
        "data" axis (replicated over its "model" axis): every rank calls with
        the same [T, H, W, 3] uint8 host labels and gets all [min(T,
        max_frames), H', W', 3] uint8 frames. Each rank uploads, sweeps and
        quantizes only its data index's block; the blocks are gathered as
        uint8."""
        t = min(labels_u8.shape[0], self.config.max_frames)
        block = self._jacobi_block(torch.as_tensor(labels_u8[:t]), sweeps,
                                   mesh)
        return gather_rows(_quantize_u8(block), mesh, t).cpu().numpy()

    def render_jacobi(self, labels_u8: np.ndarray,
                      sweeps: int = 3) -> np.ndarray:
        """[T, H, W, 3] uint8 host labels -> [T, H', W', 3] uint8 frames by
        ``sweeps`` Jacobi sweeps (:meth:`jacobi_device`). Few sweeps are the
        fast mode: the generator runs at batch ``time_bucket`` instead of
        batch 1, for ``sweeps`` times the arithmetic."""
        t = min(labels_u8.shape[0], self.config.max_frames)
        labels = torch.as_tensor(labels_u8[:t], device=self.device)
        frames = self.jacobi_device(labels.float() / 127.5 - 1.0, sweeps)
        return _quantize_u8(frames).cpu().numpy()

    def generate_device(self, labels_u8: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, 3] uint8 label maps on the device -> [B, min(T,
        max_frames), H', W', 3] uint8 frames on the device, scanned in
        chunks of ``time_bucket`` (:meth:`_scan_frames`)."""
        if labels_u8.dtype != torch.uint8:
            raise TypeError(f"labels must be uint8, got {labels_u8.dtype}")
        t, bucket = labels_u8.shape[1], self.time_bucket
        chunks = [labels_u8[:, lo: lo + bucket] for lo in range(0, t, bucket)]
        return torch.cat(list(map(_quantize_u8, self._scan_frames(chunks, t))),
                         dim=1)

    def render(self, labels_u8: np.ndarray) -> np.ndarray:
        """[T, H, W, 3] uint8 label maps -> [min(T, max_frames), H', W', 3]
        uint8 frames."""
        t = min(labels_u8.shape[0], self.config.max_frames)
        frames = self.generate_device(
            torch.as_tensor(labels_u8[None, :t], device=self.device))
        return frames[0].cpu().numpy()

    def render_from_device_chunks(self, label_chunks, t: int) -> np.ndarray:
        """On-device uint8 label chunks ([time_bucket, H, W, 3] each, the
        rasterizer's ``to_host=False`` output) -> [min(t, max_frames), H',
        W', 3] uint8 host frames, by the configured decoding
        (:meth:`_frame_chunks`). Labels never go through the host."""
        frames = map(_quantize_u8, self._frame_chunks(label_chunks, t))
        return torch.cat(list(frames)).cpu().numpy()

    def _normalize_chunks(self, label_chunks) -> List[torch.Tensor]:
        """Make every [B, n, H, W, 3] chunk at least n_frames_ctx-1 frames
        long for the chunk-wide label-context assembly. A short final chunk
        is zero-padded (its pad frames are dropped by the caller's ``t``); a
        short chunk mid-stream re-slices the whole timeline into uniform
        time_bucket chunks, which keeps the scan exact."""
        min_len = self.config.n_frames_ctx - 1
        chunks = list(label_chunks)
        if not chunks:
            raise ValueError("no label chunks")
        if all(c.shape[1] >= min_len for c in chunks[:-1]):
            last = chunks[-1]
            if last.shape[1] < min_len:
                chunks[-1] = F.pad(
                    last, (0, 0, 0, 0, 0, 0, 0, min_len - last.shape[1]))
            return chunks
        flat = torch.cat(chunks, dim=1)
        bucket = max(self.time_bucket, min_len)
        pad = (-flat.shape[1]) % bucket
        if pad:
            flat = F.pad(flat, (0, 0, 0, 0, 0, 0, 0, pad))
        return [flat[:, lo: lo + bucket]
                for lo in range(0, flat.shape[1], bucket)]

    def _pack_coeff_planes(self, yq, uq, vq) -> torch.Tensor:
        """The three coefficient planes as ONE flat wire tensor: the
        per-block-shift bit-packed uint8 stream (``config.wire_packed``,
        ``ops/dct.py::pack_plane_shift``) or the raw int8 coefficients."""
        if self.config.wire_packed:
            return torch.cat([pack_plane_shift(yq, W_AC_LUMA),
                              pack_plane_shift(uq, W_AC_CHROMA),
                              pack_plane_shift(vq, W_AC_CHROMA)])
        return torch.cat([yq.reshape(-1), uq.reshape(-1), vq.reshape(-1)])

    def _encode_wire(self, frames: torch.Tensor) -> torch.Tensor:
        """[n, H', W', 3] frames in [-1, 1] -> one flat wire tensor on their
        device, in ``config.wire_format``: DCT coefficients of the float
        YUV420 planes, or the rounded uint8 planes."""
        cfg = self.config
        with profiling.span("wire.encode"):
            if cfg.wire_format == "dct":
                yq, uq, vq = encode_yuv(
                    *rgb_norm_to_yuv420_float(frames),
                    quality=cfg.wire_quality, k_luma=cfg.wire_k_luma,
                    k_chroma=cfg.wire_k_chroma)
                return self._pack_coeff_planes(yq, uq, vq)
            return torch.cat([p.reshape(-1)
                              for p in rgb_norm_to_yuv420(frames)])

    def _split_wire(self, arr: np.ndarray, n: int, h2: int, w2: int):
        """One pulled wire array of ``n`` frames -> its three per-plane
        arrays: int8 coefficients ([n, hb, wb, k], the packed stream unpacked
        by the native codec) under ``"dct"``, uint8 planes under
        ``"yuv420"``."""
        cfg = self.config
        hc, wc = h2 // 2, w2 // 2
        if cfg.wire_format != "dct":
            sy, su = n * h2 * w2, n * hc * wc
            return (arr[:sy].reshape(n, h2, w2),
                    arr[sy: sy + su].reshape(n, hc, wc),
                    arr[sy + su: sy + 2 * su].reshape(n, hc, wc))
        kl, kc = cfg.wire_k_luma, cfg.wire_k_chroma
        luma = (n, -(-h2 // 8), -(-w2 // 8), kl)
        chroma = (n, -(-hc // 8), -(-wc // 8), kc)
        if cfg.wire_packed:
            sy = packed_plane_bytes(int(np.prod(luma[:-1])), kl, W_AC_LUMA)
            su = packed_plane_bytes(int(np.prod(chroma[:-1])), kc,
                                    W_AC_CHROMA)
            return (unpack_plane_shift_np(arr[:sy], luma, W_AC_LUMA),
                    unpack_plane_shift_np(arr[sy: sy + su], chroma,
                                          W_AC_CHROMA),
                    unpack_plane_shift_np(arr[sy + su: sy + 2 * su], chroma,
                                          W_AC_CHROMA))
        arr = arr.view(np.int8)
        sy, su = int(np.prod(luma)), int(np.prod(chroma))
        return (arr[:sy].reshape(luma), arr[sy: sy + su].reshape(chroma),
                arr[sy + su: sy + 2 * su].reshape(chroma))

    def _unpack_wire(self, arr: np.ndarray, n: int, h2: int, w2: int):
        """Split + decode one pulled wire array into (y, u, v) uint8 planes,
        cropped (``encode_plane`` edge-pads planes whose sides are not
        multiples of 8)."""
        a, b, c = self._split_wire(arr, n, h2, w2)
        if self.config.wire_format != "dct":
            return a, b, c
        lq, cq = quant_tables(self.config.wire_quality)
        hc, wc = h2 // 2, w2 // 2
        return (decode_plane_np(a, lq)[..., :h2, :w2],
                decode_plane_np(b, cq)[..., :hc, :wc],
                decode_plane_np(c, cq)[..., :hc, :wc])

    def _stream_wire(self, label_chunks, t: int, timer=None
                     ) -> Iterator[Tuple[np.ndarray, int, Tuple[int, int]]]:
        """Shared streaming loop: (host wire array, frames, (H', W')) a
        chunk. Chunk i's wire tensor is copied to pinned host memory
        asynchronously while chunk i+1 is rendered, and handed out only after
        that, so the copy and the consumer overlap the next chunk's compute.
        ``timer`` (a StageTimer) records the wait in ``render_pull``; the
        counter ``wire_bytes`` adds up the wire tensors copied."""
        def span(name):
            return timer.stage(name) if timer else contextlib.nullcontext()

        pending = None
        for frames in self._frame_chunks(label_chunks, t):
            wire = self._encode_wire(frames)
            profiling.count("wire_bytes", wire.nbytes)
            copy = (_to_host_async(wire), frames.shape[0],
                    tuple(frames.shape[1:3]))
            if pending is not None:
                yield self._wait_host(pending, span)
            pending = copy
        if pending is not None:
            yield self._wait_host(pending, span)

    @staticmethod
    def _wait_host(pending, span):
        (host, event), n, hw = pending
        with span("render_pull"):
            if event is not None:
                event.synchronize()
        return host.numpy(), n, hw

    def render_stream_yuv(
        self, label_chunks, t: int, timer=None
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Stream-render on-device uint8 label chunks to host YUV420 planes:
        yields (y [n, H', W'], u [n, H'/2, W'/2], v [n, H'/2, W'/2]) uint8
        arrays, the n summing to ``t``.

        The chunk crosses in ``config.wire_format``: under ``"dct"`` the
        packed coefficients are unpacked and decoded on the host (numpy),
        under ``"yuv420"`` the planes cross as they are (:meth:`_stream_wire`
        for the overlap). ``config.decode_mode == "jacobi"`` decodes the
        whole timeline first and then hands out the same chunks the same
        way."""
        for arr, n, (h2, w2) in self._stream_wire(label_chunks, t, timer):
            yield self._unpack_wire(arr, n, h2, w2)

    def render_stream_coeffs(self, label_chunks, t: int, timer=None):
        """Like :meth:`render_stream_yuv` but yields each chunk's int8
        coefficient arrays undecoded, with the working size: ((yq [n, hb, wb,
        kl], uq, vq), (H', W')). For the native codec
        (``io/wire_native.py``: JPEGs assembled from the coefficients): the
        host never makes pixel planes. Requires ``config.wire_format ==
        "dct"``."""
        if self.config.wire_format != "dct":
            raise ValueError("render_stream_coeffs requires the dct wire")
        for arr, n, (h2, w2) in self._stream_wire(label_chunks, t, timer):
            yield self._split_wire(arr, n, h2, w2), (h2, w2)

    def _frame_chunks(self, label_chunks, t: int) -> Iterator[torch.Tensor]:
        """The utterance's frames in [-1, 1], [n, H', W', 3] a label chunk
        ([n, H, W, 3] uint8 on the device), the n summing to ``min(t,
        max_frames)``: by the scan (:meth:`_scan_frames`), or with
        ``config.decode_mode == "jacobi"`` by ``config.jacobi_sweeps``
        Jacobi sweeps over the whole timeline first."""
        label_chunks = list(label_chunks)
        if self.config.decode_mode != "jacobi":
            yield from map(operator.itemgetter(0), self._scan_frames(
                [c[None] for c in label_chunks], t))
            return
        if not label_chunks:
            raise ValueError("no label chunks")
        want = min(t, self.config.max_frames)
        labels = torch.cat(label_chunks)[:want].float() / 127.5 - 1.0
        frames = self.jacobi_device(labels, self.config.jacobi_sweeps)
        bucket = label_chunks[0].shape[0]
        for lo in range(0, frames.shape[0], bucket):
            yield frames[lo: lo + bucket]

    def render_many(self, labels_u8: np.ndarray, mesh=None) -> np.ndarray:
        """[B, T, H, W, 3] uint8 host labels -> [B, T, H', W', 3] uint8
        frames: the utterances share one scan, each generator step at
        batch B. With ``mesh`` the batch axis shards over its "data" axis
        and replicates over its "model" axis: every rank calls with the
        same labels, uploads and scans its data index's B / n rows (B must
        divide), and gets every row back."""
        rows = self._mesh_rows(labels_u8.shape[0], mesh)
        return self._scan_rows(
            torch.as_tensor(labels_u8[rows], device=self.device), mesh)

    def render_many_device(self, labels_u8: torch.Tensor,
                           mesh=None) -> np.ndarray:
        """Like :meth:`render_many`, for [B, T, H, W, 3] uint8 labels already
        on the device (e.g. stacked rasterizer output): the label side never
        goes through the host."""
        rows = self._mesh_rows(labels_u8.shape[0], mesh)
        return self._scan_rows(labels_u8[rows], mesh)

    @staticmethod
    def _mesh_rows(b: int, mesh) -> slice:
        """This rank's rows of a batch of ``b`` utterances (all of them
        without a mesh)."""
        if mesh is None:
            return slice(None)
        if b % mesh.n_data:
            raise ValueError(
                f"batch of {b} utterances does not divide over the mesh's "
                f"{mesh.n_data} data shards")
        per = b // mesh.n_data
        return slice(mesh.rank * per, (mesh.rank + 1) * per)

    def _scan_rows(self, labels_u8: torch.Tensor, mesh) -> np.ndarray:
        """[b, T, H, W, 3] uint8 device labels -> [b, min(T, max_frames),
        H', W', 3] uint8 host frames, one scan at batch b; with ``mesh``
        every rank's rows, gathered in rank order.

        On a card the frames come back in one copy into pinned memory from
        PyTorch's caching host allocator, an order of magnitude faster than
        a pageable ``.cpu()``. The returned array lives in that memory: the
        allocator rounds its size up to a power of two, and once the array
        is dropped the block goes back to the allocator's cache (not to the
        OS) for the next call of that size. A caller that keeps many
        results copies them out."""
        out = self.generate_device(labels_u8)
        if mesh is not None:
            out = gather_rows(out, mesh)
        if out.device.type == "cpu":
            return out.numpy()
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out)
        return host.numpy()
