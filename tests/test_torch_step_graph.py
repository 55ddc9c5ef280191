"""The scan's step on a card (``render.py::StepGraph``, a captured CUDA graph
replayed a frame) and the generator's step-tap seam
(``CompositeGenerator.register_step_tap``).

CPU tests: the taps fire once a generator step, in step order, with
``forward``'s own arguments, as a wrapper of ``forward`` sees the steps, on
the serving paths and in the train unroll (recompute included); the
renderer's graph cache follows the parameters. Tests marked ``card`` hold
the replayed steps bit-equal to the eager loop on a CUDA card, both running
kernel B1 and the norm kernels (``ops/fused_norm.py``), for the single-scale
generator and the coarse-to-fine one at 1792x1024, and skip without one
(decided inside the test). This file imports neither JAX nor
the JAX package, so the card's tests run on the card's machine with
``python -m pytest --noconftest -m card tests/test_torch_step_graph.py``."""

import numpy as np
import pytest
import torch

from text2video_tpu_torch import render as render_mod
from text2video_tpu_torch.config import RenderConfig
from text2video_tpu_torch.models.generator import CompositeGenerator
from text2video_tpu_torch.models.layers import param_key
from text2video_tpu_torch.ops import fused_norm, fused_resblock
from text2video_tpu_torch.render import Renderer
from text2video_tpu_torch.train import trainer

torch.set_num_threads(1)

H, W, T, BUCKET = 32, 48, 5, 4  # 5 frames in chunks of 4: the carry crosses


def _tiny_renderer(**kw) -> Renderer:
    tr = Renderer.create(config=RenderConfig(wire_format="yuv420"),
                         base_ch=8, n_blocks=1, dtype=torch.float32,
                         device="cpu", **kw)
    tr.time_bucket = BUCKET
    return tr


def _labels_u8(t=T, h=H, w=W, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (t, h, w, 3),
                                               np.uint8)


def _record_both(gen):
    """The steps as a registered tap sees them and as a wrapper of
    ``forward`` (what the benchmark's tap did before the seam) sees them."""
    tapped, wrapped = [], []
    gen.register_step_tap(lambda *a: tapped.append(a))
    forward = gen.forward

    def wrapper(labels, prev_imgs, has_prev):
        out = forward(labels, prev_imgs, has_prev)
        wrapped.append((labels, prev_imgs, has_prev, out[0]))
        return out
    gen.forward = wrapper
    return tapped, wrapped


def _same_calls(tapped, wrapped):
    assert len(tapped) == len(wrapped)
    for a, b in zip(tapped, wrapped):
        assert all(x is y for x, y in zip(a, b))


@pytest.mark.parametrize("path", ["generate_device", "yuv_stream",
                                  "render_many"])
def test_step_tap_fires_once_a_step_with_forwards_arguments(path):
    tr = _tiny_renderer()
    tapped, wrapped = _record_both(tr.generator)
    labels = _labels_u8()
    if path == "generate_device":
        tr.generate_device(torch.from_numpy(labels)[None])
    elif path == "yuv_stream":
        pad = np.zeros((2 * BUCKET - T, H, W, 3), np.uint8)
        full = np.concatenate([labels, pad])
        list(tr.render_stream_yuv([torch.from_numpy(full[:BUCKET]),
                                   torch.from_numpy(full[BUCKET:])], T))
    else:
        tr.render_many(np.stack([labels, labels]))
    assert len(tapped) == T
    _same_calls(tapped, wrapped)
    # In step order: step 0 alone has no previous frame, and each step is
    # fed the frame the step before made.
    assert [float(c[2][0]) for c in tapped] == [0.0] + [1.0] * (T - 1)
    for a, b in zip(tapped, tapped[1:]):
        assert torch.equal(b[1][..., :3], a[3])


def test_step_tap_fires_in_the_train_unroll_as_forward_runs():
    cfg = trainer.TrainConfig()
    assert cfg.remat
    gen = CompositeGenerator(in_channels=3 * (cfg.n_frames_ctx
                                              + cfg.use_prev_frames),
                             base_ch=8, n_blocks=1, dtype=torch.float32,
                             fused_resblocks=False)
    gen.reset_parameters(torch.Generator().manual_seed(0))
    tapped, wrapped = _record_both(gen)
    g = torch.Generator().manual_seed(1)
    labels = torch.rand((2, 3, 16, 16, 3), generator=g) * 2 - 1
    fakes, _ = trainer._generate_clip(gen, cfg, labels, labels)
    assert len(tapped) == 3  # the forward: one a frame
    _same_calls(tapped, wrapped)
    # The recompute under remat: the taps see what the wrapper sees (the
    # non-reentrant checkpoint stops a recompute once it holds what the
    # backward needs, before the end of ``forward``, so neither sees one).
    fakes.sum().backward()
    _same_calls(tapped, wrapped)


def test_step_taps_paused_and_fired_by_hand():
    gen = _tiny_renderer().generator
    seen = []
    gen.register_step_tap(lambda *a: seen.append(a))
    x = torch.zeros((1, H, W, 9)), torch.zeros((1, H, W, 6)), torch.ones(1)
    with torch.no_grad():
        with gen.step_taps_paused():
            gen(*x)
        assert seen == []
        frame = gen(*x)[0]
    assert len(seen) == 1
    gen.fire_step_taps(*x, frame)
    assert len(seen) == 2 and all(a is b for a, b in zip(seen[1], (*x, frame)))


def test_param_key_follows_an_in_place_load_and_a_move():
    gen = _tiny_renderer().generator
    params = list(gen.parameters())
    key = param_key(params)
    assert key == param_key(params)
    gen.load_state_dict(gen.state_dict())
    loaded = param_key(params)
    assert loaded != key
    assert [p for p, _ in loaded] == [p for p, _ in key]  # same storage
    gen.to(torch.float64)
    assert [p for p, _ in param_key(gen.parameters())] != [
        p for p, _ in key]


class _FakeGraph:
    """Stands in for ``StepGraph`` on the CPU: counts the captures."""
    made = []

    def __init__(self, gen, *shape):
        self.shape = shape
        _FakeGraph.made.append(self)


def test_step_graph_cache_recaptures_after_a_load(monkeypatch):
    monkeypatch.setattr(render_mod, "StepGraph", _FakeGraph)
    _FakeGraph.made = []
    tr = _tiny_renderer()
    assert tr._step_graph(1, H, W, 9, 6) is None  # no graph off a card
    monkeypatch.setattr(Renderer, "device", torch.device("cuda"))
    a = tr._step_graph(1, H, W, 9, 6)
    assert tr._step_graph(1, H, W, 9, 6) is a
    b = tr._step_graph(4, H, W, 9, 6)  # another shape: its own graph
    assert b is not a and tr._step_graph(1, H, W, 9, 6) is a
    tr.generator.load_state_dict(tr.generator.state_dict())
    c = tr._step_graph(1, H, W, 9, 6)
    assert c is not a
    assert list(tr._graphs.values()) == [c]  # the stale graphs dropped
    assert len(_FakeGraph.made) == 3


# ---- on a card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_renderer(dev, seed=0, local=0) -> Renderer:
    torch.manual_seed(seed)
    tr = Renderer.create(config=RenderConfig(), seed=seed, device=dev,
                         n_local_enhancers=local)
    # A tenth of the lecun heads keeps flows at a few pixels, as trained
    # weights have them (a 30 px flow turns the frames to noise).
    with torch.no_grad():
        tr.generator.heads.kernel.mul_(0.1)
    tr.time_bucket = 4
    return tr


def _scan_all(tr, labels_u8, eager: bool):
    """(frames [B, T, H', W', 3] compute dtype, carries, tapped steps) of
    the chunked scan over uint8 ``labels_u8`` [B, T, H, W, 3]: chunks of
    ``time_bucket`` and a partial last one, the graph replayed or, with
    ``eager``, the generator called in Python."""
    if eager:
        tr._step_graph = lambda *a: None
    else:
        tr.__dict__.pop("_step_graph", None)
    steps = []

    def tap(*a):
        steps.append(tuple(x.clone() for x in a))
    tr.generator._step_taps = [tap]
    b, t, h, w, _ = labels_u8.shape
    carry = tr.init_carry(b, h, w)
    frames, carries = [], []
    for lo in range(0, t, tr.time_bucket):
        chunk = labels_u8[:, lo: lo + tr.time_bucket].float() / 127.5 - 1.0
        n = chunk.shape[1]
        if n < tr.time_bucket:
            chunk = torch.nn.functional.pad(
                chunk, (0, 0, 0, 0, 0, 0, 0, tr.time_bucket - n))
        out, carry = tr._scan_chunk(chunk, carry, n)
        frames.append(out)
        carries.append(carry)
    tr.generator._step_taps = []
    return torch.cat(frames, dim=1), carries, steps


@pytest.mark.card
@pytest.mark.parametrize("batch,h,w,local", [
    (1, 384, 512, 0), (4, 512, 896, 0),
    (4, 1024, 1792, 1),  # the trunk at 896x512, one local enhancer on top
])
def test_replayed_steps_bit_equal_the_eager_loop(batch, h, w, local):
    dev = _card()
    tr = _card_renderer(dev, local=local)
    t = 2 * tr.time_bucket + 2  # two chunks and a partial one
    labels = torch.from_numpy(np.stack(
        [_labels_u8(t, h, w, seed=s) for s in range(batch)])).to(dev)
    # A step: B1 at the trunk's 18 resblock convs; the norm apply after
    # the trunk's 25 convs and the enhancer's 9 normed ones (stem, down, 6
    # resblock convs, upsample: its merge conv has no norm), the
    # statistics kernel after the 7 + 9 that B1 does not serve.
    per_step = {"norm_stats": (7 + 9 * local) * t,
                "norm_apply": (25 + 9 * local) * t}
    fused_norm.launches.update(norm_stats=0, norm_apply=0)
    eager, eager_carry, eager_steps = _scan_all(tr, labels, eager=True)
    assert fused_norm.launches == per_step
    fused_resblock.launches = 0
    fused_norm.launches.update(norm_stats=0, norm_apply=0)
    graph, graph_carry, graph_steps = _scan_all(tr, labels, eager=False)
    assert fused_resblock.launches == 18 * t  # capture not counted
    assert fused_norm.launches == per_step
    assert len(tr._graphs) == 1
    assert graph.dtype == eager.dtype and torch.equal(graph, eager)
    for a, b in zip(graph_carry, eager_carry):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert a[2] == b[2]
    assert len(graph_steps) == len(eager_steps) == t
    for a, b in zip(graph_steps, eager_steps):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert eager.float().std() > 0.01  # not a constant image
    # Warm, a replayed step counts the B1 and norm calls its graph holds.
    fused_resblock.launches = 0
    fused_norm.launches.update(norm_stats=0, norm_apply=0)
    _scan_all(tr, labels, eager=False)
    assert fused_resblock.launches == 18 * t
    assert fused_norm.launches == per_step


@pytest.mark.card
def test_load_state_dict_between_calls_recaptures():
    dev = _card()
    tr = _card_renderer(dev, seed=0)
    other = _card_renderer(dev, seed=1).generator.state_dict()
    labels = torch.from_numpy(_labels_u8(6, 384, 512)[None]).to(dev)
    first, _, _ = _scan_all(tr, labels, eager=False)
    (graph,) = tr._graphs.values()
    tr.generator.load_state_dict(other)
    replayed, _, _ = _scan_all(tr, labels, eager=False)
    assert list(tr._graphs.values()) != [graph]
    eager, _, _ = _scan_all(tr, labels, eager=True)
    assert torch.equal(replayed, eager)
    assert not torch.equal(replayed, first)
