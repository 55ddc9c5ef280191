"""The instance norm of the generator's conv blocks (``ops/fused_norm.py``).

CPU tests: the plain twins are the eager chain the layers ran before the
kernels, bit for bit (the conv bias tiled over phases, ``InstanceNorm``, the
ReLU, the residual add); the blocks take the twin on the CPU and wherever
autograd follows the block; the discriminators' norms never reach the
module; a call the kernel wrappers cannot take raises. Tests marked
``card`` hold both kernels against their twins on a CUDA card, at every
shape the served generator paths give them, and skip without one (decided
inside the test). This file imports neither JAX nor the JAX package, so the
card's tests run on the card's machine with
``python -m pytest --noconftest -m card tests/test_torch_fused_norm.py``."""

import pytest
import torch
import torch.nn.functional as F

from text2video_tpu_torch.models import layers
from text2video_tpu_torch.models.discriminator import MultiscaleDiscriminator
from text2video_tpu_torch.models.generator import CompositeGenerator
from text2video_tpu_torch.ops import fused_norm

torch.set_num_threads(1)


def _eager_chain(y, scale, shift, eps, dtype, bias=None, stats=None,
                 relu=False, residual=None):
    """The chain as the layers ran it before ``ops/fused_norm.py``:
    ``Conv.forward``'s ``+ b`` or ``_add_tiled``, ``InstanceNorm.forward``,
    ``F.relu`` and ``ResBlock.forward``'s ``x + ...``, written out."""
    c = scale.shape[0]
    phase = y.shape[-1] // c
    if bias is not None:
        y = (y.unflatten(-1, (4, c)) + bias).flatten(-2) if phase == 4 \
            else y + bias
    x = y.unflatten(-1, (phase, c)) if phase > 1 else y
    dims = (1, 2, 3) if phase > 1 else (1, 2)
    if stats is not None:
        mean, var = stats
    else:
        mean = x.float().mean(dim=dims)
        m2 = x.square().float().mean(dim=dims)
        var = torch.clamp(m2 - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    mul = (rstd * scale).to(dtype)
    add = (shift - mean * rstd * scale).to(dtype)
    idx = (slice(None),) + (None,) * len(dims)
    out = x * mul[idx] + add[idx]
    out = out.flatten(-2) if phase > 1 else out
    if relu:
        out = F.relu(out)
    return out if residual is None else residual + out


def _norm(c, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    norm = layers.InstanceNorm(c, dtype)
    with torch.no_grad():
        norm.scale.copy_(1.0 + 0.3 * torch.randn(c, generator=g))
        norm.bias.copy_(0.3 * torch.randn(c, generator=g))
    return norm


def _inputs(shape, c, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    bias = (torch.randn(c, generator=g) * 0.5).to(dtype)
    res = torch.randn(shape, generator=g).to(dtype)
    return y, bias, res


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("phase", [1, 4])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("with_residual", [False, True])
def test_twin_is_the_eager_chain_bit_for_bit(dtype, phase, relu,
                                             with_residual):
    c = 8
    norm = _norm(c, dtype)
    y, bias, res = _inputs((2, 5, 6, phase * c), c, dtype)
    residual = res if with_residual else None
    want = _eager_chain(y, norm.scale, norm.bias, norm.epsilon, dtype, bias,
                        relu=relu, residual=residual)
    with torch.no_grad():
        got = fused_norm.finish_plain(y, norm, bias, relu=relu,
                                      residual=residual)
        routed = fused_norm.finish(y, norm, bias, relu=relu,
                                   residual=residual)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(routed, want)
    # The statistics twin: those the chain takes of the biased output.
    mean, var = fused_norm.norm_stats_plain(y, norm, bias)
    x = fused_norm.add_bias(y, bias)
    x = x.unflatten(-1, (phase, c)) if phase > 1 else x
    dims = (1, 2, 3) if phase > 1 else (1, 2)
    m0 = x.float().mean(dim=dims)
    assert torch.equal(mean, m0)
    assert torch.equal(var, torch.clamp(
        x.square().float().mean(dim=dims) - m0.square(), min=0.0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_twin_with_the_convs_statistics(dtype):
    """A B1 block: no bias to add, the statistics handed in."""
    c = 16
    norm = _norm(c, dtype, seed=3)
    y, _, res = _inputs((3, 4, 7, c), c, dtype, seed=4)
    stats = (torch.randn(3, c) * 0.1, torch.rand(3, c) * 4)
    for relu, residual in ((True, None), (False, res)):
        want = _eager_chain(y, norm.scale, norm.bias, norm.epsilon, dtype,
                            stats=stats, relu=relu, residual=residual)
        got = fused_norm.finish_plain(y, norm, stats=stats, relu=relu,
                                      residual=residual)
        assert torch.equal(got, want)


class _Card(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, to reach the
    dispatch's card side on the CPU."""

    @property
    def is_cuda(self):
        return True


def _record_kernels(monkeypatch):
    """Stand-ins for the kernel wrappers that count their calls and compute
    with the twins."""
    calls = {"norm_stats": 0, "norm_apply": 0, "plain": 0}
    plain = fused_norm.finish_plain

    def stats(y, features, bias=None):
        calls["norm_stats"] += 1
        norm = layers.InstanceNorm(features, y.dtype)
        return fused_norm.norm_stats_plain(y, norm, bias)

    def apply(y, mean, var, scale, shift, eps, bias=None, relu=False,
              residual=None):
        calls["norm_apply"] += 1
        norm = layers.InstanceNorm(scale.shape[0], y.dtype)
        norm.scale, norm.bias, norm.epsilon = scale, shift, eps
        return plain(y, norm, bias, (mean, var), relu, residual)

    def counted_plain(*a, **kw):
        calls["plain"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(fused_norm, "norm_stats", stats)
    monkeypatch.setattr(fused_norm, "norm_apply", apply)
    monkeypatch.setattr(fused_norm, "finish_plain", counted_plain)
    return calls


def _tiny_generator(fused):
    gen = CompositeGenerator(in_channels=15, base_ch=8, n_blocks=2,
                             dtype=torch.float32, fused_resblocks=fused)
    gen.reset_parameters(torch.Generator().manual_seed(0))
    return gen


def _gen_inputs(card: bool):
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((1, 16, 16, 9), generator=g) * 2 - 1,
         torch.rand((1, 16, 16, 6), generator=g) * 2 - 1, torch.ones(1))
    return tuple(t.as_subclass(_Card) for t in x) if card else x


def test_blocks_take_the_twin_on_the_cpu(monkeypatch):
    calls = _record_kernels(monkeypatch)
    gen = _tiny_generator(fused=True)
    with torch.no_grad():
        gen(*_gen_inputs(card=False))
    # 1 stem + 3 downsamples + 2 x 2 resblock convs + 3 upsamples.
    assert calls == {"norm_stats": 0, "norm_apply": 0, "plain": 11}


def test_blocks_take_the_twin_under_grad(monkeypatch):
    calls = _record_kernels(monkeypatch)
    gen = _tiny_generator(fused=False)
    frame = gen(*_gen_inputs(card=True))[0]
    assert calls == {"norm_stats": 0, "norm_apply": 0, "plain": 11}
    frame.float().sum().backward()
    assert gen.trunk.res[0].block1.norm.scale.grad is not None


@pytest.mark.parametrize("fused", [False, True])
def test_blocks_take_the_kernels_on_a_card_outside_autograd(monkeypatch,
                                                            fused):
    """What runs where: the 7 blocks B1 does not serve take both kernels;
    the resblocks' convs take the apply alone where B1 made their
    statistics, both kernels where they run plain. The frame is the
    twin's."""
    gen = _tiny_generator(fused)
    x = _gen_inputs(card=False)
    with torch.no_grad():
        want = gen(*x)[0]
    calls = _record_kernels(monkeypatch)
    with torch.no_grad():
        got = gen(*(t.as_subclass(_Card) for t in x))[0]
    assert calls == {"norm_stats": 7 if fused else 11, "norm_apply": 11,
                     "plain": 0}
    assert torch.equal(got.as_subclass(torch.Tensor), want)


def test_resblock_hands_its_input_to_the_last_apply(monkeypatch):
    block = layers.ResBlock(8, torch.float32, fused=False)
    for m in block.modules():
        if isinstance(m, layers.Conv):
            m.reset_parameters(torch.Generator().manual_seed(2))
    seen = []
    _record_kernels(monkeypatch)
    apply = fused_norm.norm_apply

    def spy(y, *a, relu=False, residual=None, **kw):
        seen.append((relu, residual))
        return apply(y, *a, relu=relu, residual=residual, **kw)
    monkeypatch.setattr(fused_norm, "norm_apply", spy)
    x = torch.randn(2, 6, 6, 8).as_subclass(_Card)
    with torch.no_grad():
        block(x)
    assert [r for r, _ in seen] == [True, False]
    assert seen[0][1] is None and seen[1][1] is x


def test_discriminator_norms_never_reach_the_module(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a discriminator reached ops/fused_norm.py")
    for name in ("finish", "finish_plain", "norm_stats", "norm_stats_plain",
                 "norm_apply", "add_bias"):
        monkeypatch.setattr(fused_norm, name, refuse)
    disc = MultiscaleDiscriminator(6, num_d=2, base_ch=8,
                                   dtype=torch.float32)
    disc.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 32, 32, 6)
    out = disc(x)
    sum(o[0].sum() for o in out).backward()
    with torch.no_grad():
        disc(x.as_subclass(_Card))


@pytest.mark.parametrize("call", ["cpu", "half", "channels", "f64_stats",
                                  "residual", "scale"])
def test_wrappers_refuse_what_the_kernels_cannot_take(call):
    y = torch.zeros(1, 4, 4, 16).as_subclass(_Card)
    stats = torch.zeros(1, 16), torch.ones(1, 16)
    scale, shift = torch.ones(16), torch.zeros(16)
    with pytest.raises(ValueError):
        if call == "cpu":  # a CPU tensor: the wrappers are the card's path
            fused_norm.norm_stats(torch.zeros(1, 4, 4, 16), 16)
        elif call == "half":
            fused_norm.norm_stats(y.half(), 16)
        elif call == "channels":  # 16 channels are no phases of 12
            fused_norm.norm_apply(y, *stats, torch.ones(12), torch.zeros(12),
                                  1e-5)
        elif call == "f64_stats":
            fused_norm.norm_stats(y.double(), 16)
        elif call == "residual":
            fused_norm.norm_apply(y, *stats, scale, shift, 1e-5,
                                  residual=torch.zeros(1, 4, 4, 8))
        else:
            fused_norm.norm_apply(y, torch.zeros(2, 16), torch.ones(2, 16),
                                  scale, shift, 1e-5)


# ---- on a card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ulp(m: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype`` at magnitude ``m`` (f32)."""
    bits = 8 if dtype == torch.bfloat16 else 24
    _, e = torch.frexp(m.clamp_min(torch.finfo(dtype).tiny))
    return torch.ldexp(torch.ones_like(m), e - bits)


# Limits against the twins (their readings: PERF.md, section 6). The
# statistics: mean within STATS_TOL of the rms of the biased output, var
# within STATS_TOL of its mean square (relative to the tensor's own scale:
# a mean near 0 has no relative precision). The apply on the kernel's
# statistics: within OUT_ULPS ulps of the compute dtype at the largest
# magnitude of the chain's terms (only rsqrt may part them). The whole
# chain against the twin's own statistics: within CHAIN_ULPS such ulps
# beyond what the statistics' difference (the f32 sum order) moves it by,
# |y| |mul_k - mul_t| + |add_k - add_t| with mul and add rounded as the
# chain rounds them; in f32 its three roundings (the product, the sum, the
# residual sum) may each land an ulp apart on values that differ by that
# much, and a binade edge adds one more.
STATS_TOL = 1e-5
OUT_ULPS = 2
CHAIN_ULPS = 4


def _affine(stats, norm, dt):
    mean, var = stats
    rstd = torch.rsqrt(var + norm.epsilon)
    mul = (rstd * norm.scale).to(dt).float()
    add = (norm.bias - mean * rstd * norm.scale).to(dt).float()
    return mul, add


@torch.inference_mode()
def _check_call(y, norm, bias, stats, relu, residual):
    """Both kernels against the twins on one block's inputs: asserts the
    limits above, two calls' bits equal and the input's layout kept;
    returns the readings."""
    dt = y.dtype
    c = norm.scale.shape[0]
    reading = {"shape": list(y.shape), "c": c, "dtype": str(dt)[6:],
               "relu": relu, "residual": residual is not None}
    same_bits = True
    twin_stats = stats
    if stats is None:
        mean, var = fused_norm.norm_stats(y, c, bias)
        mean2, var2 = fused_norm.norm_stats(y, c, bias)
        same_bits = torch.equal(mean, mean2) and torch.equal(var, var2)
        m0, v0 = fused_norm.norm_stats_plain(y, norm, bias)
        m2 = v0 + m0.square()
        reading["mean_err"] = ((mean - m0).abs() / m2.sqrt()).max().item()
        reading["var_err"] = ((var - v0).abs() / m2).max().item()
        stats, twin_stats = (mean, var), (m0, v0)
    out = fused_norm.norm_apply(y, *stats, norm.scale, norm.bias,
                                norm.epsilon, bias=bias, relu=relu,
                                residual=residual)
    again = fused_norm.norm_apply(y, *stats, norm.scale, norm.bias,
                                  norm.epsilon, bias=bias, relu=relu,
                                  residual=residual)
    same_bits = same_bits and torch.equal(out, again)
    assert out.stride() == y.stride() or not (
        y.is_contiguous() or fused_norm._planar(y, c)), "layout changed"
    # The apply alone, on the kernel's statistics: only rsqrt may part them.
    same = fused_norm.finish_plain(y, norm, bias, stats, relu, residual)
    # The whole chain, on the twin's own statistics.
    want = fused_norm.finish_plain(y, norm, bias, twin_stats, relu,
                                   residual)
    mul_k, add_k = _affine(stats, norm, dt)
    mul_t, add_t = _affine(twin_stats, norm, dt)
    yb = (fused_norm.add_bias(y, bias) if bias is not None else y).float()
    yb = yb.unflatten(-1, (y.shape[-1] // c, c))
    idx = (slice(None),) + (None,) * (yb.dim() - 3) + (None, slice(None))
    mag = torch.maximum((yb * mul_t[idx]).abs(), add_t[idx].abs())
    slack = (yb.abs() * (mul_k - mul_t).abs()[idx]
             + (add_k - add_t).abs()[idx]).flatten(-2)
    mag = torch.maximum(mag.flatten(-2), want.float().abs())
    if residual is not None:
        mag = torch.maximum(mag, residual.float().abs())
    ulp = _ulp(mag, dt)
    err = (out.float() - want.float()).abs()
    reading["apply_ulps"] = ((out.float() - same.float()).abs()
                             / ulp).max().item()
    reading["chain_ulps_raw"] = (err / ulp).max().item()
    reading["chain_ulps"] = ((err - slack).clamp_min(0) / ulp).max().item()
    print("reading", reading)
    assert same_bits, reading
    assert reading.get("mean_err", 0) <= STATS_TOL, reading
    assert reading.get("var_err", 0) <= STATS_TOL, reading
    assert reading["apply_ulps"] <= OUT_ULPS, reading
    assert reading["chain_ulps"] <= CHAIN_ULPS, reading
    return reading


def _recorded_calls(gen, inputs):
    """The arguments of every ``fused_norm.finish`` call of one generator
    forward (cloned: the forward goes on)."""
    calls = []
    finish = fused_norm.finish

    def record(y, norm, bias=None, stats=None, relu=False, residual=None):
        calls.append((y.clone(), norm, bias, None if stats is None else
                      tuple(s.clone() for s in stats), relu,
                      None if residual is None else residual.clone()))
        return finish(y, norm, bias, stats, relu, residual)
    fused_norm.finish = record
    try:
        with torch.inference_mode():
            gen(*inputs)
    finally:
        fused_norm.finish = finish
    return calls


def _card_generator(dev, h, w, batch, dtype=torch.bfloat16, seed=0,
                    **kw):
    g = torch.Generator().manual_seed(seed)
    gen = CompositeGenerator(in_channels=15, dtype=dtype, **kw)
    gen.reset_parameters(g)
    with torch.no_grad():  # norm affines and conv biases off their defaults
        for m in gen.modules():
            if isinstance(m, layers.InstanceNorm):
                m.scale.copy_(1.0 + 0.2 * torch.randn(m.scale.shape,
                                                      generator=g))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
            elif isinstance(m, layers.Conv):
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    gen = gen.to(dev)
    x = (torch.rand((batch, h, w, 9), generator=g) * 2 - 1,
         torch.rand((batch, h, w, 6), generator=g) * 2 - 1,
         torch.ones(batch))
    return gen, tuple(t.to(dev) for t in x)


@pytest.mark.card
@pytest.mark.parametrize("case", [
    "fadg0-b1", "henan-b4", "local-enhancer", "f32"])
def test_kernels_match_the_twins_on_every_served_block(case):
    """Every block of a served generator forward: fadg0 at 512x384 batch 1
    (the text2mp4 scan), henan at 896x512 batch 4, a local enhancer's
    32-channel blocks, and the f32 generator at batch 1."""
    dev = _card()
    kw = {}
    if case == "fadg0-b1":
        h, w, b = 384, 512, 1
    elif case == "henan-b4":
        h, w, b = 512, 896, 4
    elif case == "local-enhancer":
        h, w, b = 384, 512, 1
        kw = dict(n_local_enhancers=1, n_local_blocks=1)
    else:
        h, w, b = 384, 512, 1
        kw = dict(dtype=torch.float32)
    gen, x = _card_generator(dev, h, w, b, **kw)
    calls = _recorded_calls(gen, x)
    # The trunk: 7 blocks with both kernels, 18 B1 convs with the apply;
    # a local enhancer's stem, downsample, 2 plain resblock convs and
    # upsample with both.
    extra = 5 if "n_local_enhancers" in kw else 0
    assert len(calls) == 25 + extra
    assert sum(c[3] is None for c in calls) == 7 + extra
    for c in calls:
        _check_call(*c)
    if case == "local-enhancer":
        assert any(c[1].scale.shape[0] == 32 for c in calls)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(1, 48, 64, 512), (4, 64, 112, 512),
                                   (64, 48, 64, 512)])
def test_apply_matches_its_twin_at_the_resblock_shapes(shape):
    """The resblocks' apply at batch 1, henan's batch 4 and a Jacobi sweep's
    batch 64, with B1's statistics of the tensor, with the ReLU of block0
    and the residual of block1."""
    dev = _card()
    c = shape[-1]
    norm = _norm(c, torch.bfloat16, seed=5).to(dev)
    g = torch.Generator().manual_seed(6)
    y = (torch.randn(shape, generator=g) * 3 + 0.2).to(
        dev, torch.bfloat16)
    res = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    stats = norm.statistics(y)
    for relu, residual in ((True, None), (False, res)):
        _check_call(y, norm, None, stats, relu, residual)
    # The statistics kernel at the same shape, with a bias folded in.
    bias = (torch.randn(c, generator=g) * 0.5).to(dev, torch.bfloat16)
    _check_call(y, norm, bias, None, True, None)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,c", [((2, 5, 7, 12), 3), ((1, 3, 9, 20), 5),
                                     ((3, 6, 10, 4 * 40), 40)])
def test_odd_channel_counts_take_the_scalar_loads(dtype, shape, c):
    dev = _card()
    norm = _norm(c, dtype, seed=7).to(dev)
    y, bias, res = (t.to(dev) for t in _inputs(shape, c, dtype, seed=8))
    _check_call(y, norm, bias, None, True, res)
    # A misaligned view: 16-byte loads are refused, scalar ones taken.
    flat = torch.zeros(y.numel() + 1, dtype=dtype, device=dev)
    odd = flat[1:].view(y.shape)
    odd.copy_(y)
    _check_call(odd, norm, bias, None, False, None)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 128, 224, 256), (2, 5, 7, 24)])
def test_planar_layout_is_read_and_written_in_place(dtype, shape):
    """A block output whose NHWC view lies in memory as NCHW (cuDNN's
    output of the strided downsample convs): both kernels read it as it
    lies and the apply writes that layout back; 16-byte loads where a
    plane's rows allow them, scalar ones otherwise."""
    dev = _card()
    c = shape[-1]
    norm = _norm(c, dtype, seed=9).to(dev)
    y, bias, res = (t.to(dev) for t in _inputs(shape, c, dtype, seed=10))
    planar = y.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert fused_norm._planar(planar, c)
    _check_call(planar, norm, bias, None, True, None)
    res_planar = res.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    _check_call(planar, norm, bias, None, False, res_planar)
