"""The port's phase forms against the JAX package's, in f32 on the CPU: each
function of ``ops/phase_conv.py``, ``InstanceNorm`` over a phase tensor, each
phase mode of ``ConvBlock``, and the phase-form ``CompositeGenerator`` with
and without a local enhancer (its outputs and its parameter gradients), from
the same numpy-seeded inputs and converted parameters; the phase forms
against the port's own plain forms on the same parameters; the edge pad's
ordered backward; the phase kernels of a model-axis shard and their cache."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from text2video_tpu.models import generator as jgen
from text2video_tpu.models import layers as jlayers
from text2video_tpu.ops import phase_conv as jpc
from text2video_tpu_torch.convert import params_from_flax
from text2video_tpu_torch.models import layers as tl
from text2video_tpu_torch.models.generator import CompositeGenerator
from text2video_tpu_torch.ops import phase_conv as pc
from text2video_tpu_torch.parallel.model_axis import GatheredKernel

torch.set_num_threads(1)

# The spatial shapes of the JAX package's tests/test_phase_conv.py.
SHAPES = [(4, 4), (3, 5), (8, 6), (5, 3)]
TOL = dict(atol=1e-5, rtol=1e-5)
# The generator: both packages' f32 forwards, the heads kernel scaled as in
# tests/test_torch_generator.py so the flow stays at a few pixels.
H, W, BASE, BLOCKS = 32, 48, 8, 2
GEN_ATOL = 1e-4
PLAIN_ATOL = 2e-4  # phase form against plain, the JAX package's own bound
# Parameter gradients, of each tensor's largest entry across the network.
GRAD_RTOL = 2e-5


def _randn(rng, *shape, fan_in=None):
    a = rng.randn(*shape) / np.sqrt(fan_in or 1)
    return a.astype(np.float32)


def _close(port: torch.Tensor, ref, **tol) -> None:
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    np.testing.assert_allclose(port.detach().numpy(), ref, **(tol or TOL))


def _reflect_conv(f: torch.Tensor, k: torch.Tensor, pad: int,
                  stride: int = 1) -> torch.Tensor:
    """The plain form: reflect pad, then a VALID conv (NHWC, HWIO)."""
    return F.conv2d(tl.reflect_pad(f, pad).permute(0, 3, 1, 2), pc.oihw(k),
                    stride=stride).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------
# ops/phase_conv.py, function by function
# ---------------------------------------------------------------------

@pytest.mark.parametrize("h,w", SHAPES)
def test_space_depth_match_jax(h, w):
    rng = np.random.RandomState(h * 10 + w)
    f = _randn(rng, 2, 2 * h, 2 * w, 3)
    p = pc.space_to_depth2(torch.from_numpy(f))
    np.testing.assert_array_equal(p.numpy(),
                                  np.asarray(jpc.space_to_depth2(f)))
    np.testing.assert_array_equal(pc.depth_to_space2(p).numpy(), f)
    q = _randn(rng, 2, h, w, 12)
    np.testing.assert_array_equal(
        pc.depth_to_space2(torch.from_numpy(q)).numpy(),
        np.asarray(jpc.depth_to_space2(q)))


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_build_kernels_match_jax(cin, cout):
    rng = np.random.RandomState(cin * 10 + cout)
    k3, k7 = _randn(rng, 3, 3, cin, cout), _randn(rng, 7, 7, cin, cout)
    for port, ref in ((pc.build_up_kernel, jpc.build_up_kernel),
                      (pc.build_down_kernel, jpc.build_down_kernel)):
        _close(port(torch.from_numpy(k3)), ref(k3))
    _close(pc.build_head_kernel(torch.from_numpy(k7)),
           jpc.build_head_kernel(k7))
    # A gather in JAX, a selection product here: the same values exactly.
    np.testing.assert_array_equal(
        pc.build_head_kernel(torch.from_numpy(k7)).numpy(),
        np.asarray(jpc.build_head_kernel(k7)))
    assert np.asarray(jpc.build_up_kernel(k3)).shape == (2, 2, cin, 4 * cout)


@pytest.mark.parametrize("h,w", SHAPES)
def test_upsample2x_conv_phase_matches_jax(h, w):
    rng = np.random.RandomState(h * 10 + w + 1)
    x, k3 = _randn(rng, 2, h, w, 7), _randn(rng, 3, 3, 7, 5, fan_in=63)
    got = pc.upsample2x_conv_phase(torch.from_numpy(x), torch.from_numpy(k3))
    _close(got, jpc.upsample2x_conv_phase(jnp.asarray(x), jnp.asarray(k3)))
    up = torch.from_numpy(x).repeat_interleave(2, 1).repeat_interleave(2, 2)
    _close(pc.depth_to_space2(got),
           _reflect_conv(up, torch.from_numpy(k3), 1).numpy())


@pytest.mark.parametrize("h,w", SHAPES)
def test_align_phases_matches_jax(h, w):
    win = _randn(np.random.RandomState(h + w), 2, h + 1, w + 1, 12)
    np.testing.assert_array_equal(
        pc._align_phases(torch.from_numpy(win), h, w).numpy(),
        np.asarray(jpc._align_phases(jnp.asarray(win), h, w)))


# (1, 2) and (2, 1): rows outside the map clip onto it, as JAX's take does.
@pytest.mark.parametrize("h,w", SHAPES + [(1, 2), (2, 1)])
@pytest.mark.parametrize("axis", [1, 2])
def test_head_pad_axis_matches_jax(h, w, axis):
    c = 3
    p = _randn(np.random.RandomState(h * 7 + w), 2, h, w, 4 * c)
    stride = 2 * c if axis == 1 else c
    np.testing.assert_array_equal(
        pc._head_pad_axis(torch.from_numpy(p), axis, stride, c).numpy(),
        np.asarray(jpc._head_pad_axis(jnp.asarray(p), axis, stride, c)))


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("emit_phase", [False, True])
def test_head_conv_phase_matches_jax(h, w, emit_phase):
    rng = np.random.RandomState(h * 10 + w + 2)
    f, k7 = _randn(rng, 2, 2 * h, 2 * w, 6), _randn(rng, 7, 7, 6, 4,
                                                      fan_in=294)
    p = pc.space_to_depth2(torch.from_numpy(f))
    got = pc.head_conv_phase(p, torch.from_numpy(k7), emit_phase)
    _close(got, jpc.head_conv_phase(jnp.asarray(p.numpy()), jnp.asarray(k7),
                                    emit_phase))
    plain = _reflect_conv(torch.from_numpy(f), torch.from_numpy(k7), 3)
    _close(pc.depth_to_space2(got) if emit_phase else got, plain.numpy())


@pytest.mark.parametrize("h,w", SHAPES)
def test_down2x_conv_phase_matches_jax(h, w):
    rng = np.random.RandomState(h * 10 + w + 3)
    f, k3 = _randn(rng, 2, 2 * h, 2 * w, 5), _randn(rng, 3, 3, 5, 8,
                                                      fan_in=45)
    p = pc.space_to_depth2(torch.from_numpy(f))
    got = pc.down2x_conv_phase(p, torch.from_numpy(k3))
    _close(got, jpc.down2x_conv_phase(jnp.asarray(p.numpy()),
                                      jnp.asarray(k3)))
    _close(got, _reflect_conv(torch.from_numpy(f), torch.from_numpy(k3), 1,
                              stride=2).numpy())


@pytest.mark.parametrize("pads", [(1, 1, 1, 1), (1, 0, 1, 0), (2, 3, 0, 1)])
def test_edge_pad_backward_matches_replicate_autograd(pads):
    """The ordered backward of the edge pad against autograd of
    ``F.pad(mode="replicate")``; forward equal to JAX's edge pad."""
    rng = np.random.RandomState(sum(pads))
    x = torch.from_numpy(_randn(rng, 2, 5, 4, 3)).requires_grad_()
    y = pc.edge_pad(x, pads)
    top, bottom, left, right = pads
    ref = np.pad(x.detach().numpy(),
                 ((0, 0), (top, bottom), (left, right), (0, 0)), mode="edge")
    np.testing.assert_array_equal(y.detach().numpy(), ref)
    assert y.grad_fn.name().endswith("_DeterministicEdgePadBackward")
    g = torch.from_numpy(_randn(rng, *y.shape))
    got, = torch.autograd.grad(y, x, g)
    want, = torch.autograd.grad(
        F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
              mode="replicate").permute(0, 2, 3, 1), x, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------
# models/layers.py: the norm over a phase tensor, the ConvBlock modes
# ---------------------------------------------------------------------

def _randomize(tree, rng):
    """Non-trivial biases and norm affines, so every parameter matters."""
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * rng.randn(*v.shape).astype(np.float32),
        tree)


def _load_block(mod: tl.ConvBlock, tree) -> tl.ConvBlock:
    p = tree["params"]
    mod.load_state_dict({
        "conv.kernel": torch.from_numpy(p["Conv_0"]["kernel"]),
        "conv.bias": torch.from_numpy(p["Conv_0"]["bias"]),
        "norm.scale": torch.from_numpy(p["InstanceNorm_0"]["scale"]),
        "norm.bias": torch.from_numpy(p["InstanceNorm_0"]["bias"]),
    }, strict=True)
    return mod


def test_instance_norm_over_phases_matches_jax():
    rng = np.random.RandomState(7)
    x = (rng.randn(2, 5, 6, 4 * 8) * 3 + 1).astype(np.float32)
    ref_mod = jlayers.InstanceNorm(dtype=jnp.float32, phase=4)
    tree = _randomize(ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                      rng)
    mod = tl.InstanceNorm(8, dtype=torch.float32)
    mod.load_state_dict({k: torch.from_numpy(v)
                         for k, v in tree["params"].items()}, strict=True)
    out = mod(torch.from_numpy(x))
    _close(out, ref_mod.apply(tree, jnp.asarray(x)), atol=2e-5, rtol=0)
    # The statistics of the full-resolution map: the plain norm of d2s(x).
    _close(pc.depth_to_space2(out),
           mod(pc.depth_to_space2(torch.from_numpy(x))).detach().numpy(),
           atol=2e-5, rtol=0)


# mode: (JAX fields, port kernel and stride, input [h, w, c] of the call)
MODES = {
    "upsample2x": (dict(upsample2x=True), (3, 1), (5, 6, 12)),
    "upsample2x_emit": (dict(upsample2x=True, emit_phase=True), (3, 1),
                        (5, 6, 12)),
    "phase_stem": (dict(kernel=7, phase_stem=True), (7, 1), (10, 12, 15)),
    "from_phase": (dict(stride=2, from_phase=True), (3, 2), (5, 6, 4 * 6)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_conv_block_mode_matches_jax(mode):
    """Each phase mode of the port's ConvBlock against the JAX block of the
    same mode on converted parameters, and against the port's plain block on
    the full-resolution map."""
    fields, (kernel, stride), (h, w, c) = MODES[mode]
    rng = np.random.RandomState(len(mode))
    x = rng.randn(2, h, w, c).astype(np.float32)
    ref_mod = jlayers.ConvBlock(8, dtype=jnp.float32, **fields)
    tree = _randomize(ref_mod.init(jax.random.PRNGKey(1), jnp.asarray(x)),
                      rng)
    ref = ref_mod.apply(tree, jnp.asarray(x))
    cin = c // 4 if mode == "from_phase" else c
    mod = _load_block(tl.ConvBlock(cin, 8, kernel=kernel, stride=stride,
                                   dtype=torch.float32), tree)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if mode.startswith("upsample2x"):
            emit = mode.endswith("emit")
            out = mod.upsample2x(xt, emit_phase=emit)
            plain = mod(xt.repeat_interleave(2, 1).repeat_interleave(2, 2))
            if emit:
                plain = pc.space_to_depth2(plain)
        elif mode == "phase_stem":
            out = mod.phase_stem(xt)
            plain = pc.space_to_depth2(mod(xt))
        else:
            out = mod.from_phase(xt)
            plain = mod(pc.depth_to_space2(xt))
    _close(out, ref, atol=2e-5, rtol=0)
    _close(out, plain.numpy(), atol=2e-5, rtol=0)


def test_conv_block_modes_check_kernel_and_stride():
    with pytest.raises(ValueError, match="phase_stem requires kernel=7"):
        tl.ConvBlock(4, 8).phase_stem(torch.zeros(1, 4, 4, 4))
    with pytest.raises(ValueError, match="from_phase requires kernel=3"):
        tl.ConvBlock(4, 8).from_phase(torch.zeros(1, 4, 4, 16))
    with pytest.raises(ValueError, match="upsample2x requires kernel=3"):
        tl.ConvBlock(4, 8, stride=2).upsample2x(torch.zeros(1, 4, 4, 4))


# ---------------------------------------------------------------------
# the phase-form generator
# ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _generator_case(local: int):
    """(JAX kwargs, inputs, flax params) for a generator with ``local``
    enhancers; made once a module (the tests read it, none writes it)."""
    seed = 10 + local
    kw = dict(base_ch=BASE, n_blocks=BLOCKS, n_local_enhancers=local,
              n_local_blocks=2, dtype=jnp.float32)
    rng = np.random.RandomState(seed)
    labels = (rng.rand(2, H, W, 9) * 2 - 1).astype(np.float32)
    prev = (rng.rand(2, H, W, 6) * 2 - 1).astype(np.float32)
    has_prev = np.asarray([0.0, 1.0], np.float32)
    params = jax.jit(jgen.CompositeGenerator(**kw).init)(
        jax.random.PRNGKey(seed), jnp.asarray(labels), jnp.asarray(prev),
        jnp.asarray(has_prev))
    params = _randomize(params, rng)
    params["params"]["heads"]["kernel"] *= 0.03 if local else 0.1
    return kw, (labels, prev, has_prev), params


def _port(params, local: int, **kw) -> CompositeGenerator:
    gen = CompositeGenerator(15, base_ch=BASE, n_blocks=BLOCKS,
                             dtype=torch.float32, n_local_enhancers=local,
                             n_local_blocks=2, **kw)
    gen.load_state_dict(params_from_flax(params), strict=True)
    return gen.eval()


@pytest.mark.parametrize("local", [0, 1])
@pytest.mark.parametrize("fused", [False, True])
def test_phase_generator_matches_jax_and_plain(fused, local):
    """The port's default generator (the phase form) against the JAX phase
    form, and against the port's plain form on the same state dict."""
    kw, inputs, params = _generator_case(local)
    ref = jax.jit(jgen.CompositeGenerator(
        phase_form=True, fused_resblocks=fused, **kw).apply)(
            params, *map(jnp.asarray, inputs))
    gen = _port(params, local, fused_resblocks=fused)
    assert gen.phase_form
    plain = _port(params, local, fused_resblocks=fused, phase_form=False)
    args = list(map(torch.from_numpy, inputs))
    with torch.inference_mode():
        out, out_plain = gen(*args), plain(*args)
    for name, o, r, p in zip(("frame", "flow", "mask"), out, ref, out_plain):
        _close(o, r, atol=GEN_ATOL, rtol=0)
        _close(o, p.numpy(), atol=PLAIN_ATOL, rtol=PLAIN_ATOL)
    assert np.abs(np.asarray(ref[1])).max() > 0.5  # the warp is exercised


def _loss_weights(seed: int):
    """Weights of (frame, flow, mask) in the scalar loss. The frame of the
    row with a previous frame gets none: its gradient reaches the flow
    through the warp's bilinear weights, which jump where a sample crosses a
    pixel, so f32 noise between two lowerings moves it by percent (JAX's own
    phase and plain forms differ there by up to 9e-2 of the largest
    gradient)."""
    rng = np.random.RandomState(seed)
    frame, flow, mask = [rng.randn(2, H, W, c).astype(np.float32)
                         for c in (3, 2, 1)]
    frame[1] = 0.0  # has_prev is [0, 1]
    return frame, flow, mask


@pytest.mark.parametrize("local", [0, 1])
def test_phase_generator_gradients_match_jax(local):
    """Parameter gradients of one scalar loss through the phase form: the
    port's against ``jax.grad`` of the JAX phase form (f32), and against the
    port's plain form, each within GRAD_RTOL of the largest gradient of the
    network (a conv bias in front of an instance norm has a zero gradient,
    float noise in both packages)."""
    kw, inputs, params = _generator_case(local)
    weights = _loss_weights(30 + local)
    jmod = jgen.CompositeGenerator(phase_form=True, **kw)

    def loss(p):
        outs = jmod.apply(p, *map(jnp.asarray, inputs))
        return sum(jnp.sum(o * wt) for o, wt in zip(outs, weights))

    jgrads = params_from_flax(jax.jit(jax.grad(loss))(params))

    def port_grads(phase_form: bool):
        gen = _port(params, local, fused_resblocks=False,
                    phase_form=phase_form).train()
        outs = gen(*map(torch.from_numpy, inputs))
        sum((o * torch.from_numpy(wt)).sum()
            for o, wt in zip(outs, weights)).backward()
        return {n: p.grad for n, p in gen.named_parameters()}

    grads, plain = port_grads(True), port_grads(False)
    assert set(grads) == set(jgrads)
    scale = max(float(g.abs().max()) for g in jgrads.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(),
                                   atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), plain[name].numpy(),
                                   atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=name)
    assert float(grads["trunk.stem.conv.kernel"].abs().max()) > 0
    assert float(grads["heads.kernel"].abs().max()) > 0


def test_phase_generator_bf16_close():
    """bf16: the port's phase form stays within 3x the plain bf16 form's
    mean error against the f32 truth (+1e-3), the JAX package's own bound
    (tests/test_phase_conv.py), and within the same bound of JAX's bf16
    phase form's error: the folded up kernel rounds once."""
    kw, inputs, params = _generator_case(0)
    jin = list(map(jnp.asarray, inputs))
    truth = np.asarray(jax.jit(jgen.CompositeGenerator(**kw).apply)(
        params, *jin)[0])
    kw16 = dict(kw, dtype=jnp.bfloat16)
    jax16 = np.asarray(jax.jit(jgen.CompositeGenerator(**kw16).apply)(
        params, *jin)[0])
    args = list(map(torch.from_numpy, inputs))
    errs = {}
    for phase_form in (True, False):
        gen = CompositeGenerator(15, base_ch=BASE, n_blocks=BLOCKS,
                                 dtype=torch.bfloat16, phase_form=phase_form)
        gen.load_state_dict(params_from_flax(params), strict=True)
        with torch.inference_mode():
            frame = gen.eval()(*args)[0].float().numpy()
        errs[phase_form] = float(np.mean(np.abs(frame - truth)))
    e_jax = float(np.mean(np.abs(jax16 - truth)))
    assert errs[True] < 3.0 * errs[False] + 1e-3, errs
    assert errs[True] < 3.0 * e_jax + 1e-3, (errs, e_jax)


def test_state_dict_identical_across_forms():
    """Both forms hold the same names and shapes, so a checkpoint of either
    (every one written before the phase form) loads into the other."""
    for local in (0, 1):
        forms = [CompositeGenerator(15, base_ch=BASE, n_blocks=BLOCKS,
                                    n_local_enhancers=local, phase_form=p)
                 for p in (True, False)]
        forms[1].reset_parameters(torch.Generator().manual_seed(0))
        shapes = [{k: v.shape for k, v in g.state_dict().items()}
                  for g in forms]
        assert shapes[0] == shapes[1]
        forms[0].load_state_dict(forms[1].state_dict(), strict=True)


def test_phase_kernels_cached_per_parameter_version():
    """At inference a phase kernel is built once per parameter version (a
    ParamCopy beside ``_packed``), never once a call."""
    gen = CompositeGenerator(15, base_ch=BASE, n_blocks=1,
                             dtype=torch.float32)
    gen.reset_parameters(torch.Generator().manual_seed(1))
    args = [torch.zeros(1, 16, 16, 9), torch.zeros(1, 16, 16, 6),
            torch.ones(1)]
    convs = (gen.trunk.stem.conv, gen.trunk.down[0].conv,
             gen.trunk.up[0].block.conv, gen.heads)
    with torch.no_grad():
        gen(*args)
        first = [next(iter(c._phase.values())).value[0] for c in convs]
        gen(*args)
        assert all(next(iter(c._phase.values())).value[0] is k
                   for c, k in zip(convs, first))
        gen.load_state_dict(gen.state_dict())  # a new parameter version
        gen(*args)
    assert all(next(iter(c._phase.values())).value[0] is not k
               for c, k in zip(convs, first))
    assert all(len(c._phase) == 1 for c in convs)


def test_gathered_kernel_builds_phase_kernel():
    """A conv sharded over the model axis builds its phase kernel from the
    step's whole kernel (``GatheredKernel.use``), so the output is the
    unsharded conv's and the shard gets its slice of the gradient."""
    torch.manual_seed(0)
    whole = tl.ConvBlock(6, 8, dtype=torch.float32)
    whole.conv.reset_parameters(torch.Generator().manual_seed(2))
    part = tl.ConvBlock(6, 8, dtype=torch.float32)
    part.load_state_dict(whole.state_dict())
    full = whole.conv.kernel.detach().clone()
    part.conv.kernel = torch.nn.Parameter(full[..., 4:8].clone())
    part.conv.shard = (4, 8, 8)
    x = torch.randn(2, 5, 4, 6)
    with pytest.raises(RuntimeError, match="gathered_kernels"):
        part.upsample2x(x)
    part.conv.gathered = GatheredKernel(full, 4, 8)
    y, y_whole = part.upsample2x(x), whole.upsample2x(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  y_whole.detach().numpy())
    g = torch.randn_like(y)
    y.backward(g)
    y_whole.backward(g)
    np.testing.assert_array_equal(part.conv.kernel.grad.numpy(),
                                  whole.conv.kernel.grad[..., 4:8].numpy())
