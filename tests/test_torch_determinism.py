"""Repeatability on the CPU. Training: the train step runs in PyTorch's
deterministic mode, restores the caller's mode after it, and two
``train_gan`` runs from one seed give bit-equal losses, weights and Adam
moments; the reflect pad's ordered backward, which every differentiated pad
takes, equals autograd's through ``F.pad``. Batch rows: one sample's
generator output at batch 1 against the same sample inside a batch of 4, in
the JAX package and in the port: both agree to the f32 parity tolerance,
JAX's rows are not bit-equal to batch 1, and the port's part from it by no
more than a small factor of JAX's, so a row that depends on its batch size
is behaviour the two packages share, not a fault of the port."""

import numpy as np
import pytest
import torch

from text2video_tpu_torch.golden import write_training_assets
from text2video_tpu_torch.models import layers
from text2video_tpu_torch.train import loop
from text2video_tpu_torch.train import trainer as tt
from text2video_tpu_torch.train.data import PoseClipDataset

torch.set_num_threads(1)

CFG = tt.TrainConfig(height=32, width=32, face_crop=8, base_ch=8, n_blocks=1,
                     d_base_ch=8, dtype=torch.float32)


@pytest.mark.parametrize("shape,pad", [((2, 7, 9, 3), 1),
                                       ((1, 12, 10, 4), 3)])
def test_reflect_pad_backward_matches_autograd(shape, pad):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    g = torch.randn((shape[0], shape[1] + 2 * pad, shape[2] + 2 * pad,
                     shape[3]), dtype=torch.float64, generator=gen)
    want, = torch.autograd.grad(layers._reflect_pad(x, pad), x, g)
    with tt.deterministic_algorithms():
        y = layers.reflect_pad(x, pad)
        got, = torch.autograd.grad(y, x, g)
    assert type(y.grad_fn).__name__ == "_DeterministicReflectPadBackward"
    assert not torch.are_deterministic_algorithms_enabled()
    assert torch.utils.deterministic.fill_uninitialized_memory
    torch.testing.assert_close(got, want, atol=1e-12, rtol=0)


def _train_twice(assets, device_data: bool):
    """Two 2-step ``train_gan`` runs from seed 0: per run, the metrics each
    step returned and the final state."""
    runs = []
    make_step = loop.make_train_step

    for _ in range(2):
        metrics = []

        def recording_make(cfg):
            step = make_step(cfg)

            def recorded(state, batch):
                assert not torch.are_deterministic_algorithms_enabled()
                state, m = step(state, batch)
                assert not torch.are_deterministic_algorithms_enabled()
                metrics.append({k: float(v) for k, v in m.items()})
                return state, m

            return recorded

        loop.make_train_step = recording_make
        try:
            ds = PoseClipDataset(*assets, canvas=(32, 32),
                                 source_canvas=(512, 384), clip_len=4,
                                 device="cpu")
            state = loop.train_gan(ds, CFG, steps=2, batch_size=2, seed=0,
                                   device_data=device_data,
                                   log_fn=lambda s: None, device="cpu")
        finally:
            loop.make_train_step = make_step
        runs.append((metrics, state))
    return runs


@pytest.mark.parametrize("device_data", [False, True])
def test_train_gan_repeats_from_its_seed(tmp_path, device_data):
    assets = write_training_assets(str(tmp_path), n_frames=8,
                                   canvas=(64, 48))
    (m1, s1), (m2, s2) = _train_twice(assets, device_data)
    assert len(m1) == 2 and m1 == m2
    assert m1[0] != m1[1]  # the steps moved the weights
    for net in ("generator", "discriminators"):
        a = getattr(s1, net).state_dict()
        b = getattr(s2, net).state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), f"{net}.{k}"
    for opt in ("g_opt", "d_opt"):
        a = getattr(s1, opt).state_dict()["state"]
        b = getattr(s2, opt).state_dict()["state"]
        for i in a:
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(a[i][k], b[i][k]), f"{opt} {i} {k}"


def _batch_vs_single(apply, labels, prev, has_prev):
    """The largest |difference| of each output between row i of a batch of 4
    and the same sample alone, over the rows."""
    batched = [np.asarray(o, np.float64) for o in apply(labels, prev,
                                                        has_prev)]
    worst = np.zeros(3)
    for i in range(4):
        one = apply(labels[i:i + 1], prev[i:i + 1], has_prev[i:i + 1])
        worst = np.maximum(worst, [
            np.abs(b[i] - np.asarray(o, np.float64)[0]).max()
            for b, o in zip(batched, one)])
    return worst


def test_a_batch_row_against_batch_1_like_jax():
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.generator import CompositeGenerator as JaxGen

    from text2video_tpu_torch.convert import params_from_flax
    from text2video_tpu_torch.models.generator import CompositeGenerator

    h, w, base, blocks = 32, 48, 8, 2
    jgen = JaxGen(base_ch=base, n_blocks=blocks, dtype=jnp.float32)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 9)),
                                jnp.zeros((1, h, w, 6)), jnp.ones((1,)))
    # A tenth of the heads kernel: flows of a few pixels, as in the
    # generator parity test.
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["heads"]["kernel"] = (
        params["params"]["heads"]["kernel"] * 0.1)
    rng = np.random.RandomState(1)
    labels = (rng.rand(4, h, w, 9) * 2 - 1).astype(np.float32)
    prev = (rng.rand(4, h, w, 6) * 2 - 1).astype(np.float32)
    has_prev = np.ones(4, np.float32)

    jax_worst = _batch_vs_single(jax.jit(lambda *a: jgen.apply(params, *a)),
                                 labels, prev, has_prev)
    port = CompositeGenerator(15, base_ch=base, n_blocks=blocks,
                              dtype=torch.float32)
    port.load_state_dict(params_from_flax(params), strict=True)
    port.eval()

    def apply(*arrays):
        with torch.inference_mode():
            return [o.numpy() for o in port(*map(torch.from_numpy, arrays))]

    port_worst = _batch_vs_single(apply, labels, prev, has_prev)
    # Frame, flow and mask: a row of a batch agrees with batch 1 to the f32
    # parity tolerance of the generator, in both packages alike.
    assert np.all(jax_worst <= 1e-4), jax_worst
    assert np.all(port_worst <= 1e-4), port_worst
    # The decision rests on these: JAX's rows are not bit-equal to batch 1
    # either, and the port's depart from batch 1 by about as much as JAX's
    # (x86, one thread: 4.0e-6, 4.6e-6, 1.2e-7 against 4.5e-6, 6.2e-6,
    # 1.8e-7). A port whose rows part further than JAX's fails here.
    assert np.all(jax_worst > 0), jax_worst
    assert np.all(port_worst <= 4 * jax_worst), (port_worst, jax_worst)
