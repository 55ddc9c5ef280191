"""The port's train step against the JAX train step: from one JAX
``TrainerState`` carried over by ``convert.trainer_state_from_flax``, the same
batch gives the same losses, the same G and D gradients and the same Adam
update, for each variant of the configuration. f32, tiny sizes, each JAX step jitted
once. Four more variants are in ``test_torch_train_variants.py``; the port's
counterparts of the structural tests of ``tests/test_train_step.py`` are in
``test_torch_train_structure.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_train_parity import (
    CFG,
    KINK_MARGIN,
    _batch,
    _check_params,
    _jax_state_and_step,
    _to_np,
    _torch_batch,
    check_variant,
    photometric_margin,
)
from text2video_tpu_torch.convert import (
    params_from_flax,
    trainer_state_from_flax,
)
from text2video_tpu_torch.train import trainer as tt

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["default", "recon_pretrain",
                                     "grad_accum"])
def test_train_step_matches_jax(variant):
    check_variant(variant)


def test_converted_state_takes_a_second_step_like_jax():
    """Adam's moments and count come over too: from the JAX state *after* a
    step, the port's next step moves the parameters as the JAX step does."""
    s0, step = _jax_state_and_step({}, seed=1)
    # Seed 0's batch put an element of the flow loss 6.0e-6 from its kink.
    batch = _batch(seed=3)
    s1, _ = step(s0, batch)
    s2, m2 = step(s1, batch)
    to_np = _to_np
    assert photometric_margin(to_np(s1), batch) > KINK_MARGIN
    state = trainer_state_from_flax(to_np(s1), CFG, device="cpu")
    assert state.step == 1
    state, metrics = tt.make_train_step(CFG)(state, _torch_batch(batch))
    assert state.step == 2
    for k, v in m2.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=2e-4,
                                   atol=1e-5, err_msg=k)
    ref = params_from_flax(to_np(s2.g_params))
    _check_params(state.generator.named_parameters(), ref, CFG.lr, "G")
    # With both moments live the update is smooth in the gradient, so every
    # kernel element lands close (a bias in front of a norm has a zero
    # gradient, and Adam turns its float noise into a step of size lr).
    for name, p in state.generator.named_parameters():
        if name.endswith("kernel"):
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       atol=0.05 * CFG.lr, rtol=0,
                                       err_msg=name)
    nu = params_from_flax(to_np(s2.g_opt[0].nu))
    for name, p in state.generator.named_parameters():
        np.testing.assert_allclose(
            state.g_opt.state[p]["exp_avg_sq"].numpy(), nu[name].numpy(),
            rtol=1e-3, atol=1e-12, err_msg=name)
        assert float(state.g_opt.state[p]["step"]) == 2


def test_temporal_stack_matches_jax():
    import jax.numpy as jnp

    from text2video_tpu.train.trainer import _temporal_stack as jax_stack

    x = np.random.RandomState(0).randn(2, 7, 4, 5, 3).astype(np.float32)
    for window, stride in ((3, 1), (3, 2), (2, 3)):
        ref = np.asarray(jax_stack(jnp.asarray(x), window, stride))
        out = tt._temporal_stack(torch.from_numpy(x), window, stride)
        np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match="too short"):
        tt._temporal_stack(torch.from_numpy(x), 3, 4)


def test_config_fields_and_defaults_match_jax():
    import jax.numpy as jnp

    from text2video_tpu.train.trainer import TrainConfig as JaxConfig

    ours = dataclasses.asdict(tt.TrainConfig())
    theirs = dataclasses.asdict(JaxConfig())
    assert list(ours) == list(theirs)
    assert ours.pop("dtype") == torch.bfloat16
    assert theirs.pop("dtype") == jnp.bfloat16
    assert ours == theirs
