"""The port's counterparts of the structural tests of
``tests/test_train_step.py``: what a train step must and must not touch.
f32, tiny sizes, the port alone (``test_torch_train.py`` holds it against the
JAX step)."""

import dataclasses

import numpy as np
import pytest
import torch

from text2video_tpu_torch.train import trainer as tt

torch.set_num_threads(1)

CFG = tt.TrainConfig(height=32, width=32, face_crop=8, base_ch=8, n_blocks=1,
                     d_base_ch=8, use_vgg=False, dtype=torch.float32)


def _batch(b=2, t=4):
    rng = np.random.RandomState(0)
    return {
        "labels": rng.rand(b, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "reals": rng.rand(b, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "face_centers": np.full((b, t, 2), 16.0, np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}



def _fresh(cfg, seed=0):
    return tt.create_trainer_state(cfg, seed=seed, device="cpu")


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _moved(module, before):
    return sum(float((p.detach() - before[k]).abs().sum())
               for k, p in module.named_parameters())


def test_train_step_updates_params_and_losses_finite():
    state = _fresh(CFG)
    g0, d0 = _snapshot(state.generator), _snapshot(state.discriminators)
    step = tt.make_train_step(CFG)
    batch = _torch_batch(_batch())
    state, metrics = step(state, batch)
    assert state.step == 1
    for k, v in metrics.items():
        assert v.ndim == 0 and np.isfinite(float(v)), (k, float(v))
    assert _moved(state.generator, g0) > 0
    assert _moved(state.discriminators, d0) > 0
    state, _ = step(state, batch)
    assert state.step == 2


def test_recon_pretrain_mode_skips_discriminators():
    cfg = dataclasses.replace(CFG, lambda_adv=0.0, lambda_l1=10.0,
                              lambda_flow=0.0)
    state = _fresh(cfg)
    d0 = _snapshot(state.discriminators)
    # No discriminator may even be applied.
    calls = []
    hooks = [d.register_forward_hook(lambda *a: calls.append(1))
             for d in state.discriminators.values()]
    step = tt.make_train_step(cfg)
    batch = _batch()
    batch["reals"] = np.full_like(batch["reals"], 0.5)  # a learnable target
    batch = _torch_batch(batch)
    first = None
    for _ in range(10):
        state, m = step(state, batch)
        first = float(m["g_loss"]) if first is None else first
    for h in hooks:
        h.remove()
    assert not calls
    assert float(m["g_adv"]) == 0.0 and float(m["g_fm"]) == 0.0
    assert float(m["d_loss"]) == 0.0
    assert _moved(state.discriminators, d0) == 0.0
    assert float(m["g_loss"]) < first


def test_autoregressive_carry_is_detached():
    """The same step with ``bptt=True`` gives a strictly larger gradient
    second moment than the detached default, whose gradients stay O(1)."""
    rng = np.random.RandomState(1)
    t = 6
    batch = _torch_batch({
        "labels": rng.rand(1, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "reals": rng.rand(1, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "face_centers": np.full((1, t, 2), 16.0, np.float32),
    })

    def max_nu(bptt):
        cfg = dataclasses.replace(CFG, n_blocks=2, lambda_adv=0.0,
                                  lambda_l1=10.0, bptt=bptt)
        state, _ = tt.make_train_step(cfg)(_fresh(cfg), batch)
        return max(float(s["exp_avg_sq"].abs().max())
                   for s in state.g_opt.state.values())

    detached, full = max_nu(False), max_nu(True)
    assert detached < full, (detached, full)
    assert (detached / 1e-3) ** 0.5 < 1e2, detached


def test_d_gradients_live_on_fakes():
    """D's update must depend on the generator's output: only the fake
    branch of its loss does."""
    cfg = dataclasses.replace(CFG, face_crop=16, base_ch=4, d_base_ch=4,
                              temporal_strides=(1,))
    rng = np.random.RandomState(0)
    t = cfg.temporal_window + 1
    batch = _torch_batch({
        "labels": rng.randn(1, t, 32, 32, 3).astype(np.float32),
        "reals": rng.randn(1, t, 32, 32, 3).astype(np.float32),
        "face_centers": np.full((1, t, 2), 16.0, np.float32),
    })
    step = tt.make_train_step(cfg)
    s1, _ = step(_fresh(cfg), batch)
    s2 = _fresh(cfg)
    with torch.no_grad():
        for p in s2.generator.parameters():
            p.mul_(1.5)
    s2, _ = step(s2, batch)
    delta = sum(float((a - b).detach().abs().sum()) for a, b in zip(
        s1.discriminators.parameters(), s2.discriminators.parameters()))
    assert delta > 1e-6


def test_g_loss_leaves_no_gradient_on_d():
    """G's loss runs through the discriminators, but its gradient is taken
    for G's parameters only: D's ``.grad`` after a step is that of D's own
    loss, which does not know the weights of G's adversarial terms."""
    batch = _torch_batch(_batch())

    def d_grads(**weights):
        cfg = dataclasses.replace(CFG, **weights)
        state, _ = tt.make_train_step(cfg)(
            tt.create_trainer_state(cfg, seed=0, device="cpu"), batch)
        return [p.grad for p in state.discriminators.parameters()]

    a = d_grads()
    b = d_grads(lambda_adv=7.0, lambda_fm=3.0, lambda_face=5.0)
    # (the stride-2 temporal D sees no 4-frame clip: its gradient is zero)
    assert sum(float(g.abs().sum() > 0) for g in a) > len(a) // 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_grad_accum_matches_full_batch():
    batch = _torch_batch(_batch(b=2))
    s_full, m_full = tt.make_train_step(CFG)(_fresh(CFG), batch)
    cfg2 = dataclasses.replace(CFG, grad_accum=2)
    s_acc, m_acc = tt.make_train_step(cfg2)(_fresh(cfg2), batch)
    for k in m_full:
        np.testing.assert_allclose(float(m_full[k]), float(m_acc[k]),
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    # At step 1 Adam moves each element by about lr * sign(grad), so float
    # noise on a near-zero gradient can flip a sign: no element more than
    # one flip apart, and almost all equal.
    diffs = torch.cat([(p - q).detach().abs().ravel() for p, q in zip(
        s_full.generator.parameters(), s_acc.generator.parameters())])
    assert float(diffs.max()) <= 2.5 * CFG.lr
    assert float((diffs > 1e-5).float().mean()) < 0.06
    with pytest.raises(ValueError, match="not divisible"):
        tt.make_train_step(dataclasses.replace(CFG, grad_accum=3))(
            _fresh(CFG), batch)


def test_remat_gives_the_same_gradients():
    batch = _torch_batch(_batch())
    cfg = dataclasses.replace(CFG, use_vgg=True, remat=False)
    a, ma = tt.make_train_step(cfg)(_fresh(cfg), batch)
    cfg_r = dataclasses.replace(cfg, remat=True)
    b, mb = tt.make_train_step(cfg_r)(_fresh(cfg_r), batch)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for p, q in zip(a.generator.parameters(), b.generator.parameters()):
        assert torch.equal(p.grad, q.grad)


def test_safe_grad_accum_keeps_the_request():
    """No shape forces accumulation on the card: the requested factor comes
    back unchanged, at least 1 (the JAX package's 896x512 frontier was its
    TPU backend's)."""
    big = tt.TrainConfig(height=512, width=896)
    assert tt.safe_grad_accum(tt.TrainConfig(), 8, 12) == 1
    assert tt.safe_grad_accum(big, 4, 8) == 1
    assert tt.safe_grad_accum(dataclasses.replace(big, grad_accum=4), 4,
                              8) == 4
    assert tt.safe_grad_accum(dataclasses.replace(big, grad_accum=0), 4,
                              8) == 1


def test_mouth_l1_anchor_active_and_lowers_mouth_error():
    cfg = dataclasses.replace(CFG, lambda_adv=0.0, lambda_l1=0.0,
                              lambda_flow=0.0, lambda_l1_mouth=10.0)
    state, step = _fresh(cfg), tt.make_train_step(cfg)
    batch = _torch_batch(_batch())
    m0 = None
    for _ in range(6):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["g_mouth_l1"]))
        m0 = float(metrics["g_mouth_l1"]) if m0 is None else m0
    assert float(metrics["g_mouth_l1"]) < m0
    _, metrics0 = tt.make_train_step(CFG)(_fresh(CFG), batch)
    assert float(metrics0["g_mouth_l1"]) == 0.0
