"""Checkpoints of the JAX package into the port's format:
``convert.migrate_generator_params`` against the JAX function, and
``tools/orbax_to_torch.py`` on a tiny random ``TrainerState`` that the JAX
package's own ``save_state`` wrote with Orbax."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from text2video_tpu_torch import checkpoints as ckpt
from text2video_tpu_torch import config as tconfig
from text2video_tpu_torch import convert
from text2video_tpu_torch.golden import write_training_assets
from text2video_tpu_torch.train import trainer as tt
from text2video_tpu_torch.train.data import PoseClipDataset
from text2video_tpu_torch.train.loop import train_gan

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(height=32, width=32, face_crop=8, base_ch=8, n_blocks=1,
            d_base_ch=8, use_vgg=False, lambda_l1_mouth=2.0)
STEP, ADAM_COUNT = 7, 3


def _bridge():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(ROOT, "tools", "orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _head(rng, out_ch):
    return {"kernel": rng.rand(7, 7, 64, out_ch).astype(np.float32),
            "bias": rng.rand(out_ch).astype(np.float32)}


def _legacy_tree(rng):
    return {"params": {
        "GlobalTrunk_0": {"ConvBlock_0": {"Conv_0": {
            "kernel": np.zeros((7, 7, 15, 64))}}},
        "img_head": _head(rng, 3), "flow_head": _head(rng, 2),
        "mask_head": _head(rng, 1)}}


def _assert_trees_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wrapped", [True, False])
def test_migrate_head_merge_matches_jax(wrapped):
    """Separate heads merge by exact concatenation, as the JAX function's."""
    from text2video_tpu.train.checkpoints import migrate_generator_params

    old = _legacy_tree(np.random.RandomState(0))
    if not wrapped:
        old = old["params"]
    new = convert.migrate_generator_params(old)
    _assert_trees_equal(new, migrate_generator_params(old))
    p = new["params"] if wrapped else new
    assert "img_head" not in p and p["heads"]["kernel"].shape == (7, 7, 64, 6)
    src = old["params"] if wrapped else old
    np.testing.assert_array_equal(p["heads"]["kernel"][..., 3:5],
                                  src["flow_head"]["kernel"])
    assert "img_head" in src  # the input tree is left as it was


def test_migrate_passes_a_merged_tree_through():
    from text2video_tpu.train.checkpoints import migrate_generator_params

    tree = {"params": {"heads": {"kernel": np.zeros((7, 7, 64, 6))}}}
    assert convert.migrate_generator_params(tree) is tree
    assert migrate_generator_params(tree) is tree


def test_migrate_rejects_the_two_branch_encoder_as_jax_does():
    from text2video_tpu.train.checkpoints import migrate_generator_params

    old = {"params": {
        "GlobalTrunk_0": {
            "ConvBlock_0": {"Conv_0": {"kernel": np.zeros((7, 7, 9, 64))}},
            "ConvBlock_1": {"Conv_0": {"kernel": np.zeros((7, 7, 6, 64))}}},
        "img_head": {"kernel": np.zeros((7, 7, 64, 3)), "bias": np.zeros(3)}}}
    with pytest.raises(ValueError, match="two-branch") as ours:
        convert.migrate_generator_params(old)
    with pytest.raises(ValueError, match="two-branch") as ref:
        migrate_generator_params(old)
    assert str(ours.value) == str(ref.value)


@pytest.fixture(scope="module")
def jax_state():
    """A tiny JAX ``TrainerState`` with random parameters, random Adam
    moments, a step and Adam counts that are not zero, leaves as numpy."""
    import jax
    import jax.numpy as jnp

    from text2video_tpu.train import trainer as jt

    cfg = jt.TrainConfig(**BASE, dtype=jnp.float32)
    # Jitted, and as tools/orbax_to_torch.py builds its template, so the
    # two share one compile.
    state = jax.jit(jt.create_trainer_state, static_argnums=(0, 1))(cfg, 0)
    rng = np.random.RandomState(4)

    def moment(x):
        x = np.asarray(x)
        if x.dtype == np.float32:
            return np.abs(rng.randn(*x.shape)).astype(np.float32) * 1e-2
        return np.asarray(ADAM_COUNT, x.dtype)  # Adam's count

    g = jax.tree_util.tree_map(np.array, state.g_params)
    # Flows of a few pixels, as a trained model's (lecun heads give ~30 px,
    # which f32 resolves to ~1e-4 only).
    g["params"]["heads"]["kernel"] *= 0.1
    state = state.replace(
        step=jnp.asarray(STEP, jnp.int32), g_params=g,
        g_opt=jax.tree_util.tree_map(moment, state.g_opt),
        d_opt=jax.tree_util.tree_map(moment, state.d_opt))
    return cfg, jax.tree_util.tree_map(np.asarray, state)


@pytest.fixture(scope="module")
def converted(jax_state, tmp_path_factory):
    """(the Orbax directory, the port's directory the bridge made of it)."""
    from text2video_tpu.train.checkpoints import save_state

    cfg, state = jax_state
    root = tmp_path_factory.mktemp("bridge")
    src, dst = str(root / "orbax"), str(root / "torch")
    save_state(src, state, cfg)
    assert _bridge().main(["--src", src, "--dst", dst]) == 0
    return src, dst


def _port_cfg():
    return tt.TrainConfig(**BASE, dtype=torch.float32)


def test_bridge_state_restores_in_the_port(jax_state, converted):
    """Parameters, both Adam states (moments and counts) and the step come
    across, bit for bit."""
    _, state = jax_state
    _, dst = converted
    meta = ckpt.load_config(dst)
    assert meta["dtype"] == "torch.float32" and meta["base_ch"] == 8
    assert meta["lambda_l1_mouth"] == 2.0 and meta["use_vgg"] is False
    assert meta["temporal_strides"] == [1, 2]
    assert os.path.isfile(os.path.join(dst, f"step_{STEP:08d}", "state.pt"))

    out = ckpt.restore_state(
        dst, tt.create_trainer_state(_port_cfg(), seed=9, device="cpu"))
    assert out.step == STEP

    def discs(tree):
        return {f"{key}.{k}": v for key, t in tree.items()
                for k, v in convert.discriminator_from_flax(t).items()}

    for module, opt, params, adam, conv in (
            (out.generator, out.g_opt, state.g_params, state.g_opt[0],
             convert.params_from_flax),
            (out.discriminators, out.d_opt, state.d_params, state.d_opt[0],
             discs)):
        ref, mu, nu = conv(params), conv(adam.mu), conv(adam.nu)
        named = dict(module.named_parameters())
        assert named.keys() == ref.keys()
        assert set(discs(state.d_params)) >= {
            "image.scale0.logits.kernel", "temporal2.scale0.logits.kernel"}
        for name, p in named.items():
            assert torch.equal(p.detach(), ref[name]), name
            s = opt.state[p]
            assert float(s["step"]) == ADAM_COUNT
            assert torch.equal(s["exp_avg"], mu[name]), name
            assert torch.equal(s["exp_avg_sq"], nu[name]), name
    assert out.vgg is None


def test_bridge_generator_forward_matches_jax(jax_state, converted):
    """The converted generator's f32 forward against the JAX generator's on
    the saved parameters, at the generator parity tests' tolerance (1e-4)."""
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.generator import CompositeGenerator as JaxGen

    _, state = jax_state
    _, dst = converted
    rng = np.random.RandomState(1)
    labels = (rng.rand(2, 32, 32, 9) * 2 - 1).astype(np.float32)
    prev = (rng.rand(2, 32, 32, 6) * 2 - 1).astype(np.float32)
    has_prev = np.asarray([0.0, 1.0], np.float32)
    jgen = JaxGen(base_ch=8, n_blocks=1, dtype=jnp.float32)
    ref = [np.asarray(a) for a in jax.jit(jgen.apply)(
        state.g_params, jnp.asarray(labels), jnp.asarray(prev),
        jnp.asarray(has_prev))]
    out = ckpt.restore_state(
        dst, tt.create_trainer_state(_port_cfg(), seed=9, device="cpu"))
    with torch.inference_mode():
        got = out.generator.eval()(*map(torch.from_numpy,
                                        (labels, prev, has_prev)))
    for name, o, r in zip(("frame", "flow", "mask"), got, ref):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-4, rtol=0,
                                   err_msg=name)
    assert ref[0].std() > 0.01


def test_load_renderer_and_train_gan_accept_the_converted_directory(
        jax_state, converted, tmp_path):
    _, state = jax_state
    _, dst = converted
    r = ckpt.load_renderer(dst, tconfig.get_profile("fadg0"), device="cpu")
    assert r.config.load_size == 32 and r.generator.dtype == torch.bfloat16
    ref = convert.params_from_flax(state.g_params)
    assert all(torch.equal(v, ref[k])
               for k, v in r.generator.state_dict().items())
    r.time_bucket = 4
    frames = r.render(np.random.RandomState(0).randint(
        0, 256, (3, 32, 32, 3)).astype(np.uint8))
    assert frames.shape == (3, 32, 32, 3) and frames.std() > 0

    assets = write_training_assets(str(tmp_path / "train"), n_frames=8,
                                   canvas=(32, 32))
    ds = PoseClipDataset(*assets, canvas=(32, 32), source_canvas=(512, 384),
                         clip_len=4, device="cpu")
    log = []
    resumed = train_gan(ds, _port_cfg(), steps=1, batch_size=1, ckpt_dir=dst,
                        log_every=1, log_fn=log.append, device="cpu")
    assert f"resumed from step {STEP}" in log
    assert resumed.step == STEP + 1
    assert "nan" not in " ".join(log) and any("g_loss=" in ln for ln in log)
    # The resumed step continued Adam's count.
    s = next(iter(resumed.g_opt.state.values()))
    assert float(s["step"]) == ADAM_COUNT + 1


def test_bridge_generator_only_and_legacy_tree(jax_state, converted, tmp_path,
                                               capsys):
    """``--generator-only`` writes a renderer checkpoint that
    ``load_renderer`` accepts; a tree with separate heads converts in one
    call of ``params_from_flax``."""
    _, state = jax_state
    src, _ = converted
    dst = str(tmp_path / "renderer")
    capsys.readouterr()
    assert _bridge().main(["--src", src, "--dst", dst,
                           "--generator-only"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "dst": dst, "kind": "renderer"}
    assert sorted(os.listdir(dst)) == ["config.json", "generator.pt"]
    assert ckpt.load_config(dst) == {"base_ch": 8, "n_blocks": 1,
                                     "height": 32}
    r = ckpt.load_renderer(dst, tconfig.get_profile("fadg0"), device="cpu")
    ref = convert.params_from_flax(state.g_params)
    assert all(torch.equal(v, ref[k])
               for k, v in r.generator.state_dict().items())

    p = dict(state.g_params["params"])
    heads = p.pop("heads")
    for name, lo, hi in (("img_head", 0, 3), ("flow_head", 3, 5),
                         ("mask_head", 5, 6)):
        p[name] = {"kernel": heads["kernel"][..., lo:hi],
                   "bias": heads["bias"][lo:hi]}
    legacy = convert.params_from_flax({"params": p})
    assert legacy.keys() == ref.keys()
    assert all(torch.equal(legacy[k], ref[k]) for k in ref)
