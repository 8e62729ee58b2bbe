"""The port's WGAN-GP Trainer against the JAX package's, over a trajectory.

Ten consecutive steps of both trainers on the same numpy batches, from the
same weights (moved over the bridge, ``tools/from_jax.py``) and the same
interpolation weights: the real SRADSGAN generator blocks at a small width
(MSB stem, one ResGroup with one RAB, CGAM + SGAM with both gains 0.5, the
shared upsample), a six-block CBAM patch discriminator, and the VGG19
content term.  This holds the port's gradients through every kernel op
(pool, gate and attention, the gate's and the pool's grad-of-grad inside
the gradient penalty), its Adam, the lambda + 1 penalty weight and the
weight clip to the JAX step, on the pattern of
``tests/test_torch_parity.py:519-653``.  The port runs four train-mode D
forwards where the JAX step replays one BatchNorm update in closed form, so
the running statistics compare at a tolerance.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.core.config import config_for_model as jax_config  # noqa
from sradsgan_tpu.models import ModelSpec as JaxSpec  # noqa: E402
from sradsgan_tpu.models import register as jax_register  # noqa: E402
from sradsgan_tpu.models.discriminators import (  # noqa: E402
    PatchDiscriminator as JaxD)
from sradsgan_tpu.models.sradsgan import (  # noqa: E402
    SRADSGANGenerator as JaxG)
from sradsgan_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from sradsgan_tpu_torch import models  # noqa: E402
from sradsgan_tpu_torch.losses import gan as gan_losses  # noqa: E402
from sradsgan_tpu_torch.models.discriminators import (  # noqa: E402
    PatchDiscriminator)
from sradsgan_tpu_torch.models.sradsgan import SRADSGANGenerator  # noqa
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    discriminator_state_dict, sradsgan_state_dict, vgg19_state_dict)
from sradsgan_tpu_torch.train.state import get_lr, set_lr  # noqa: E402
from sradsgan_tpu_torch.train.trainer import Trainer  # noqa: E402

D_BLOCKS = ((4, 1, False), (4, 2, True), (8, 1, True), (8, 2, True),
            (8, 1, True), (8, 1, True))
NAME = "tinysrads_port"
BATCH = 4


def _config(tmp_path):
    jax_register(JaxSpec(
        NAME, JaxG, adversarial=True, gan_type="wgan-gp",
        discriminator=lambda **kw: JaxD(blocks=D_BLOCKS, use_attention=True,
                                        **kw),
        pixel_loss="l1", weight_content=1e-2, weight_gan=1e-3))
    models.register(models.ModelSpec(
        NAME, SRADSGANGenerator, adversarial=True, gan_type="wgan-gp",
        discriminator=lambda **kw: PatchDiscriminator(blocks=D_BLOCKS, **kw),
        pixel_loss="l1", weight_content=1e-2, weight_gan=1e-3))
    cfg = jax_config(NAME, 2)
    cfg.bf16 = False
    cfg.data.synthetic = True
    cfg.data.crop_size = 16
    cfg.data.batch_size = BATCH
    cfg.model_kwargs = dict(base_filters=16, n_groups=1, n_blocks=1)
    cfg.save_dir = str(tmp_path)
    port_cfg = models.config_for_model(NAME, 2, bf16=False,
                                       model_kwargs=cfg.model_kwargs,
                                       save_dir=cfg.save_dir)
    return cfg, port_cfg


def _gains(params, value):
    ga = dict(params["GlobalAttention_0"])
    for name in ("ChannelSelfAttention_0", "SpatialSelfAttention_0"):
        ga[name] = dict(ga[name], gamma=np.full((1,), value, np.float32))
    return dict(params, GlobalAttention_0=ga)


def test_ten_steps_match_the_jax_trainer(monkeypatch, tmp_path):
    cfg, port_cfg = _config(tmp_path)
    jt = JaxTrainer(cfg)
    g_params = _gains(jax.tree.map(np.asarray, jt.state.g_params), 0.5)
    jt.state = jt.state.replace(
        g_params=jax.tree.map(jnp.asarray, g_params),
        g_opt=jt.g_opt_tx.init(jax.tree.map(jnp.asarray, g_params)))
    d_vars = {"params": jax.tree.map(np.asarray, jt.state.d_params),
              "batch_stats": jax.tree.map(np.asarray, jt.state.d_stats)}

    pt = Trainer(port_cfg, device="cpu")
    pt.generator.load_state_dict(sradsgan_state_dict(g_params))
    pt.discriminator.load_state_dict(discriminator_state_dict(d_vars,
                                                              D_BLOCKS))
    pt.vgg.load_state_dict(vgg19_state_dict(
        jax.tree.map(np.asarray, jt.vgg_params)))

    data = np.random.default_rng(11)
    alpha = data.random((BATCH, 1, 1, 1)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(alpha))
    monkeypatch.setattr(gan_losses, "interpolation_weights",
                        lambda b, g, device: torch.from_numpy(alpha))
    for step in range(10):
        batch = {"lr": data.random((BATCH, 8, 8, 3)).astype(np.float32),
                 "hr": data.random((BATCH, 16, 16, 3)).astype(np.float32)}
        jt.state, want = jt._jit_step(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(step))
        got = pt.train_step(batch)
        for key in ("loss_G", "loss_D", "pixel", "content", "adv_g"):
            assert float(got[key]) == pytest.approx(
                float(want[key]), rel=5e-4, abs=1e-4), (step, key)
    assert pt.step == 10

    g_want = sradsgan_state_dict(jax.tree.map(np.asarray, jt.state.g_params))
    d_want = discriminator_state_dict(
        {"params": jax.tree.map(np.asarray, jt.state.d_params),
         "batch_stats": jax.tree.map(np.asarray, jt.state.d_stats)},
        D_BLOCKS)
    g_got = pt.generator.state_dict()
    d_got = pt.discriminator.state_dict()
    checks = {  # the kernels' parameters, and a plain conv of each net
        "RAB SLAM kernel": (g_got, g_want,
                            "res_groups.0.RG.0.sa.conv1.weight"),
        "RAB CLAM fc1": (g_got, g_want, "res_groups.0.RG.0.ca.fc1.weight"),
        "RAB CLAM fc2": (g_got, g_want, "res_groups.0.RG.0.ca.fc2.weight"),
        "group SLAM kernel": (g_got, g_want,
                              "res_groups.0.sa.conv1.weight"),
        "SGAM q": (g_got, g_want, "GAB_UP.sa.query_conv.weight"),
        "SGAM v": (g_got, g_want, "GAB_UP.sa.value_conv.weight"),
        "SGAM gamma": (g_got, g_want, "GAB_UP.sa.gamma"),
        "CGAM gamma": (g_got, g_want, "GAB_UP.ca.gamma"),
        "upsample conv": (g_got, g_want, "GAB_UP.upsampling.0.weight"),
        "D SLAM kernel (grad-of-grad path)": (d_got, d_want,
                                              "model.18.conv1.weight"),
        "D CLAM fc1 (grad-of-grad path)": (d_got, d_want,
                                           "model.17.fc1.weight"),
        "D conv1": (d_got, d_want, "model.0.weight"),
        "D BN scale": (d_got, d_want, "model.3.weight"),
    }
    for label, (got, want, key) in checks.items():
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=label)
    # the SGAM and the D's gate moved: their gradients were not zero
    assert not np.allclose(g_want["GAB_UP.sa.gamma"].numpy(), 0.5)
    assert np.abs(pt.discriminator.model[18].conv1.weight.grad.numpy()
                  ).max() > 0
    # running statistics: 40 BatchNorm updates, here and in the JAX replay
    for key, value in d_got.items():
        if key.endswith("running_mean"):
            np.testing.assert_allclose(value.numpy(), d_want[key].numpy(),
                                       atol=3e-3, err_msg=key)
        elif key.endswith("running_var"):
            np.testing.assert_allclose(value.numpy(), d_want[key].numpy(),
                                       rtol=5e-3, err_msg=key)


def test_config_for_model_fills_the_sradsgan_recipe():
    cfg = models.config_for_model("sradsgan", 4, **{"gan.lambda_gp": 5.0,
                                                   "bf16": False})
    assert (cfg.model, cfg.scale, cfg.bf16) == ("sradsgan", 4, False)
    assert cfg.gan.gan_type == "wgan-gp" and cfg.gan.lambda_gp == 5.0
    assert (cfg.gan.weight_content, cfg.gan.weight_gan) == (1e-2, 1e-3)
    assert models.get_spec("sradsgan").pixel_loss == "l1"
    with pytest.raises(AttributeError, match="unknown config field"):
        models.config_for_model("sradsgan", 4, **{"gan.nope": 1})
    with pytest.raises(KeyError, match="unknown model 'nope'"):
        models.config_for_model("nope", 4)
    hat = models.config_for_model("hat", 4)
    assert (hat.gan.weight_pixel, hat.gan.weight_content, hat.gan.weight_gan,
            hat.optim.lr) == (1.0, 0.0, 0.0, 2e-4)
    spec = models.get_spec("hat")
    assert (spec.adversarial, spec.pixel_loss) == (False, "l1")


def _fields(cfg):
    """{dotted field name: value} of a config, nested dataclasses flat."""
    out = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            out.update({f"{f.name}.{k}": v for k, v in _fields(value).items()})
        else:
            out[f.name] = value
    return out


@pytest.mark.parametrize("scale", [2, 4])
def test_port_config_matches_the_jax_train_config(scale):
    """Every field of the port's config exists in the JAX TrainConfig, with
    the same value from each package's config_for_model."""
    port = _fields(models.config_for_model("sradsgan", scale))
    want = _fields(jax_config("sradsgan", scale))
    assert set(port) <= set(want), set(port) - set(want)
    assert port == {k: want[k] for k in port}
    assert (models.config_for_model("sradsgan", scale).model_dir
            == jax_config("sradsgan", scale).model_dir)


def _tiny_trainer(tmp_path, seed=0):
    cfg = models.config_for_model("sradsgan", 2, bf16=False, seed=seed,
                                  save_dir=str(tmp_path))
    cfg.model_kwargs = dict(base_filters=16, n_groups=1, n_blocks=1)
    return Trainer(cfg, device="cpu")


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"lr": rng.random((2, 8, 8, 3), dtype=np.float32),
             "hr": rng.random((2, 16, 16, 3), dtype=np.float32)}
            for _ in range(n)]


def test_checkpoint_round_trip_resumes_the_same_trajectory(tmp_path):
    a = _tiny_trainer(tmp_path)
    first, second = _batches(2)
    a.train_step(first)
    path = a.save_checkpoint(0, include_optimizer=True)
    b = _tiny_trainer(tmp_path / "other")
    b.train_step(second)  # b's weights and optimizer states now differ
    b.train_step(second)
    b.load_checkpoint(path)
    assert b.step == 1
    g = torch.Generator().manual_seed(3)
    want = a.train_step(second, torch.Generator().manual_seed(3))
    got = b.train_step(second, g)
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6)
    for (name, p), q in zip(a.discriminator.state_dict().items(),
                            b.discriminator.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)


def test_float64_trainer_takes_the_step_in_float64(tmp_path):
    """Networks cast with .double() run the whole step in float64 (the
    reference chip_smoke.py holds the card's float32 step to), and agree
    with the float32 step to float32's rounding: losses at rel 1e-3 (the
    penalty of this small D is ill-conditioned, loss_D near 1.6e3 moves by
    about 2e-4), gradients within 1e-3 of the network's largest."""
    f32, f64 = _tiny_trainer(tmp_path), _tiny_trainer(tmp_path)
    for net in (f64.generator, f64.discriminator, f64.vgg):
        net.double()
    batch = _batches(1)[0]
    want = f32.train_step(batch, torch.Generator().manual_seed(3))
    got = f64.train_step(batch, torch.Generator().manual_seed(3))
    for key in want:
        assert got[key].dtype == torch.float64, key
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-3,
                                                abs=1e-6), key
    for net in ("generator", "discriminator"):
        ref = dict(getattr(f64, net).named_parameters())
        scale = max(float(p.grad.abs().max()) for p in ref.values())
        for name, p in getattr(f32, net).named_parameters():
            assert ref[name].grad.dtype == torch.float64, name
            np.testing.assert_allclose(p.grad.numpy(), ref[name].grad.numpy(),
                                       atol=1e-3 * scale, err_msg=name)


def test_train_clips_the_discriminator_and_keeps_lr_settable(tmp_path):
    t = _tiny_trainer(tmp_path)
    out = t.run_steps(iter(_batches(3)), num_steps=2)
    assert t.step == 2 and np.isfinite(list(out.values())).all()
    clip = t.cfg.gan.clip_value
    assert all(float(p.detach().abs().max()) <= clip
               for p in t.discriminator.parameters())
    set_lr(t.g_opt, 1e-4)
    assert get_lr(t.g_opt) == 1e-4 and get_lr(t.d_opt) == t.cfg.optim.lr


def test_trainer_defaults_to_cuda_and_says_so(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    cfg = models.config_for_model("sradsgan", 2)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Trainer(cfg)
