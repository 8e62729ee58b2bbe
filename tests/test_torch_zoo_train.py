"""The port's Trainer against the JAX package's for the model zoo's recipes,
over three-step trajectories, and the zoo's training configs.

The harness of ``tests/test_torch_trainer.py::
test_ten_steps_match_the_jax_trainer`` (same numpy batches, same weights
moved over the bridges, same penalty weights, the same tolerances) for five
recipes at tiny widths:

- EDSR: pixel loss only, no discriminator and no VGG;
- SRGAN: lsgan (MSE pixel, VGG content), BatchNorm in G, the plain D;
- NDSRGAN: lsgan with NDSRGAN's weights and 4x4 patch D;
- DRCAN: WGAN-GP (penalty, lambda + 1, weight clip) with the plain D;
- SRAGAN: WGAN-GP with the CBAM D (the kernels' ops in G and D) and
  BatchNorm in G (gains 0.5);
- HAT: L1 only, one group of two HABs, window 4 (a shifted one on the 8x8
  LR crops).

Every parameter of G and D is compared, and G's BatchNorm running
statistics (one train-mode forward a step, as in JAX).  The D's running
statistics follow the reference: four train-mode forwards a WGAN-GP step,
which JAX replays in closed form (compared at the flagship test's
tolerance), and three an lsgan step (D(sr) in the G step, D(hr), D(sr) in
the D step), where the JAX step keeps two; the lsgan expectation is
rebuilt from JAX's own batch statistics (:func:`_reference_d_stats`).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.core.config import config_for_model as jax_config  # noqa
from sradsgan_tpu import models as jax_models  # noqa: E402
from sradsgan_tpu.models import ModelSpec as JaxSpec  # noqa: E402
from sradsgan_tpu.models import get_spec as jax_spec  # noqa: E402
from sradsgan_tpu.models.discriminators import (  # noqa: E402
    PatchDiscriminator as JaxD)
from sradsgan_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from sradsgan_tpu_torch import models  # noqa: E402
from sradsgan_tpu_torch.losses import gan as gan_losses  # noqa: E402
from sradsgan_tpu_torch.models.discriminators import (  # noqa: E402
    PatchDiscriminator)
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    discriminator_state_dict, generator_state_dict, vgg19_state_dict)
from sradsgan_tpu_torch.train.trainer import Trainer  # noqa: E402

BATCH, STEPS = 4, 3
CBAM_BLOCKS = ((4, 1, False), (4, 2, True), (8, 1, True), (8, 2, True),
               (8, 1, True), (8, 1, True))
PLAIN_BLOCKS = ((4, 1, False), (4, 2, True), (8, 1, True), (8, 2, True))
NDSRGAN_BLOCKS = ((4, 2, False), (8, 2, True), (8, 2, True), (8, 1, True))
# model: (tiny generator kwargs, D kwargs (blocks, kernel size, CBAM))
RECIPES = {
    "edsr": (dict(base_filters=8, num_residuals=1), None),
    "srgan": (dict(base_filters=8, num_residuals=1),
              dict(blocks=PLAIN_BLOCKS, kernel_size=3, use_attention=False)),
    "ndsrgan": (dict(nf=8, nc=4, n_dcrdb=1),
                dict(blocks=NDSRGAN_BLOCKS, kernel_size=4,
                     use_attention=False)),
    "drcan": (dict(n_feats=8, n_resgroups=1, n_resblocks=1),
              dict(blocks=PLAIN_BLOCKS, kernel_size=3, use_attention=False)),
    "sragan": (dict(base_filters=16, n_groups=1, n_blocks=2),
               dict(blocks=CBAM_BLOCKS, kernel_size=3, use_attention=True)),
    "hat": (dict(embed_dim=12, depths=(2,), num_heads=(2,), window_size=4),
            None),
}


def _register(model, monkeypatch):
    """Tiny twins of ``model``'s recipe in both registries, for the test's
    duration."""
    name = f"tiny{model}_port"
    kwargs, d_kw = RECIPES[model]
    jspec = jax_spec(model)
    fields = {f.name: getattr(jspec, f.name)
              for f in dataclasses.fields(jspec)}
    fields.update(name=name, discriminator=None)
    port_fields = dict(fields, generator=models.get_spec(model).generator)
    if d_kw is not None:
        fields["discriminator"] = lambda **kw: JaxD(**d_kw, **kw)
        port_fields["discriminator"] = (
            lambda **kw: PatchDiscriminator(**d_kw, **kw))
    monkeypatch.setitem(jax_models._REGISTRY, name, JaxSpec(**fields))
    monkeypatch.setitem(models._REGISTRY, name,
                        models.ModelSpec(**port_fields))
    return name, kwargs, d_kw


def _gains(params, value):
    ga = dict(params["GlobalAttention_0"])
    for name in ("ChannelSelfAttention_0", "SpatialSelfAttention_0"):
        ga[name] = dict(ga[name], gamma=np.full((1,), value, np.float32))
    return dict(params, GlobalAttention_0=ga)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _g_state(model, state):
    return generator_state_dict(model, {"params": _np(state.g_params),
                                        "batch_stats": _np(state.g_stats)})


def _d_state(d_kw, params, stats):
    return discriminator_state_dict(
        {"params": _np(params), "batch_stats": _np(stats)}, d_kw["blocks"],
        d_kw["use_attention"])


def zero_by_math(model):
    """Parameters whose gradient is zero in exact arithmetic: the bias of
    a conv that feeds a BatchNorm, and the SGAM key conv's bias (the
    softmax removes it).  Adam turns their rounding noise into full-size
    steps of either sign, so they are held to Adam's bound alone."""
    names = {n for n, _ in model.named_parameters()
             if n.endswith("sa.key_conv.bias")}
    layers = list(model.named_modules())
    for (name, m), (_, nxt) in zip(layers, layers[1:]):
        if (isinstance(m, torch.nn.Conv2d) and m.bias is not None
                and isinstance(nxt, torch.nn.BatchNorm2d)):
            names.add(f"{name}.bias")
    return names


def _reference_d_stats(jt, state, batch, expected):
    """The D's running statistics after one more lsgan step of the
    reference, from JAX's own: JAX keeps two updates a step, r <- 0.9 r +
    0.1 b for D(hr) then D(sr); the reference (and the port) also updates
    in the G step's D(sr), on the same weights and sr, so with the same
    batch statistics as the D step's D(sr).  Each update is linear, so
    ``0.1 b`` of each forward follows from JAX's states before, after its
    D(hr) and after its step, and ``expected`` (the reference's before)
    takes sr, hr, sr."""
    _, after_hr = jt.d_apply(state.d_params, state.d_stats,
                             jnp.asarray(batch["hr"]), True)
    return jax.tree.map(lambda e, s0, s1: (e, s0, s1), expected,
                        _np(state.d_stats), _np(after_hr))


def _replay(triples, new_stats):
    """``expected`` of :func:`_reference_d_stats` advanced by one step,
    given JAX's stats after the step."""
    def one(triple, s2):
        e, s0, s1 = triple
        hr = s1 - 0.9 * s0
        sr = s2 - 0.9 * s1
        return 0.9 * (0.9 * (0.9 * e + sr) + hr) + sr
    return jax.tree.map(one, triples, _np(new_stats),
                        is_leaf=lambda t: isinstance(t, tuple))


@pytest.mark.parametrize("model", RECIPES)
def test_three_steps_match_the_jax_trainer(model, monkeypatch, tmp_path):
    name, kwargs, d_kw = _register(model, monkeypatch)
    cfg = jax_config(name, 2)
    cfg.bf16 = False
    cfg.data.synthetic = True
    cfg.data.crop_size = 16
    cfg.data.batch_size = BATCH
    cfg.model_kwargs = kwargs
    cfg.save_dir = str(tmp_path)
    jt = JaxTrainer(cfg)
    if model == "sragan":
        g_params = _gains(_np(jt.state.g_params), 0.5)
        jt.state = jt.state.replace(
            g_params=jax.tree.map(jnp.asarray, g_params),
            g_opt=jt.g_opt_tx.init(jax.tree.map(jnp.asarray, g_params)))

    pt = Trainer(models.config_for_model(name, 2, bf16=False,
                                         model_kwargs=kwargs,
                                         save_dir=str(tmp_path)),
                 device="cpu")
    pt.generator.load_state_dict(_g_state(model, jt.state))
    adversarial = d_kw is not None
    assert (pt.discriminator is not None) == adversarial
    assert (pt.vgg is not None) == adversarial
    if adversarial:
        pt.discriminator.load_state_dict(
            _d_state(d_kw, jt.state.d_params, jt.state.d_stats))
        pt.vgg.load_state_dict(vgg19_state_dict(_np(jt.vgg_params)))
    initial = {k: v.clone() for k, v in pt.generator.state_dict().items()}
    lsgan = jt.cfg.gan.gan_type == "lsgan"
    expected_d = _np(jt.state.d_stats) if lsgan else None

    data = np.random.default_rng(11)
    alpha = data.random((BATCH, 1, 1, 1)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(alpha))
    monkeypatch.setattr(gan_losses, "interpolation_weights",
                        lambda b, g, device: torch.from_numpy(alpha))
    keys = (("loss_G", "pixel") + (("loss_D", "content", "adv_g")
                                   if adversarial else ()))
    for step in range(STEPS):
        batch = {"lr": data.random((BATCH, 8, 8, 3)).astype(np.float32),
                 "hr": data.random((BATCH, 16, 16, 3)).astype(np.float32)}
        if lsgan:
            triples = _reference_d_stats(jt, jt.state, batch, expected_d)
        jt.state, want = jt._jit_step(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(step))
        if lsgan:
            expected_d = _replay(triples, jt.state.d_stats)
        got = pt.train_step(batch)
        assert set(got) == set(keys)
        for key in keys:
            assert float(got[key]) == pytest.approx(
                float(want[key]), rel=5e-4, abs=1e-4), (step, key)
    assert pt.step == STEPS

    checks = [("G", pt.generator, _g_state(model, jt.state))]
    if adversarial:
        d_stats = expected_d if lsgan else jt.state.d_stats
        checks.append(("D", pt.discriminator,
                       _d_state(d_kw, jt.state.d_params, d_stats)))
    lr = pt.cfg.optim.lr
    for net, module, want in checks:
        got = module.state_dict()
        assert set(got) == set(want), net
        noise = zero_by_math(module)
        for key, value in got.items():
            if key in noise:  # Adam's steps are at most lr each
                assert value.abs().max() <= STEPS * lr * 1.01 + 1e-7, key
            elif key.endswith("running_mean"):
                np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                           atol=3e-3, err_msg=(net, key))
            elif key.endswith("running_var"):
                np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                           rtol=5e-3, err_msg=(net, key))
            elif not key.endswith("num_batches_tracked"):
                np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                           atol=1e-4, rtol=1e-3,
                                           err_msg=(net, key))
    # the trajectory moved the generator (the comparison is not of inits)
    moved = [k for k, v in pt.generator.state_dict().items()
             if k.endswith("weight")
             and not torch.equal(v, initial[k])]
    assert len(moved) >= len(initial) // 3, moved
    if adversarial and d_kw["use_attention"]:
        gate = next(m for m in pt.discriminator.model
                    if hasattr(m, "conv1"))
        assert gate.conv1.weight.grad.abs().max() > 0


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


ZOO = ("amssrn", "drcan", "dssr", "edsr", "hat", "ndsrgan", "sradsgan",
       "sragan", "srgan")


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("model", ZOO)
def test_config_for_model_matches_jax(model, scale):
    """Every field of the port's config has the JAX value, the recipe's
    weights and per-model epochs and step decay included."""
    port = _fields(models.config_for_model(model, scale))
    want = _fields(jax_config(model, scale))
    assert set(port) <= set(want), set(port) - set(want)
    assert port == {k: want[k] for k in port}
    spec, jspec = models.get_spec(model), jax_spec(model)
    assert (spec.adversarial, spec.pixel_loss, spec.default_lr) == (
        jspec.adversarial, jspec.pixel_loss, jspec.default_lr)
    if model == "ndsrgan":
        assert (port["optim.step_decay_epochs"], port["num_epochs"]) == (12,
                                                                         47)
    if model == "edsr":
        assert port["num_epochs"] == 3


def test_the_registry_lists_the_eight_ported_models():
    # tests register tiny twins named "*_port" (test_torch_trainer.py keeps
    # its own for the worker's life)
    assert [m for m in models.available_models()
            if not m.endswith("_port")] == list(ZOO)
    with pytest.raises(KeyError, match="unknown model"):
        models.config_for_model("nope", 4)
    for name in ZOO:
        spec = models.get_spec(name)
        if spec.adversarial:
            d = models.create_discriminator(name)
            cbam = any(hasattr(m, "fc1") for m in d.modules())
            assert cbam == (name in ("sradsgan", "sragan")), name
        else:
            with pytest.raises(ValueError, match="no discriminator"):
                models.create_discriminator(name)


def test_plateau_reload_restores_a_batchnorm_generator_whole(monkeypatch,
                                                             tmp_path):
    """SRGAN at the plateau: the best checkpoint's whole ``state_dict`` comes
    back, its running statistics included, as the reference reloads it (the
    JAX trainer reloads ``g_params`` and keeps the current ``g_stats``, a
    difference kept on purpose: ROADMAP.md Queue 3)."""
    cfg = models.config_for_model(
        "srgan", 2, bf16=False, save_dir=str(tmp_path), num_epochs=2,
        model_kwargs=RECIPES["srgan"][0])
    cfg.data.synthetic, cfg.data.synthetic_size = True, 4
    cfg.data.crop_size, cfg.data.batch_size = 16, 4
    cfg.optim.plateau_patience, cfg.optim.plateau_rewind = 1, False
    pt = Trainer(cfg, device="cpu")
    # epoch 1 improves no metric of the chain (whose SSIM and ERGAS bests
    # are still the initial 0 and 1e4): one plateau
    scores = iter([dict(psnr=30.0, ssim=0.3, ergas=70.0),
                   dict(psnr=29.0, ssim=0.0, ergas=1e4)])
    monkeypatch.setattr(pt, "validate",
                        lambda max_batches=None: next(scores))
    pt.train()
    best = torch.load(tmp_path / "SRGAN_x2" / "ckpt_best.pt",
                      weights_only=True)["generator"]
    last = torch.load(tmp_path / "SRGAN_x2" / "ckpt_epoch_1.pt",
                      weights_only=True)["generator"]
    now = pt.generator.state_dict()
    key = "upsampling.1.running_mean"
    assert not torch.equal(best[key], last[key])  # epoch 1 moved them
    for k, v in best.items():
        assert torch.equal(now[k], v), k
