"""The port's discriminator, VGG content features and GAN losses against the
JAX package's, through the weight bridge (``tools/from_jax.py``).

Weights are drawn with numpy at fan-in scale so that activations are of
order one.  float32 on both sides; the tolerances cover summation order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.losses import gan as jax_gan  # noqa: E402
from sradsgan_tpu.losses.vgg import VGG19Features as JaxVGG  # noqa: E402
from sradsgan_tpu.models.discriminators import (  # noqa: E402
    PatchDiscriminator as JaxD)
from sradsgan_tpu.tools.import_reference import (  # noqa: E402
    import_patch_discriminator)
from sradsgan_tpu_torch.losses import gan  # noqa: E402
from sradsgan_tpu_torch.losses.pixel import pixel_loss  # noqa: E402
from sradsgan_tpu_torch.losses.vgg import VGG19Features, load_vgg19  # noqa
from sradsgan_tpu_torch.models.discriminators import (  # noqa: E402
    DEFAULT_BLOCKS, PatchDiscriminator)
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    discriminator_state_dict, save_npz, vgg19_state_dict)

SMALL_BLOCKS = ((8, 1, False), (8, 2, True), (16, 1, True), (16, 2, True),
                (32, 1, True), (32, 2, True), (32, 1, True), (32, 2, True))


def _fan_in(tree, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "bias":
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, 1 / np.sqrt(fan_in),
                          leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _jax_d(blocks, size=32, seed=0):
    d = JaxD(blocks=blocks, use_attention=True)
    variables = jax.tree.map(np.asarray, d.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    rng = np.random.default_rng(seed + 100)
    stats = jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape)
                         .astype(np.float32), variables["batch_stats"])
    return d, {"params": _fan_in(variables["params"], seed),
               "batch_stats": stats}


def _port_d(blocks, variables):
    model = PatchDiscriminator(blocks=blocks)
    model.load_state_dict(discriminator_state_dict(variables, blocks))
    return model


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_jax(train):
    d, variables = _jax_d(SMALL_BLOCKS)
    x = np.random.default_rng(1).random((4, 32, 32, 3)).astype(np.float32)
    port = _port_d(SMALL_BLOCKS, variables).train(train)
    if train:
        want, upd = d.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    else:
        want = d.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.shape == (4, 1, 2, 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 0.1
    if train:  # torch's running statistics equal the JAX BatchNorm's
        back = discriminator_state_dict(
            {"params": variables["params"],
             "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])},
            SMALL_BLOCKS)
        for key, value in port.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(value.numpy(), back[key].numpy(),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=key)


def test_discriminator_state_dict_is_what_import_reference_reads():
    """The port's flat ``model`` Sequential is the reference's layout:
    import_patch_discriminator maps it back to the JAX tree exactly, at the
    full width of the eight default blocks."""
    _, variables = _jax_d(DEFAULT_BLOCKS, seed=2)
    port = _port_d(DEFAULT_BLOCKS, variables)
    zeros = jax.tree.map(np.zeros_like, variables)
    back = import_patch_discriminator(port.state_dict(), zeros)
    leaves, tree = jax.tree.flatten(variables)
    back_leaves, back_tree = jax.tree.flatten(back)
    assert tree == back_tree
    for a, b in zip(leaves, back_leaves):
        np.testing.assert_array_equal(a, b)


def test_discriminator_cbam_sits_at_27x27_with_256_channels():
    """At the train step's 216^2 HR input the D's gate sees (B, 256, 27,
    27), the shape the kernels are timed at."""
    seen = []
    model = PatchDiscriminator()
    model.model[17].register_forward_hook(
        lambda m, i, o: seen.append(tuple(i[0].shape)))
    with torch.no_grad():
        out = model(torch.zeros(1, 3, 216, 216))
    assert seen == [(1, 256, 27, 27)] and out.shape == (1, 1, 14, 14)


def test_vgg_features_match_jax(tmp_path):
    jm = JaxVGG()
    x = np.random.default_rng(3).random((2, 20, 20, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                              jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = VGG19Features()
    port.load_state_dict(vgg19_state_dict(params))
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 5, 5, 256)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the .npz of SRADSGAN_TPU_VGG19_NPZ loads the same weights
    save_npz(str(tmp_path / "vgg19.npz"), params)
    loaded = load_vgg19(str(tmp_path / "vgg19.npz"))
    assert not any(p.requires_grad for p in loaded.parameters())
    with torch.no_grad():
        np.testing.assert_array_equal(loaded(_nchw(x)).numpy(),
                                      port(_nchw(x)).numpy())


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_pixel_loss_matches_jax(kind):
    from sradsgan_tpu.losses.pixel import pixel_loss as jax_pixel_loss
    rng = np.random.default_rng(4)
    a, b = (rng.random((2, 3, 5, 5)).astype(np.float32) for _ in range(2))
    want = float(jax_pixel_loss(jnp.asarray(a), jnp.asarray(b), kind))
    got = float(pixel_loss(torch.from_numpy(a), torch.from_numpy(b), kind))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("relativistic", [False, True])
@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan-gp"])
def test_gan_losses_match_jax(gan_type, relativistic):
    rng = np.random.default_rng(5)
    real, fake = (rng.normal(0, 2, (4, 6, 6, 1)).astype(np.float32)
                  for _ in range(2))
    jr, jf = jnp.asarray(real), jnp.asarray(fake)
    tr, tf = _nchw(real), _nchw(fake)
    want_g = float(jax_gan.adversarial_loss_g(
        jf, gan_type, real_logits=jr, relativistic=relativistic))
    want_d = float(jax_gan.adversarial_loss_d(jr, jf, gan_type,
                                              relativistic=relativistic))
    got_g = float(gan.adversarial_loss_g(tf, gan_type, real_logits=tr,
                                         relativistic=relativistic))
    got_d = float(gan.adversarial_loss_d(tr, tf, gan_type,
                                         relativistic=relativistic))
    assert got_g == pytest.approx(want_g, rel=1e-5, abs=1e-6)
    assert got_d == pytest.approx(want_d, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("penalty", ["ls", "hinge"])
@pytest.mark.parametrize("norm", ["l2", "l1", "linf"])
def test_gradient_penalty_matches_jax(norm, penalty, monkeypatch):
    """Through the small CBAM discriminator in train mode, so the penalty's
    gradient runs the gate's and the pool's backwards; then the penalty's
    own gradient for every D parameter (the grad-of-grad)."""
    d, variables = _jax_d(SMALL_BLOCKS, seed=6)
    rng = np.random.default_rng(7)
    real, fake = (rng.random((4, 32, 32, 3)).astype(np.float32)
                  for _ in range(2))
    alpha = rng.random((4, 1, 1, 1)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(alpha))

    def jax_gp(params):
        def d_fn(x):
            out, stats = d.apply({"params": params,
                                  "batch_stats": variables["batch_stats"]},
                                 x, train=True, mutable=["batch_stats"])
            return out, stats["batch_stats"]

        gp, _ = jax_gan.gradient_penalty(
            d_fn, jnp.asarray(real), jnp.asarray(fake),
            jax.random.PRNGKey(0), lp_norm=norm, penalty_type=penalty,
            with_stats=True)
        return gp

    want, want_grads = jax.value_and_grad(jax_gp)(variables["params"])
    port = _port_d(SMALL_BLOCKS, variables).train()
    got = gan.gradient_penalty(port, _nchw(real), _nchw(fake),
                               torch.from_numpy(alpha), lp_norm=norm,
                               penalty_type=penalty)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4,
                                             abs=1e-6)
    params = dict(port.named_parameters())
    # the last conv's bias does not reach the input gradient: no grad
    grads = {n: torch.zeros_like(params[n]) if g is None else g
             for n, g in zip(params, torch.autograd.grad(
                 got, list(params.values()), allow_unused=True))}
    mapped = discriminator_state_dict(
        {"params": jax.tree.map(np.asarray, want_grads),
         "batch_stats": variables["batch_stats"]}, SMALL_BLOCKS)
    scale = max(float(mapped[n].abs().max()) for n in grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), mapped[name].numpy(),
                                   rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=name)
    if penalty == "ls":  # (hinge is flat where every norm is below one)
        assert float(grads["model.18.conv1.weight"].abs().max()) > 0


def test_interpolation_weights_are_the_same_on_every_device():
    a = gan.interpolation_weights(3, torch.Generator().manual_seed(1),
                                  torch.device("cpu"))
    b = gan.interpolation_weights(3, torch.Generator().manual_seed(1),
                                  torch.device("cpu"))
    assert a.shape == (3, 1, 1, 1) and torch.equal(a, b)
    assert ((a >= 0) & (a < 1)).all()
