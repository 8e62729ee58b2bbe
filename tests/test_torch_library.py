"""The port's block library against the JAX package's, through the weight
bridges (``sradsgan_tpu_torch/tools/from_jax.py``): the 2x upsamplers, the
spectrally normalized conv and discriminator, the VGG-style discriminator,
the patch discriminator with global attention (its WGAN-GP value and D
gradient), the ESRGAN generators, the feature extractors, AA-conv and the
auxiliary losses.

Weights are drawn with numpy at fan-in scale so that activations are of
order one; BatchNorm statistics are drawn too.  float32 on both sides, the
JAX side running its CPU formulations, at the tolerance of
``tests/test_torch_sradsgan.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.losses import extra as jax_extra  # noqa: E402
from sradsgan_tpu.losses import gan as jax_gan  # noqa: E402
from sradsgan_tpu.models import discriminators as jax_d  # noqa: E402
from sradsgan_tpu.nn import augmented_conv as jax_aa  # noqa: E402
from sradsgan_tpu.nn import blocks as jax_blocks  # noqa: E402
from sradsgan_tpu.nn import esrgan as jax_esrgan  # noqa: E402
from sradsgan_tpu.nn import extractors as jax_extractors  # noqa: E402
from sradsgan_tpu.nn.spectral_norm import SNConv as JaxSNConv  # noqa: E402
from sradsgan_tpu_torch.losses import extra, gan  # noqa: E402
from sradsgan_tpu_torch.models.discriminators import (  # noqa: E402
    PatchDiscriminator, SNPatchDiscriminator, VGGStyleDiscriminator)
from sradsgan_tpu_torch.nn.augmented_conv import AugmentedConv  # noqa: E402
from sradsgan_tpu_torch.nn.blocks import (  # noqa: E402
    DeconvBlock, Upsample2xBlock, same_padding)
from sradsgan_tpu_torch.nn.esrgan import RRDBNet, SRResNet  # noqa: E402
from sradsgan_tpu_torch.nn.extractors import (  # noqa: E402
    MINCNet, ResNet101FeatureExtractor, VGGFeatureExtractor)
from sradsgan_tpu_torch.nn.spectral_norm import SNConv  # noqa: E402
from sradsgan_tpu_torch.ops import sgam_flash  # noqa: E402
from sradsgan_tpu_torch.tools import from_jax  # noqa: E402

RTOL, ATOL = 1e-4, 3e-5  # tests/test_torch_sradsgan.py's bar
# patch D blocks whose last width (32) is one the attention kernel is built
# for: the D's SGAM runs the plain composition all the same, because the D
# builds it plain, and the gradient penalty differentiates it twice
GA_BLOCKS = ((8, 1, False), (8, 2, True), (16, 1, True), (16, 2, True),
             (32, 1, True), (32, 2, True), (32, 1, True), (32, 2, True))


def _fan_in(tree, seed):
    """Same tree, numpy leaves: kernels normal(0, 1 / sqrt(fan_in)), biases
    normal(0, 0.05), BatchNorm scales uniform(0.5, 1.5), gains 0.6, AA-conv's
    relative tables normal(0, 0.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "gamma":
            return np.full(leaf.shape, 0.6, np.float32)
        if name == "bias":
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name.startswith("key_rel"):
            return rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, 1 / np.sqrt(fan_in),
                          leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _variables(module, x, seed, **kw):
    """The module's JAX variables, by shape alone (nothing compiled): fan-in
    weights, running means normal(0, 0.1) and variances uniform(0.5, 1.5),
    spectral-norm vectors normal(0, 1)."""
    shapes = jax.eval_shape(functools.partial(module.init, **kw),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed + 100)

    def draw(path, s):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.normal(0, 1, s.shape).astype(np.float32)

    out = {k: jax.tree_util.tree_map_with_path(draw, v)
           for k, v in shapes.items() if k != "params"}
    return dict(out, params=_fan_in(shapes["params"], seed))


def _apply(module, variables, x, **kw):
    """``module.apply`` compiled once (faster here than op by op)."""
    return jax.jit(functools.partial(module.apply, **kw))(variables,
                                                            jnp.asarray(x))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _x(shape, seed=1):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _port(module, state):
    module.load_state_dict(state)  # strict
    return module


@pytest.mark.parametrize("kernel,stride", [(4, 2), (3, 2), (2, 2), (3, 1)])
@pytest.mark.parametrize("norm", [None, "batch"])
def test_deconv_block_matches_jax(kernel, stride, norm):
    m = jax_blocks.DeconvBlock(8, kernel, stride, "relu", norm)
    x = _x((2, 6, 7, 5))
    v = _variables(m, x, seed=kernel + stride)
    want = _apply(m, v, x, train=False)
    port = _port(DeconvBlock(5, 8, kernel, stride, "relu", norm),
                 from_jax.deconv_block_state_dict(v)).eval()
    got = _nhwc(port(_nchw(x)))
    assert got.shape == (2, 6 * stride, 7 * stride, 8)
    _close(got, want)


def test_flax_deconv_is_torch_convtranspose_with_the_kernel_flipped():
    """Flax's ConvTranspose(4, stride 2, SAME) equals torch's
    ConvTranspose2d(4, 2, padding=1) once the kernel is flipped in both
    spatial axes (HWIO -> (in, out, kh, kw)), which the bridge does; the
    unflipped kernel does not."""
    m = jax_blocks.DeconvBlock(6, norm=None, activation=None)
    x = _x((2, 5, 5, 4), seed=3)
    v = _variables(m, x, seed=4)
    want = np.asarray(_apply(m, v, x))
    node = v["params"]["ConvTranspose_0"]
    plain = torch.nn.ConvTranspose2d(4, 6, 4, 2, padding=1)
    kernel = torch.from_numpy(node["kernel"].transpose(2, 3, 0, 1).copy())
    with torch.no_grad():
        plain.bias.copy_(torch.from_numpy(node["bias"]))
        plain.weight.copy_(kernel.flip(2, 3))
        _close(_nhwc(plain(_nchw(x))), want)
        state = from_jax.deconv_block_state_dict(v)
        assert torch.equal(state["deconv.weight"], plain.weight)
        plain.weight.copy_(kernel)
        assert np.abs(_nhwc(plain(_nchw(x))) - want).max() > 1e-2


@pytest.mark.parametrize("norm", [None, "batch"])
@pytest.mark.parametrize("mode", ["deconv", "ps", "rnc"])
def test_upsample2x_block_matches_jax(mode, norm):
    m = jax_blocks.Upsample2xBlock(8, upsample=mode, norm=norm)
    x = _x((2, 5, 6, 4))
    v = _variables(m, x, seed=len(mode))
    want = _apply(m, v, x, train=False)
    port = _port(Upsample2xBlock(4, 8, mode, norm=norm),
                 from_jax.upsample2x_state_dict(v)).eval()
    _close(_nhwc(port(_nchw(x))), want)


def test_upsample2x_block_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown upsample mode"):
        Upsample2xBlock(4, 8, "bilinear")


@pytest.mark.parametrize("size,kernel,stride,want", [
    (8, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (8, 4, 2, (1, 1)),
    (8, 3, 1, (1, 1)), (8, 1, 2, (0, 0)), (27, 3, 2, (1, 1))])
def test_same_padding_is_xlas(size, kernel, stride, want):
    assert same_padding(size, kernel, stride) == want


@pytest.mark.parametrize("stride", [1, 2])
def test_snconv_matches_jax_over_three_train_applications(stride):
    """u moves at each train application exactly as JAX's ``spectral``
    collection, the outputs agree; in eval u stays; the gradient treats
    sigma as a constant (JAX's stop_gradient)."""
    m = JaxSNConv(8, 3, stride)
    x = _x((2, 8, 9, 5), seed=2)
    v = _variables(m, x, seed=5)
    port = SNConv(5, 8, 3, stride)
    state = {"weight": torch.from_numpy(from_jax._oihw(
        v["params"]["kernel"])), "bias": torch.from_numpy(v["params"]["bias"]),
        "u": torch.tensor(v["spectral"]["u"])}
    _port(port, state).train()
    spectral = v["spectral"]
    for _ in range(3):
        want, upd = _apply(m, {"params": v["params"], "spectral": spectral},
                           x, update_stats=True, mutable=["spectral"])
        spectral = jax.tree.map(np.asarray, upd["spectral"])
        _close(_nhwc(port(_nchw(x))), want)
        np.testing.assert_allclose(port.u.numpy(), spectral["u"], rtol=1e-5,
                                   atol=1e-6)
        assert not np.allclose(spectral["u"], v["spectral"]["u"])
    port.eval()
    u = port.u.clone()
    want = _apply(m, {"params": v["params"], "spectral": spectral}, x,
                  update_stats=False)
    _close(_nhwc(port(_nchw(x))), want)
    assert torch.equal(port.u, u)

    g = _x(np.shape(want), seed=6)

    def loss(params):
        out = m.apply({"params": params, "spectral": spectral},
                      jnp.asarray(x), update_stats=False)
        return jnp.sum(out * g)

    want_grads = jax.jit(jax.grad(loss))(v["params"])
    (port(_nchw(x)) * _nchw(g)).sum().backward()
    kernel = from_jax._oihw(want_grads["kernel"])
    np.testing.assert_allclose(port.weight.grad.numpy(), kernel, rtol=1e-4,
                               atol=1e-5 * np.abs(kernel).max())
    np.testing.assert_allclose(port.bias.grad.numpy(),
                               np.asarray(want_grads["bias"]), rtol=1e-4,
                               atol=1e-5)


def test_snconv_sigma_carries_no_gradient():
    """The weight's gradient is the plain conv's over sigma: sigma is a
    constant, unlike torch.nn.utils' spectral norm."""
    port = SNConv(3, 4, 3).eval()
    x = torch.from_numpy(_x((1, 3, 6, 6)))
    port(x).sum().backward()
    sigma, _ = port.sigma()
    w = port.weight.detach().requires_grad_()
    torch.nn.functional.conv2d(x, w / sigma, port.bias.detach(),
                               padding=1).sum().backward()
    torch.testing.assert_close(port.weight.grad, w.grad)


@pytest.mark.parametrize("train", [False, True])
def test_sn_patch_discriminator_matches_jax(train):
    m = jax_d.SNPatchDiscriminator(blocks=GA_BLOCKS)
    x = _x((2, 16, 16, 3), seed=7)
    v = _variables(m, x, seed=8)
    port = _port(SNPatchDiscriminator(GA_BLOCKS),
                 from_jax.sn_patch_discriminator_state_dict(v)).train(train)
    if train:
        want, upd = _apply(m, v, x, train=True, mutable=["spectral"])
        state = from_jax.sn_patch_discriminator_state_dict(
            {"params": v["params"],
             "spectral": jax.tree.map(np.asarray, upd["spectral"])})
    else:
        want = _apply(m, v, x, train=False)
        state = from_jax.sn_patch_discriminator_state_dict(v)
    _close(_nhwc(port(_nchw(x))), want)
    for key, value in port.state_dict().items():
        if key.endswith(".u"):
            np.testing.assert_allclose(value.numpy(), state[key].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("input_size", [64, 128])
def test_vgg_style_discriminator_matches_jax(input_size, train):
    m = jax_d.VGGStyleDiscriminator(input_size=input_size, base_nf=16)
    x = _x((2, input_size, input_size, 3), seed=9)
    v = _variables(m, x, seed=input_size)
    port = _port(VGGStyleDiscriminator(input_size, 16),
                 from_jax.vgg_style_discriminator_state_dict(v)).train(train)
    if train:
        want, _ = _apply(m, v, x, train=True, mutable=["batch_stats"])
    else:
        want = _apply(m, v, x, train=False)
    got = port(_nchw(x)).detach().numpy()
    assert got.shape == (2, 1)
    _close(got, want)


def _global_attention_d(seed=11):
    m = jax_d.PatchDiscriminator(blocks=GA_BLOCKS, use_attention=True,
                                 use_global_attention=True)
    x = _x((3, 32, 32, 3), seed=seed)
    v = _variables(m, x, seed=seed, train=False)
    port = PatchDiscriminator(GA_BLOCKS, use_global_attention=True)
    _port(port, from_jax.discriminator_state_dict(
        v, GA_BLOCKS, use_global_attention=True))
    return m, v, port, x


def test_patch_discriminator_with_global_attention_matches_jax():
    m, v, port, x = _global_attention_d()
    assert port.model[-2].plain  # the D's SGAM is built plain
    want = _apply(m, v, x, train=False)
    _close(_nhwc(port.eval()(_nchw(x))), want)


def test_global_attention_d_gives_jaxs_wgan_gp_and_its_d_gradient(
        monkeypatch):
    """The penalty through CGAM and SGAM after block 8 (eval mode, so the
    running statistics are the drawn ones on both sides): its value and its
    gradient for every D parameter, the SGAM's and the CGAM's included."""
    m, v, port, _ = _global_attention_d(seed=12)
    rng = np.random.default_rng(13)
    real, fake = (rng.random((3, 32, 32, 3)).astype(np.float32)
                  for _ in range(2))
    alpha = rng.random((3, 1, 1, 1)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(alpha))

    def jax_gp(params):
        return jax_gan.gradient_penalty(
            lambda t: m.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, t,
                              train=False),
            jnp.asarray(real), jnp.asarray(fake), jax.random.PRNGKey(0))

    want, want_grads = jax.jit(jax.value_and_grad(jax_gp))(v["params"])
    port.eval()
    got = gan.gradient_penalty(port, _nchw(real), _nchw(fake),
                               torch.from_numpy(alpha))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4,
                                               abs=1e-6)
    params = dict(port.named_parameters())
    grads = {n: torch.zeros_like(params[n]) if g is None else g
             for n, g in zip(params, torch.autograd.grad(
                 got, list(params.values()), allow_unused=True))}
    mapped = from_jax.discriminator_state_dict(
        {"params": jax.tree.map(np.asarray, want_grads),
         "batch_stats": v["batch_stats"]}, GA_BLOCKS,
        use_global_attention=True)
    scale = max(float(mapped[n].abs().max()) for n in grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), mapped[name].numpy(),
                                   rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=name)
    sgam = [n for n in grads if n.endswith("query_conv.weight")]
    assert sgam and float(grads[sgam[0]].abs().max()) > 0


def test_the_attention_op_refuses_a_second_derivative():
    """At a width the kernels are built for, the SGAM's op is first order
    only: asking it for the gradient of a gradient raises, never a wrong
    number."""
    from sradsgan_tpu_torch.nn.attention import SpatialSelfAttention
    sgam = SpatialSelfAttention(64)
    assert not sgam.plain and SpatialSelfAttention(512, plain=True).plain
    with torch.no_grad():
        sgam.gamma.fill_(0.5)
    x = torch.randn(1, 64, 4, 4, requires_grad=True)
    (g,) = torch.autograd.grad(sgam(x).square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()
    assert (8, 64) in sgam_flash.KERNEL_WIDTHS


def _generator_sgams(**kwargs):
    from sradsgan_tpu_torch.models import create_generator
    from sradsgan_tpu_torch.nn.attention import SpatialSelfAttention
    g = create_generator("sradsgan", 4, n_groups=1, n_blocks=1, **kwargs)
    return [m for m in g.modules() if isinstance(m, SpatialSelfAttention)]


def test_a_generator_sgam_at_an_unbuilt_width_takes_the_op(monkeypatch):
    """Only the patch D asks for the plain SGAM: a generator's SGAM at a
    width the kernel is not built for (base_filters 128: d_qk 16, d_v 128)
    still calls the attention op, whose kernel wrapper refuses that width,
    so the card raises there rather than running the plain version."""
    from sradsgan_tpu_torch.nn import attention
    from sradsgan_tpu_torch.ops import _build
    (sgam,) = _generator_sgams(base_filters=128)
    assert not sgam.plain
    calls = []
    monkeypatch.setattr(attention, "position_attention",
                        lambda q, k, v: calls.append(q.shape) or
                        sgam_flash.position_attention(q, k, v))
    sgam(torch.randn(1, 128, 3, 3))
    assert calls == [(1, 9, 16)]
    assert (16, 128) not in sgam_flash.KERNEL_WIDTHS
    monkeypatch.setattr(_build, "check_input", lambda *a: None)
    q, v = torch.zeros(1, 9, 16), torch.zeros(1, 9, 128)
    with pytest.raises(ValueError, match="no kernel for d_qk=16, d_v=128"):
        sgam_flash.position_attention_cuda(q, q, v)


@pytest.mark.gpu
def test_a_generator_sgam_at_an_unbuilt_width_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (sgam,) = _generator_sgams(base_filters=128, device="cuda")
    with pytest.raises(ValueError, match="no kernel for d_qk=16"):
        sgam(torch.randn(1, 128, 3, 3, device="cuda"))


@pytest.mark.parametrize("scale", [2, 4])
def test_rrdbnet_matches_jax(scale):
    m = jax_esrgan.RRDBNet(scale=scale, nf=16, nb=2, gc=8)
    x = _x((1, 8, 8, 3), seed=14)
    v = _variables(m, x, seed=scale)
    port = _port(RRDBNet(scale, nf=16, nb=2, gc=8),
                 from_jax.rrdbnet_state_dict(v))
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), _apply(m, v, x))


@pytest.mark.parametrize("scale", [3, 4])
def test_srresnet_matches_jax(scale):
    m = jax_esrgan.SRResNet(scale=scale, nf=16, nb=3)
    x = _x((1, 8, 8, 3), seed=15)
    v = _variables(m, x, seed=scale + 10)
    port = _port(SRResNet(scale, nf=16, nb=3),
                 from_jax.srresnet_state_dict(v))
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), _apply(m, v, x))


@pytest.mark.parametrize("feature_layer,use_bn", [(34, False), (11, False),
                                                  (20, True)])
def test_vgg_feature_extractor_matches_jax(feature_layer, use_bn):
    m = jax_extractors.VGGFeatureExtractor(feature_layer, use_bn)
    x = _x((2, 32, 32, 3), seed=16)
    v = _variables(m, x, seed=feature_layer, train=False)
    port = _port(VGGFeatureExtractor(feature_layer, use_bn),
                 from_jax.vgg_feature_extractor_state_dict(
                     v, feature_layer, use_bn)).eval()
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))),
               _apply(m, v, x, train=False))


@pytest.mark.parametrize("train", [False, True])
def test_resnet101_extractor_matches_jax(train):
    """At small depth (one bottleneck a stage), 33^2 and 32^2 inputs: the
    stride-2 3x3 convs pad as XLA's SAME, (0, 1) on an even size."""
    m = jax_extractors.ResNet101FeatureExtractor(stage_blocks=(1, 1, 1))
    port = None
    for size in (33, 32):
        x = _x((2, size, size, 3), seed=size)
        if port is None:
            v = _variables(m, x, seed=17, train=False)
            port = _port(ResNet101FeatureExtractor(stage_blocks=(1, 1, 1)),
                         from_jax.resnet101_state_dict(v))
        port.train(train)
        if train:
            want, _ = _apply(m, v, x, train=True, mutable=["batch_stats"])
        else:
            want = _apply(m, v, x, train=False)
        with torch.no_grad():
            _close(_nhwc(port(_nchw(x))), want)


def test_minc_net_matches_jax():
    m = jax_extractors.MINCNet()
    x = _x((1, 32, 32, 3), seed=18)
    v = _variables(m, x, seed=19)
    port = _port(MINCNet(), from_jax.minc_state_dict(v))
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == (1, 2, 2, 512)
    _close(got, _apply(m, v, x))


@pytest.mark.parametrize("relative,stride", [(False, 1), (True, 1),
                                             (True, 2), (False, 2)])
def test_augmented_conv_matches_jax(relative, stride):
    m = jax_aa.AugmentedConv(12, dk=8, dv=4, num_heads=2, relative=relative,
                             stride=stride)
    x = _x((2, 6, 8, 5), seed=20)
    v = _variables(m, x, seed=21)
    h, w = -(-6 // stride), -(-8 // stride)
    port = _port(AugmentedConv(5, 12, dk=8, dv=4, num_heads=2,
                               relative=relative, stride=stride,
                               shape=(h, w)),
                 from_jax.augmented_conv_state_dict(v))
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == (2, h, w, 12)
    _close(got, _apply(m, v, x))


def test_augmented_conv_relative_needs_its_shape():
    with pytest.raises(ValueError, match="shape"):
        AugmentedConv(5, 12, relative=True)


def _kernels(seed):
    return _x((3, 11, 11), seed) - 0.3


@pytest.mark.parametrize("name", ["centralized_loss", "boundaries_loss",
                                  "sparsity_loss", "sum_to_one_loss"])
def test_kernel_regularisers_match_jax(name):
    k = _kernels(22)
    want = float(getattr(jax_extra, name)(jnp.asarray(k)))
    got = float(getattr(extra, name)(torch.from_numpy(k)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-7)


def test_downscale_loss_matches_jax():
    sr, lr = _x((2, 16, 12, 3), 23), _x((2, 8, 6, 3), 24)
    want = float(jax_extra.downscale_loss(jnp.asarray(sr), jnp.asarray(lr),
                                          2))
    got = float(extra.downscale_loss(_nchw(sr), _nchw(lr), 2))
    assert got == pytest.approx(want, rel=1e-5)


def test_contrastive_loss_matches_jax():
    a, p, n = (_x((3, 4, 5, 6), s) for s in (25, 26, 27))
    want = float(jax_extra.contrastive_loss(*map(jnp.asarray, (a, p, n))))
    got = float(extra.contrastive_loss(*map(_nchw, (a, p, n))))
    assert got == pytest.approx(want, rel=1e-5)
