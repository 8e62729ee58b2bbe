"""The twice-differentiable conv of the patch D (``nn/conv.py``) against
stock ``nn.Conv2d``.

The CPU tests hold :class:`DoubleGradConv2d` to the stock conv in float64
(the WGAN-GP penalty's D gradients, a first-order backward, gradgradcheck),
to autocast's bf16 casts, to the launches stock autograd makes in the
penalty's own pass, and count its second-order weight terms in a trainer's
step.  The card test (marked ``gpu``; it skips where no CUDA device is
present) takes the published CBAM D at the training cell's shapes under
bf16 autocast.  This file imports neither JAX nor the JAX package, so on a
machine without them run it as

    python -m pytest --noconftest -m gpu tests/test_torch_conv.py
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch import nn  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from sradsgan_tpu_torch.losses import gan  # noqa: E402
from sradsgan_tpu_torch.models import config_for_model  # noqa: E402
from sradsgan_tpu_torch.models.discriminators import (  # noqa: E402
    DEFAULT_BLOCKS, PatchDiscriminator)
from sradsgan_tpu_torch.models.ndsrgan import NDSRGAN_D_BLOCKS  # noqa: E402
from sradsgan_tpu_torch.nn.blocks import materialize  # noqa: E402
from sradsgan_tpu_torch.nn.conv import (DoubleGradConv2d,  # noqa: E402
                                        _Conv, _InputGrad)
from sradsgan_tpu_torch.train.trainer import Trainer  # noqa: E402

LAMBDA_GP = 10.0  # the recipe's, backpropagated with weight lambda + 1


def _toy_d(stride, kernel, bias, dtype=torch.float64):
    """Three convs (the first at ``stride``, the second at 2, the logit
    conv 3x3), a BatchNorm and LeakyReLUs, as the patch D stacks them."""
    torch.manual_seed(0)
    pad = (kernel - 1) // 2
    return nn.Sequential(
        DoubleGradConv2d(3, 4, kernel, stride, pad, bias=bias),
        nn.LeakyReLU(0.2),
        DoubleGradConv2d(4, 6, kernel, 2, pad, bias=bias),
        nn.BatchNorm2d(6), nn.LeakyReLU(0.2),
        DoubleGradConv2d(6, 1, 3, 1, 1, bias=bias)).to(dtype)


def _stock(net):
    """A copy of ``net`` whose convs are stock ``nn.Conv2d`` (the same
    parameters and buffers)."""
    net = copy.deepcopy(net)
    for m in net.modules():
        if isinstance(m, DoubleGradConv2d):
            m.__class__ = nn.Conv2d
    return net


def _images(size, dtype=torch.float64, batch=2, seed=1):
    gen = torch.Generator().manual_seed(seed)
    real, fake = torch.rand((2, batch, 3, size, size), generator=gen,
                            dtype=dtype)
    return real, fake, torch.rand((batch, 1, 1, 1), generator=gen,
                                  dtype=dtype)


def _d_objective(net, real, fake, alpha, autocast=False):
    """The D's WGAN-GP objective, as ``Trainer._d_step`` takes it."""
    def d(x):
        with torch.autocast(x.device.type, torch.bfloat16,
                            enabled=autocast):
            return net(x)

    loss = gan.adversarial_loss_d(d(real), d(fake), "wgan-gp")
    return loss + (LAMBDA_GP + 1) * gan.gradient_penalty(d, real, fake,
                                                         alpha)


def _d_grads(net, *args, **kwargs):
    """The D's objective's gradient for every D parameter."""
    return torch.autograd.grad(_d_objective(net, *args, **kwargs),
                               list(net.parameters()))


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-300)


@pytest.mark.parametrize("fake_grad", [False, True],
                         ids=["fake_detached", "fake_with_grad"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("size", [11, 12])
@pytest.mark.parametrize("kernel", [3, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_the_penalty_gradients_match_stock(stride, kernel, size, bias,
                                           fake_grad):
    """float64: the WGAN-GP objective's D gradients through the new convs
    and through stock convs agree to 1e-12; odd and even sizes (stride 2
    maps 11 and 12 alike to 6), kernel 4 (NDSRGAN's), the fake images with
    and without a gradient of their own."""
    net = _toy_d(stride, kernel, bias)
    real, fake, alpha = _images(size)
    fake.requires_grad_(fake_grad)
    got = _d_grads(net, real, fake, alpha)
    want = _d_grads(_stock(net), real, fake, alpha)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12


@pytest.mark.parametrize("via", ["grad", "backward"])
@pytest.mark.parametrize("input_grad", [False, True],
                         ids=["input_detached", "input_with_grad"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("kernel", [3, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_a_first_order_backward_matches_stock(stride, kernel, bias,
                                              input_grad, via):
    """float64: a loss of D's logits differentiated once, for the D's
    parameters and, where it has a gradient (the G step's path through D),
    the input, agrees with stock to 1e-12, through ``torch.autograd.grad``
    and through ``.backward()`` into ``.grad``."""
    net = _toy_d(stride, kernel, bias)
    results = []
    for d in (net, _stock(net)):
        x = _images(11)[0].requires_grad_(input_grad)
        wrt = list(d.parameters()) + ([x] if input_grad else [])
        loss = (d(x) ** 2).sum()
        if via == "grad":
            results.append(torch.autograd.grad(loss, wrt))
        else:
            loss.backward()
            results.append([t.grad for t in wrt])
    for g, w in zip(*results):
        assert _rel(g, w) <= 1e-12


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
def test_the_second_derivatives_pass_gradgradcheck(stride, size):
    """Every second derivative of the conv, with respect to the input,
    weight, bias and the output gradient, against finite differences: the
    differentiated weight gradient (``_WeightGrad``) included."""
    gen = torch.Generator().manual_seed(2)
    x, w, b = (torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for shape in ((2, 2, size, size), (3, 2, 3, 3), (3,)))
    assert torch.autograd.gradgradcheck(
        lambda x, w, b: _Conv.apply(x, w, b, (stride, stride), (1, 1)),
        (x, w, b))


class _Launches(TorchDispatchMode):
    """The convolutions dispatched, with ``convolution_backward``'s output
    mask (which of dgrad, wgrad and the bias gradient it takes)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution_backward.default:
            self.calls.append(("backward", tuple(args[-1])))
        elif func is torch.ops.aten.convolution.default:
            self.calls.append(("forward", tuple(args[1].shape)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_the_penalty_pass_launches_what_stock_launches(bias):
    """The penalty's own pass (the input gradient, with its graph) takes
    dgrad alone at each conv, as stock autograd does: no weight gradient
    the pass does not reach."""
    net = _toy_d(2, 3, bias)
    real, fake, alpha = _images(11)
    calls = []
    for d in (net, _stock(net)):
        with _Launches() as launches:
            gan.gradient_penalty(d, real, fake, alpha)
        calls.append(launches.calls)
    assert calls[0] == calls[1]
    assert calls[0].count(("backward", (True, False, False))) == 3


@pytest.mark.parametrize("input_grad", [False, True],
                         ids=["input_detached", "input_with_grad"])
def test_autocast_casts_as_it_casts_a_conv(input_grad):
    """Under the CPU's bf16 autocast the forward is stock's, bit for bit,
    in bf16, and the first-order gradients (float32 parameters, float32
    input) are stock's."""
    conv = DoubleGradConv2d(3, 8, 3, 2, 1)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.2, generator=torch.Generator()
                            .manual_seed(3))
    x = _images(9, torch.float32)[0].requires_grad_(input_grad)
    results = []
    for m in (conv, _stock(conv)):
        with torch.autocast("cpu", torch.bfloat16):
            y = m(x)
        wrt = [m.weight, m.bias] + ([x] if input_grad else [])
        results.append((y, torch.autograd.grad(y.float().square().sum(),
                                               wrt)))
    (y, got), (y_stock, want) = results
    assert y.dtype == torch.bfloat16 and torch.equal(y, y_stock)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert torch.equal(g, w)


def test_autocast_leaves_float64_alone():
    """As autocast leaves a float64 conv in float64, so does this one."""
    conv = DoubleGradConv2d(3, 4, 3, padding=1).double()
    x = _images(6)[0]
    with torch.autocast("cpu", torch.bfloat16):
        y = conv(x)
    assert y.dtype == torch.float64
    assert torch.equal(y, _stock(conv)(x))


@pytest.mark.parametrize("blocks, kernel", [
    (DEFAULT_BLOCKS, 3), (NDSRGAN_D_BLOCKS, 4)], ids=["published", "ndsrgan"])
def test_the_patch_d_builds_every_conv_so(blocks, kernel):
    """The patch D's block convs and its logit conv (nine in the published
    D) are the new conv, under ``nn.Conv2d``'s parameter names and init
    draws; the gates' convs (CLAM's two 1x1, the 7x7 kernel SLAM's spatial
    gate reads) stay stock."""
    d = PatchDiscriminator(blocks, kernel_size=kernel, seed=5)
    convs = [m for m in d.model if isinstance(m, DoubleGradConv2d)]
    assert len(convs) == len(blocks) + 1
    assert [m.kernel_size for m in convs] == [(kernel, kernel)] * len(
        blocks) + [(3, 3)]
    stock = _stock(d)
    assert list(d.state_dict()) == list(stock.state_dict())
    # stock convs in the same places draw the same init from the seed
    with torch.no_grad():
        for p in stock.parameters():
            p.zero_()
    materialize(stock, 5)
    for (name, p), q in zip(d.named_parameters(), stock.parameters()):
        assert torch.equal(p, q), name
    gates = [m for m in d.modules() if type(m) is nn.Conv2d]
    assert {m.kernel_size for m in gates} <= {(1, 1), (7, 7)}


def test_other_convs_are_refused():
    with pytest.raises(ValueError):
        DoubleGradConv2d(3, 4, 3, padding="same")


# small widths of each kind of step: WGAN-GP with the CBAM D and with the
# plain D, lsgan with 3x3 and 4x4 Ds, the pixel loss alone
STEP_MODELS = {
    "sradsgan": (dict(base_filters=16, n_groups=1, n_blocks=1), 9),
    "drcan": (dict(n_feats=8, n_resgroups=1, n_resblocks=1), 9),
    "srgan": (dict(base_filters=8, num_residuals=1), 0),
    "ndsrgan": (dict(nf=8, nc=4, n_dcrdb=1), 0),
    "edsr": (dict(base_filters=8, num_residuals=1), 0)}


@pytest.mark.parametrize("model", list(STEP_MODELS))
def test_a_step_counts_its_second_order_weight_terms(tmp_path, model):
    """An eager step on the CPU takes one second-order weight term a conv
    of the patch D where the recipe is WGAN-GP, none otherwise (the VGG
    content term, which the count does not see, left out)."""
    kwargs, terms = STEP_MODELS[model]
    cfg = config_for_model(model, 2, bf16=False, model_kwargs=kwargs,
                           save_dir=str(tmp_path),
                           **{"gan.weight_content": 0.0})
    trainer = Trainer(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"lr": rng.random((2, 8, 8, 3), dtype=np.float32),
             "hr": rng.random((2, 16, 16, 3), dtype=np.float32)}
    for step in range(2):
        before = _InputGrad.weight_terms
        trainer.train_step(batch)
        assert _InputGrad.weight_terms - before == terms, step


# --- the card -------------------------------------------------------------

# The card test's bound on a D leaf's gap to stock, max|difference| over
# max|stock| of the leaf: both sides round the same sums to bf16 (unit
# roundoff 2^-8 = 3.9e-3) in another order, and the adversarial and penalty
# terms partly cancel in a leaf's sum.
CARD_GAP = 2e-2


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the recipe's precision: bf16 convs under autocast, TF32 off
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _legacy_filters(net, real, fake, alpha):
    """The D's objective's gradient, its backward run under
    ``torch.profiler``, and the filter shape of each convolution in that
    backward that launched a legacy ``*_convolve_sgemm`` kernel."""
    from torch.profiler import ProfilerActivity, profile

    objective = _d_objective(net, real, fake, alpha, autocast=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        grads = torch.autograd.grad(objective, list(net.parameters()))
        torch.cuda.synchronize()
    filters = []
    for e in prof.events():
        if not any("convolve_sgemm" in k.name for k in e.kernels):
            continue
        op = e
        while op is not None and op.name not in (
                "aten::convolution", "aten::convolution_backward"):
            op = op.cpu_parent
        filters.append(None if op is None else tuple(op.input_shapes[1]))
    return grads, filters


@pytest.mark.gpu
def test_the_published_d_penalty_on_the_card(cuda):
    """The published CBAM D at the training cell's shapes, (16, 3, 216,
    216) under bf16 autocast.  The WGAN-GP objective's D gradients match the
    stock formula's within ``CARD_GAP`` a leaf (the biases zero by the
    math, before a BatchNorm, left out).  In the D's backward no legacy
    ``*_convolve_sgemm`` kernel runs a convolution whose filter is a
    gradient map, as stock's second-order terms do: the few left are the
    forward convs of the D's own 3x3 and 7x7 kernels (block 1's three input
    channels, SLAM's two planes), which cuDNN runs so in the forward too."""
    d = PatchDiscriminator(seed=0, device=cuda).train()
    stock = _stock(d)
    real, fake, alpha = (t.to(cuda) for t in _images(216, torch.float32,
                                                     batch=16))
    want, stock_filters = _legacy_filters(stock, real, fake, alpha)
    got, filters = _legacy_filters(d, real, fake, alpha)
    assert any(f is not None and min(f[2:]) > 7 for f in stock_filters)
    assert all(f is not None and max(f[2:]) <= 7 for f in filters), filters
    names = [n for n, _ in d.named_parameters()]
    layers = list(d.model)
    before_bn = {f"model.{i}.bias" for i, (m, nxt) in enumerate(
        zip(layers, layers[1:])) if isinstance(m, nn.Conv2d)
        and isinstance(nxt, nn.BatchNorm2d)}
    gaps = {n: _rel(g, w) for n, g, w in zip(names, got, want)
            if n not in before_bn}
    assert max(gaps.values()) <= CARD_GAP, gaps


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["sradsgan", "srgan"])
def test_a_graphed_step_counts_when_eager_or_captured(cuda, tmp_path,
                                                      model):
    """On the card the first step runs eagerly, the second is captured and
    the third replayed: nine terms for each of the first two of a WGAN-GP
    step, none for the replay (it runs no Python); none for lsgan."""
    kwargs, terms = STEP_MODELS[model]
    cfg = config_for_model(model, 2, bf16=True, model_kwargs=kwargs,
                           save_dir=str(tmp_path))
    trainer = Trainer(cfg, device=cuda)
    rng = np.random.default_rng(0)
    batch = {"lr": rng.random((4, 16, 16, 3), dtype=np.float32),
             "hr": rng.random((4, 32, 32, 3), dtype=np.float32)}
    counts = []
    for _ in range(3):
        before = _InputGrad.weight_terms
        trainer.train_step(batch)
        counts.append(_InputGrad.weight_terms - before)
    assert trainer.graph_stats == {"eager": 1, "captured": 1, "replayed": 1}
    assert counts == [terms, terms, 0]
