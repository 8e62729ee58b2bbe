"""Gradients of the port's kernel ops against the JAX package's custom VJPs.

On the CPU each op's ``autograd.Function`` runs its plain PyTorch versions:
the pool's backward (``avg_max_pool_bwd_plain``), the gate's backward
(``spatial_gate_bwd_plain``, the plain twin of the K4 kernel) and its own
grad-of-grad, and the attention's autograd.  They are held against:

- ``fused_avg_max_pool``'s VJP (``ops/pallas/pooling.py``);
- ``fused_spatial_gate``'s VJP (the default formulation) and the Pallas
  backward kernel ``slam._bwd_pallas`` in interpret mode, whose ds / mean /
  max planes give dw through ``slam._dw_contraction``;
- ``jax.grad`` of a ``jax.grad`` through the CLAM and SLAM modules, the
  WGAN-GP's second-order path through the discriminator's CBAM;
- the JAX SGAM module's exact float32 path, with ``gamma`` non-zero.

Inputs are drawn with numpy; ``TIES`` inputs take a few integer values, so
most channel and spatial maxima are tied.  float32 throughout: the
tolerances cover summation order (a few ulp of the largest term).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.nn.attention import ChannelGate as JaxChannelGate  # noqa
from sradsgan_tpu.nn.attention import SpatialGate as JaxSpatialGate  # noqa
from sradsgan_tpu.nn.attention import (  # noqa: E402
    SpatialSelfAttention as JaxSGAM)
from sradsgan_tpu.ops.pallas import pooling as jax_pooling  # noqa: E402
from sradsgan_tpu.ops.pallas import slam  # noqa: E402
from sradsgan_tpu_torch.nn.attention import (  # noqa: E402
    ChannelGate, SpatialGate, SpatialSelfAttention)
from sradsgan_tpu_torch.ops import pooling, sgam_flash  # noqa: E402
from sradsgan_tpu_torch.ops import spatial_gate as sg  # noqa: E402

SHAPES = [(2, 16, 9, 11), (3, 64, 6, 6)]  # NCHW
KINDS = ["normal", "ties"]


def _x(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(-2, 3, shape).astype(np.float32)
    return rng.normal(0, 1, shape).astype(np.float32)


def _nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# --- pool ------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_pool_grad_matches_jax_vjp(shape, kind):
    x = _x(shape, kind)
    rng = np.random.default_rng(1)
    davg, dmax = (rng.normal(0, 1, shape[:2]).astype(np.float32)
                  for _ in range(2))
    _, vjp = jax.vjp(jax_pooling.fused_avg_max_pool, _nhwc(x))
    (want,) = vjp((jnp.asarray(davg), jnp.asarray(dmax)))

    tx = _t(x, grad=True)
    avg, mx = pooling.avg_max_pool(tx)
    (got,) = torch.autograd.grad((avg, mx), tx, (_t(davg), _t(dmax)))
    _close(got, _nchw(want))
    if kind == "ties":  # the max cotangent is split over tied maxima
        assert (got.numpy() != 0).sum() > shape[0] * shape[1]


# --- gate: first order -------------------------------------------------------

def _gate_inputs(shape, kind, seed=0):
    x = _x(shape, kind, seed)
    rng = np.random.default_rng(seed + 10)
    w = rng.normal(0, 0.3, (7, 7, 2, 1)).astype(np.float32)  # HWIO
    g = rng.normal(0, 1, shape).astype(np.float32)
    return x, w, g


def _oihw(w_hwio):
    return np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))


def _port_gate_grads(x, w, g):
    tx, tw = _t(x, grad=True), _t(_oihw(w), grad=True)
    out = sg.spatial_gate(tx, tw)
    return torch.autograd.grad(out, (tx, tw), _t(g))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gate_grad_matches_fused_spatial_gate_vjp(shape, kind):
    x, w, g = _gate_inputs(shape, kind)
    _, vjp = jax.vjp(slam.fused_spatial_gate, _nhwc(x), jnp.asarray(w))
    dx_want, dw_want = vjp(_nhwc(g))
    dx, dw = _port_gate_grads(x, w, g)
    _close(dx, _nchw(dx_want))
    _close(dw, np.asarray(dw_want).transpose(3, 2, 0, 1), rtol=1e-4,
           atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gate_grad_matches_pallas_bwd_kernel_interpret(shape, kind,
                                                       monkeypatch):
    monkeypatch.setenv("SRADSGAN_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("SRADSGAN_TPU_SLAM_IMPL", "pallas")
    x, w, g = _gate_inputs(shape, kind, seed=3)
    dx_want, ds, mean, mx = slam._bwd_pallas(_nhwc(x), _nhwc(g),
                                             jnp.asarray(w))
    dw_want = slam._dw_contraction(ds, mean, mx, 7, 3, shape[2], shape[3],
                                   jnp.float32)
    dx, dw = _port_gate_grads(x, w, g)
    _close(dx, _nchw(dx_want))
    _close(dw, np.asarray(dw_want).transpose(3, 2, 0, 1), rtol=1e-4,
           atol=1e-5)
    # the plain backward's own planes agree with the kernel's
    dsp, meanp, mxp = (np.asarray(a) for a in (ds, mean, mx))
    _close(_t(x).mean(1), meanp)
    _close(_t(x).amax(1), mxp, rtol=0, atol=0)
    assert np.abs(dsp).max() > 0


# --- gate and CLAM: second order (the WGAN-GP path) ------------------------

def _jax_second_order(module, params, x, a):
    """Gradient of sum(d/dx[sum(module(x) * a)]^2) for params, x and a."""
    def penalty(params, x, a):
        gx = jax.grad(lambda x: jnp.sum(module.apply(
            {"params": params}, x) * a))(x)
        return jnp.sum(gx * gx)

    return jax.grad(penalty, argnums=(0, 1, 2))(params, x, a)


def _torch_second_order(module, x, a):
    tx, ta = _t(x, grad=True), _t(a, grad=True)
    (gx,) = torch.autograd.grad((module(tx) * ta).sum(), tx,
                                create_graph=True)
    params = list(module.parameters())
    return torch.autograd.grad((gx * gx).sum(), params + [tx, ta])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gate_second_order_matches_jax_grad_of_grad(shape, kind):
    x, w, _ = _gate_inputs(shape, kind, seed=5)
    a = np.random.default_rng(6).normal(0, 1, shape).astype(np.float32)
    module = JaxSpatialGate()
    params = {"Conv_0": {"kernel": jnp.asarray(w)}}
    dp, dx_want, da_want = _jax_second_order(module, params, _nhwc(x),
                                             _nhwc(a))
    port = SpatialGate()
    port.conv1.weight.data.copy_(_t(_oihw(w)))
    dw, dx, da = _torch_second_order(port, x, a)
    _close(dx, _nchw(dx_want), rtol=1e-4, atol=1e-5)
    _close(da, _nchw(da_want), rtol=1e-4, atol=1e-5)
    _close(dw, np.asarray(dp["Conv_0"]["kernel"]).transpose(3, 2, 0, 1),
           rtol=1e-4, atol=1e-4)
    assert np.abs(dw.numpy()).max() > 1e-3  # the second-order term is live


@pytest.mark.parametrize("kind", KINDS)
def test_clam_second_order_matches_jax_grad_of_grad(kind):
    shape = (2, 32, 5, 5)
    x = _x(shape, kind, seed=7)
    rng = np.random.default_rng(8)
    a = rng.normal(0, 1, shape).astype(np.float32)
    w1 = rng.normal(0, 0.5, (32, 2)).astype(np.float32)  # Dense (in, out)
    w2 = rng.normal(0, 0.5, (2, 32)).astype(np.float32)
    module = JaxChannelGate(ratio=16)
    params = {"Dense_0": {"kernel": jnp.asarray(w1)},
              "Dense_1": {"kernel": jnp.asarray(w2)}}
    dp, dx_want, da_want = _jax_second_order(module, params, _nhwc(x),
                                             _nhwc(a))
    port = ChannelGate(32)
    port.fc1.weight.data.copy_(_t(w1.T[:, :, None, None]))
    port.fc2.weight.data.copy_(_t(w2.T[:, :, None, None]))
    d1, d2, dx, da = _torch_second_order(port, x, a)
    _close(dx, _nchw(dx_want), rtol=1e-4, atol=1e-5)
    _close(da, _nchw(da_want), rtol=1e-4, atol=1e-5)
    _close(d1[:, :, 0, 0].T, np.asarray(dp["Dense_0"]["kernel"]),
           rtol=1e-4, atol=1e-5)
    _close(d2[:, :, 0, 0].T, np.asarray(dp["Dense_1"]["kernel"]),
           rtol=1e-4, atol=1e-5)


def test_gate_third_order_is_refused():
    """The grad-of-grad is plain and first order only: a third derivative
    raises rather than come back silently zero."""
    x, w, g = _gate_inputs((1, 4, 5, 5), "normal")
    tx, tw = _t(x, grad=True), _t(_oihw(w), grad=True)
    (gx,) = torch.autograd.grad(sg.spatial_gate(tx, tw).sum(), tx,
                                create_graph=True)
    (ggx,) = torch.autograd.grad((gx * gx).sum(), tx, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(ggx.sum(), tx)


# --- attention -------------------------------------------------------------

@pytest.mark.parametrize("hw", [(6, 6), (5, 7)])
def test_sgam_grads_match_jax_f32_path(hw):
    b, c = 2, 16
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (b, *hw, c)).astype(np.float32)
    r = rng.normal(0, 1, (b, *hw, c)).astype(np.float32)
    jm = JaxSGAM()
    shapes = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {name: (np.array([0.7], np.float32) if name == "gamma" else
                     {"kernel": rng.normal(0, 0.3, p["kernel"].shape)
                      .astype(np.float32),
                      "bias": rng.normal(0, 0.1, p["bias"].shape)
                      .astype(np.float32)})
              for name, p in shapes.items()}

    def loss(params, x):
        return jnp.sum(jm.apply({"params": params}, x) * r)

    dp, dx_want = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    port = SpatialSelfAttention(c)
    sd = {"gamma": torch.tensor([0.7])}
    for i, name in enumerate(("query_conv", "key_conv", "value_conv")):
        sd[f"{name}.weight"] = _t(_oihw(params[f"Conv_{i}"]["kernel"]))
        sd[f"{name}.bias"] = _t(params[f"Conv_{i}"]["bias"])
    port.load_state_dict(sd)
    tx = _t(x.transpose(0, 3, 1, 2), grad=True)
    out = port(tx)
    grads = torch.autograd.grad((out * _t(r.transpose(0, 3, 1, 2))).sum(),
                                [tx] + [p for _, p in
                                        port.named_parameters()])
    names = [n for n, _ in port.named_parameters()]
    got = dict(zip(names, grads[1:]))
    _close(grads[0], _nchw(dx_want), rtol=1e-4, atol=1e-5)
    _close(got["gamma"], np.asarray(dp["gamma"]), rtol=1e-4, atol=1e-5)
    for i, name in enumerate(("query_conv", "key_conv", "value_conv")):
        want = np.asarray(dp[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1)
        _close(got[f"{name}.weight"], want, rtol=1e-4, atol=1e-5)
        _close(got[f"{name}.bias"], np.asarray(dp[f"Conv_{i}"]["bias"]),
               rtol=1e-4, atol=1e-5)
    assert np.abs(got["query_conv.weight"].numpy()).max() > 1e-3


@pytest.mark.parametrize("n", [31, 144])
def test_position_attention_bwd_plain_matches_float64(n):
    """The backward's plain twin is the unscaled softmax's exact gradient."""
    rng = np.random.default_rng(n)
    q, k = (rng.normal(0, 0.5, (2, n, 8)).astype(np.float32)
            for _ in range(2))
    v, dout = (rng.normal(0, 1, (2, n, 64)).astype(np.float32)
               for _ in range(2))
    got = sgam_flash.position_attention_bwd_plain(*map(_t, (q, k, v, dout)))
    q64, k64, v64, d64 = (_t(a).double().requires_grad_()
                          for a in (q, k, v, dout))
    p = torch.softmax(q64 @ k64.transpose(1, 2), dim=-1)
    want = torch.autograd.grad(p @ v64, (q64, k64, v64), d64)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w.numpy(), rtol=1e-5, atol=1e-5)
