"""The port's fused RAB tail (``ops/rab_tail.py``) against the JAX package's
(``sradsgan_tpu/ops/pallas/rab_tail.py``), and the fused generator blocks
against the unfused ones and against JAX.

On the CPU the JAX op runs its jnp formulation (``_forward_jnp``, the
Pallas kernel's reference, as the package's own
``test_fused_rab_tail_matches_unfused`` does) and the port its plain
PyTorch version.  Inputs are drawn with numpy from a seed and handed to
both; the JAX side is NHWC, the port NCHW.  The CLAM's hidden units are
live (|W1| + 0.05), so the MLP's backward is exercised.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.models.sradsgan import RAB as JaxRAB  # noqa: E402
from sradsgan_tpu.models.sradsgan import ResGroup as JaxResGroup  # noqa: E402
from sradsgan_tpu.ops.pallas import rab_tail as jax_rab_tail  # noqa: E402
from sradsgan_tpu_torch.models import create_generator  # noqa: E402
from sradsgan_tpu_torch.models.sradsgan import RAB, ResGroup  # noqa: E402
from sradsgan_tpu_torch.ops import rab_tail  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    _dense_as_conv, _oihw, sradsgan_state_dict)

NAMES = ("out", "gate_c", "gate_s", "mean_u", "max_u", "avg_t", "max_t")
GRADS = ("dt", "dx_res", "dw1", "dw2", "dslam_w", "dfuse_w", "dfuse_b")
FWD_ATOL = 1e-6      # float32, same math in another order of summation
GRAD_TOL = 1e-5      # of max |ref|, per gradient
BF16_TOL = 2e-2      # bf16 inputs: one bf16 ulp of the output's range


def _inputs(shape=(2, 9, 11, 16), seed=0, ties=False):
    """JAX-layout inputs: t, x_res (B, H, W, C), w1 (C, hidden), w2
    (hidden, C), slam_w (7, 7, 2, 1), fuse_w (C, C), fuse_b (C,)."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    hidden = max(c // 16, 1) + 1
    t = rng.normal(0, 1, shape)
    if ties:  # a few integer values: tied maxima over H, W and over C
        t = np.round(1.5 * t)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return tuple(map(f32, (
        t, rng.normal(0, 1, shape),
        np.abs(rng.normal(0, 0.3, (c, hidden))) + 0.05,
        rng.normal(0, 0.3, (hidden, c)) + 0.1,
        rng.normal(0, 0.3, (7, 7, 2, 1)),
        rng.normal(0, 0.5 / np.sqrt(c), (c, c)),
        rng.normal(0, 0.05, (c,)))))


def _to_port(args, dtype=torch.float32):
    """NHWC numpy -> the port's NCHW tensors; the gate kernel HWIO -> OIHW."""
    t, x_res, w1, w2, slam_w, fuse_w, fuse_b = args
    nchw = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)
    return (nchw(t), nchw(x_res), torch.from_numpy(w1), torch.from_numpy(w2),
            torch.from_numpy(np.ascontiguousarray(
                slam_w.transpose(3, 2, 0, 1))),
            torch.from_numpy(fuse_w), torch.from_numpy(fuse_b))


def _port_out_to_jax_layout(name, value):
    value = value.detach().float().numpy()
    return value.transpose(0, 2, 3, 1) if name in ("out", "dt", "dx_res") \
        else (value.transpose(2, 3, 1, 0) if name == "dslam_w" else value)


@pytest.mark.parametrize("name", NAMES)
def test_plain_forward_matches_the_jax_reference(name):
    args = _inputs()
    want = dict(zip(NAMES, jax_rab_tail._forward_jnp(*map(jnp.asarray,
                                                          args))))
    got = dict(zip(NAMES, rab_tail.rab_tail_plain(*_to_port(args))))
    np.testing.assert_allclose(_port_out_to_jax_layout(name, got[name]),
                               np.asarray(want[name]), rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name", GRADS)
def test_backward_matches_jax_grad(name, ties):
    args = _inputs(seed=1, ties=ties)
    a = np.random.default_rng(2).normal(0, 1, args[0].shape).astype(
        np.float32)
    want = jax.grad(
        lambda *p: jnp.sum(jax_rab_tail.fused_rab_tail(*p) * a),
        argnums=tuple(range(7)))(*map(jnp.asarray, args))
    port = [p.requires_grad_() for p in _to_port(args)]
    out = rab_tail.fused_rab_tail(*port)
    got = torch.autograd.grad(
        (out * torch.from_numpy(a.transpose(0, 3, 1, 2))).sum(), port)
    i = GRADS.index(name)
    ref = np.asarray(want[i])
    assert np.abs(ref).max() > 1e-3, "a dead gradient would pass vacuously"
    np.testing.assert_allclose(_port_out_to_jax_layout(name, got[i]), ref,
                               rtol=0, atol=GRAD_TOL * np.abs(ref).max())


def test_tied_maxima_are_present_in_the_tie_case():
    t = _to_port(_inputs(seed=1, ties=True))[0]
    assert ((t == t.amax((2, 3), keepdim=True)).sum((2, 3)) > 1).any()
    assert ((t == t.amax(1, keepdim=True)).sum(1) > 1).any()


def test_bf16_inputs_stay_within_a_bf16_ulp_of_jax():
    args = _inputs(seed=3)
    cast = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = jax_rab_tail._forward_jnp(cast(args[0]), cast(args[1]),
                                     *map(jnp.asarray, args[2:]))
    port = _to_port(args, torch.bfloat16)
    got = rab_tail.rab_tail_plain(*port)
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    for name, g, r in zip(NAMES, got, want):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(
            _port_out_to_jax_layout(name, g), r, rtol=0,
            atol=BF16_TOL * np.abs(r).max(), err_msg=name)
    # the gradient takes bf16 activations and float32 parameters
    leaves = [p.requires_grad_() for p in port]
    grads = torch.autograd.grad(rab_tail.fused_rab_tail(*leaves).sum(),
                                leaves)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 2 + \
        [torch.float32] * 5
    assert all(torch.isfinite(g).all() for g in grads)


def test_second_order_raises():
    port = [p.requires_grad_() for p in _to_port(_inputs(shape=(1, 5, 4,
                                                                16)))]
    # a cotangent that depends on the inputs, as any real second order has
    (dt,) = torch.autograd.grad(
        rab_tail.fused_rab_tail(*port).square().sum(), port[0],
        create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dt.square().sum().backward()


def test_kernel_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        rab_tail.rab_tail_cuda(*_to_port(_inputs()))
    assert rab_tail.rab_tail_cuda.launches == 0


def test_no_grad_forward_equals_the_differentiated_one():
    port = _to_port(_inputs(seed=4))
    with torch.no_grad():
        plain = rab_tail.fused_rab_tail(*port)
    tracked = rab_tail.fused_rab_tail(*[p.requires_grad_() for p in port])
    assert not plain.requires_grad and tracked.requires_grad
    torch.testing.assert_close(plain, tracked.detach(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the generator's blocks
# ---------------------------------------------------------------------------

def _fan_in(model, seed):
    """Conv kernels normal(0, 0.5 / sqrt(fan_in)), biases normal(0, 0.05),
    live CLAM hidden units."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.Conv2d):
                w = torch.randn(m.weight.shape, generator=gen)
                m.weight.copy_(w * 0.5 / m.weight[0].numel() ** 0.5)
                if name.endswith("ca.fc1"):
                    m.weight.copy_(m.weight.abs() + 0.05)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=gen)
                                 * 0.05)
    return model


@pytest.mark.parametrize("block", ["RAB", "ResGroup"])
def test_fused_block_equals_the_unfused_one(block):
    make = {"RAB": lambda mode: RAB(16, mode),
            "ResGroup": lambda mode: ResGroup(16, 2, mode)}[block]
    unfused, fused = _fan_in(make("unfused"), 0), make("fused")
    assert list(fused.state_dict()) == list(unfused.state_dict())
    fused.load_state_dict(unfused.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, 16, 10, 9)).astype(np.float32))
    want, got = unfused(x), fused(x)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=FWD_ATOL)
    g_want = torch.autograd.grad(want.square().sum(),
                                 list(unfused.parameters()))
    g_got = torch.autograd.grad(got.square().sum(), list(fused.parameters()))
    for (name, _), a, b in zip(unfused.named_parameters(), g_want, g_got):
        np.testing.assert_allclose(
            b.numpy(), a.numpy(), rtol=0,
            atol=GRAD_TOL * float(a.abs().max()), err_msg=name)
    assert float(dict(zip(dict(unfused.named_parameters()), g_want))
                 ["ca.fc1.weight"].abs().max()) > 1e-4


def _local_attention_sd(prefix, node):
    gate = node["ChannelGate_0"]
    return {f"{prefix}ca.fc1.weight": _dense_as_conv(
                gate["Dense_0"]["kernel"]),
            f"{prefix}ca.fc2.weight": _dense_as_conv(
                gate["Dense_1"]["kernel"]),
            f"{prefix}sa.conv1.weight": _oihw(
                node["SpatialGate_0"]["Conv_0"]["kernel"]),
            f"{prefix}conv.weight": _oihw(node["Conv_0"]["kernel"]),
            f"{prefix}conv.bias": np.asarray(node["Conv_0"]["bias"])}


def _rab_sd(prefix, node):
    return {f"{prefix}conv1.weight": _oihw(node["Conv_0"]["kernel"]),
            f"{prefix}conv1.bias": np.asarray(node["Conv_0"]["bias"]),
            f"{prefix}conv2.weight": _oihw(node["Conv_1"]["kernel"]),
            f"{prefix}conv2.bias": np.asarray(node["Conv_1"]["bias"]),
            **_local_attention_sd(prefix, node["LocalAttention_0"])}


def _numpy_params(module, x, seed):
    """The module's param tree with numpy fan-in weights, live CLAM units."""
    params = jax.tree.map(np.asarray, module.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [p.key for p in path]
        if keys[-1] == "bias":
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        w = rng.normal(0, 0.5 / np.sqrt(np.prod(leaf.shape[:-1])),
                       leaf.shape).astype(np.float32)
        return np.abs(w) + 0.05 if "Dense_0" in keys else w

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.mark.parametrize("block", ["RAB", "ResGroup"])
def test_fused_block_matches_the_fused_jax_block(block, monkeypatch):
    monkeypatch.setenv("SRADSGAN_TPU_RAB_TAIL", "fused")
    x = np.random.default_rng(6).normal(0, 1, (2, 10, 9, 16)).astype(
        np.float32)
    if block == "RAB":
        jax_block, port = JaxRAB(features=16), RAB(16, "fused")
        params = _numpy_params(jax_block, x, 7)
        sd = _rab_sd("", params)
    else:
        jax_block = JaxResGroup(features=16, n_blocks=2)
        port = ResGroup(16, 2, "fused")
        params = _numpy_params(jax_block, x, 7)
        sd = _local_attention_sd("", params["LocalAttention_0"])
        for i in range(2):
            sd.update(_rab_sd(f"RG.{i}.", params[f"RAB_{i}"]))
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()})
    want = np.asarray(jax_block.apply({"params": params}, jnp.asarray(x)))
    got = port(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               want, rtol=1e-5, atol=3e-6)
    # gradients of a scalar for the tail's own parameters
    g_want = jax.grad(lambda p: jnp.sum(
        jax_block.apply({"params": p}, jnp.asarray(x)) ** 2))(params)
    la = g_want["LocalAttention_0"]
    want_sd = _local_attention_sd("", la)
    got.square().sum().backward()
    for key, ref in want_sd.items():
        np.testing.assert_allclose(
            port.get_parameter(key).grad.numpy(), ref, rtol=0,
            atol=GRAD_TOL * np.abs(ref).max(), err_msg=key)


def test_fused_generator_matches_jax_and_loads_a_jax_tree(monkeypatch):
    """x4 at small widths: a JAX-initialised tree loads into the fused port
    model (same keys as the unfused one), and the fused port generator
    equals the fused JAX one."""
    from test_torch_sradsgan import ATOL, RTOL, jax_generator
    small = dict(n_groups=2, n_blocks=2)
    gen, params = jax_generator(4, 16, **small)
    x = np.random.default_rng(1).random((2, 12, 12, 3)).astype(np.float32)
    monkeypatch.setenv("SRADSGAN_TPU_RAB_TAIL", "fused")
    want = np.asarray(gen.apply({"params": params}, jnp.asarray(x)))
    model = create_generator("sradsgan", 4, base_filters=16,
                             rab_tail="fused", **small)
    model.load_state_dict(sradsgan_state_dict(params))  # strict
    plain = create_generator("sradsgan", 4, base_filters=16, **small)
    plain.load_state_dict(model.state_dict())  # strict: the same tree
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        unfused = plain.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(unfused.numpy(), got.numpy(), rtol=0,
                               atol=FWD_ATOL)


def test_rab_tail_argument_is_checked():
    with pytest.raises(ValueError, match="rab_tail must be one of"):
        create_generator("sradsgan", 4, base_filters=16, n_groups=1,
                         n_blocks=1, rab_tail="yes")
    with pytest.raises(ValueError, match="rab_tail must be one of"):
        RAB(16, rab_tail="yes")
