"""The port's HAT against the JAX package's, through the weight bridge
(``sradsgan_tpu_torch/tools/from_jax.py:hat_state_dict``).

Tiny widths and depths (embed 12, two heads, one group of two HABs), weights
drawn with numpy at fan-in scale so that activations are of order one, the
bias tables at unit scale so that they move the softmax:

- the forward within 1e-5 of max|ref| at x2 on a 10x13 input with a window
  of 4 (reflect padding to 12x16, the shifted HABs' roll and mask, a
  cropped output), at x3 with the default window of 8 for 3^n scales (the
  input padded from 10x13 to 16x16) and at x4 with the default 9;
- the gradients of an L1 loss within 3e-5 of max|ref| per tensor;
- ``rpi_sa``, ``rpi_oca`` and ``sw_attn_mask`` equal to JAX's;
- the seeded init's names and shapes equal to the bridge's, and the bridge
  round trip through the reference reader ``import_reference.import_hat``;
- the GELU: JAX's is Flax's tanh approximation, and the port with the exact
  GELU swapped in lies more than 1e-5 of max|ref| from JAX at these
  weights, so the choice shows.

A window never shrinks inside HAT (the input is padded to a window
multiple, so every HAB sees at least one whole window); the rule that a
shrunken window takes no shift is the HAB's own.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from sradsgan_tpu.models import hat as jax_hat  # noqa: E402
from sradsgan_tpu.tools import import_reference as ir  # noqa: E402
from sradsgan_tpu_torch import models  # noqa: E402
from sradsgan_tpu_torch.models import hat  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import hat_state_dict  # noqa: E402

TINY = dict(embed_dim=12, depths=(2,), num_heads=(2,))
# scale: (extra constructor arguments, LR input size)
CASES = {2: (dict(window_size=4), (10, 13)), 3: ({}, (10, 13)),
         4: ({}, (10, 13))}
FWD_BAR, GRAD_BAR = 1e-5, 3e-5


def random_params(params, seed):
    """Same tree, numpy leaves: kernels normal(0, 1 / sqrt(fan_in)), biases
    normal(0, 0.05), LayerNorm scales uniform(0.5, 1.5), bias tables
    normal(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "bias":
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "relative_position_bias_table":
            return rng.normal(0, 1.0, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, 1 / np.sqrt(fan_in),
                          leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def jax_model(scale, seed=0):
    """The JAX HAT and its random params (shapes from ``eval_shape``: no
    init is compiled)."""
    extra, (h, w) = CASES[scale]
    gen = jax_hat.HAT(scale=scale, **TINY, **extra)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, h, w, 3)))["params"]
    return gen, random_params(shapes, seed + scale)


@functools.lru_cache(maxsize=None)
def jax_forward(scale):
    """(params, the JAX output on :func:`_input`), once a worker."""
    gen, params = jax_model(scale)
    x = _input(scale)
    return params, np.asarray(jax.jit(gen.apply)({"params": params},
                                                 jnp.asarray(x)))


def port_model(scale, params):
    extra, _ = CASES[scale]
    model = models.create_generator("hat", scale, **TINY, **extra)
    model.load_state_dict(hat_state_dict(params))
    return model.eval()


def _input(scale, batch=2, seed=1):
    _, (h, w) = CASES[scale]
    return np.random.default_rng(seed).random((batch, h, w, 3),
                                              dtype=np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_forward(model, x):
    with torch.no_grad():
        return model(_nchw(x)).numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("scale", sorted(CASES))
def test_forward_matches_jax(scale):
    params, want = jax_forward(scale)
    got = _port_forward(port_model(scale, params), _input(scale))
    _, (h, w) = CASES[scale]
    assert got.shape == want.shape == (2, h * scale, w * scale, 3)
    err = np.abs(got - want).max()
    assert err <= FWD_BAR * np.abs(want).max(), err


def test_gradients_match_jax():
    scale = 2
    gen, params = jax_model(scale)
    x = _input(scale)
    target = np.random.default_rng(2).random(
        (2, x.shape[1] * scale, x.shape[2] * scale, 3), dtype=np.float32)

    def loss(p):
        return jnp.mean(jnp.abs(gen.apply({"params": p}, jnp.asarray(x))
                                - target))

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(
        jax.tree.map(jnp.asarray, params))
    want = hat_state_dict(jax.tree.map(np.asarray, grads))

    model = port_model(scale, params)
    out = model(_nchw(x))
    got_loss = (out - _nchw(target)).abs().mean()
    got_loss.backward()
    assert float(got_loss.detach()) == pytest.approx(float(want_loss),
                                                     rel=1e-6)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, ref in want.items():
        err = (got[name].grad - ref).abs().max()
        assert err <= GRAD_BAR * ref.abs().max(), (name, float(err))


@pytest.mark.parametrize("window", [4, 8, 9])
def test_index_tables_and_mask_match_jax(window):
    np.testing.assert_array_equal(hat.rpi_sa(window),
                                  jax_hat.rpi_sa(window))
    np.testing.assert_array_equal(hat.rpi_oca(window, 0.5),
                                  jax_hat.rpi_oca(window, 0.5))
    for h, w in ((2 * window, 3 * window), (window, window)):
        np.testing.assert_array_equal(
            hat.sw_attn_mask(h, w, window, window // 2),
            jax_hat.sw_attn_mask(h, w, window, window // 2))


def test_seeded_init_has_the_bridges_names_and_the_jax_init():
    """Names and shapes of a seeded HAT are the bridge's from a JAX init;
    dense kernels and both bias tables are cut at two standard deviations
    of 0.02, LayerNorms one and zero, biases zero; the state dict goes
    through the reference reader back to the JAX tree (whose names and
    shapes are a JAX init's)."""
    _, params = jax_model(2)
    bridged = hat_state_dict(params)
    model = models.create_generator("hat", 2, **TINY, window_size=4, seed=3)
    own = model.state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in bridged.items()}
    for name, value in own.items():
        leaf = name.rpartition(".")[2]
        if leaf == "relative_position_bias_table" or (
                name.endswith("weight") and value.dim() == 2):
            assert value.abs().max() <= 0.04 and value.std() > 0.01, name
        elif ".norm" in f".{name}" and leaf == "weight":
            assert torch.equal(value, torch.ones_like(value)), name
        elif leaf == "bias":
            assert torch.equal(value, torch.zeros_like(value)), name
    back = ir.import_hat({k: v.numpy() for k, v in bridged.items()},
                         params, depths=TINY["depths"], scale=2)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_tanh_gelu_is_what_jax_runs(monkeypatch):
    """The port with the exact GELU lies more than the bar from JAX, so
    the tanh approximation is what holds it within the bar (its size at
    these weights: the first float printed by ``-s``)."""
    scale = 2
    params, want = jax_forward(scale)
    model = port_model(scale, params)
    monkeypatch.setattr(hat, "gelu", F.gelu)
    gap = (np.abs(_port_forward(model, _input(scale)) - want).max()
           / np.abs(want).max())
    print(f"exact GELU against JAX's tanh GELU: {gap:.3e} of max|ref|")
    assert gap > FWD_BAR
