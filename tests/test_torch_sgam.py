"""The port's SGAM (position self-attention) against the JAX package's.

The TPU flash kernel has no interpret mode; its plain reference is the JAX
package's exact-f32 softmax path, which the port's module is held against
here with a non-zero ``gamma`` (at its zero init the attention would add
nothing).  ``position_attention`` itself is checked against the unscaled
softmax(q k^T) v computed in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.nn.attention import (  # noqa: E402
    SpatialSelfAttention as JaxSGAM)
from sradsgan_tpu_torch.nn.attention import SpatialSelfAttention  # noqa
from sradsgan_tpu_torch.ops import sgam_flash  # noqa: E402
from sradsgan_tpu_torch.ops.sgam_flash import position_attention  # noqa


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(k).transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("hw", [(6, 6), (5, 7)])
def test_sgam_module_matches_jax_f32_path(hw):
    b, c = 2, 16
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (b, *hw, c)).astype(np.float32)
    jm = JaxSGAM()
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x))["params"])
    params = {name: ({"kernel": rng.normal(0, 0.3, p["kernel"].shape)
                      .astype(np.float32),
                      "bias": rng.normal(0, 0.1, p["bias"].shape)
                      .astype(np.float32)} if name != "gamma" else
                     np.array([0.7], np.float32))
              for name, p in params.items()}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))

    port = SpatialSelfAttention(c)
    sd = {"gamma": torch.tensor([0.7])}
    for i, name in enumerate(("query_conv", "key_conv", "value_conv")):
        sd[f"{name}.weight"] = _oihw(params[f"Conv_{i}"]["kernel"])
        sd[f"{name}.bias"] = torch.from_numpy(params[f"Conv_{i}"]["bias"])
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-6)
    # the attention term matters at this gamma
    assert np.abs(want - x).max() > 1e-2


@pytest.mark.parametrize("n", [144, 729])
def test_position_attention_is_unscaled_softmax(n):
    rng = np.random.default_rng(n)
    # energies of a few units, as SGAM's are; float32 rounds an energy e to
    # about 6e-8 * |e|, which the tolerance below has to cover
    q = rng.normal(0, 0.5, (2, n, 8)).astype(np.float32)
    k = rng.normal(0, 0.5, (2, n, 8)).astype(np.float32)
    v = rng.normal(0, 1, (2, n, 64)).astype(np.float32)
    e = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k)
    p = np.exp(e - e.max(-1, keepdims=True))
    want = np.einsum("bqk,bkc->bqc", p / p.sum(-1, keepdims=True), v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = position_attention(tq, tk, tv)
    assert got.dtype == torch.float32 and got.shape == (2, n, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # cross-check of the semantics (scale=1, not 1/sqrt(d)) against torch's
    # own attention, whose CPU kernel sums in another order: hence 1e-4
    sdpa = torch.nn.functional.scaled_dot_product_attention(tq, tk, tv,
                                                            scale=1.0)
    np.testing.assert_allclose(sdpa.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,chunk", [(50, 16), (129, 64), (40, 2048)])
def test_chunked_forward_and_delta_backward_equal_the_plain_versions(n,
                                                                     chunk):
    """What the card's checks lean on: the plain forward taken by blocks of
    queries (the reference of the long-sequence case) and the backward
    written with delta_i = dO_i . O_i (the formulas the backward kernels
    evaluate) equal the plain version and its autograd."""
    rng = np.random.default_rng(n)
    q, k = (torch.from_numpy(rng.normal(0, 0.5, (2, n, 8))
                             .astype(np.float32)) for _ in range(2))
    v, dout = (torch.from_numpy(rng.normal(0, 1, (2, n, 64))
                                .astype(np.float32)) for _ in range(2))
    out = sgam_flash.position_attention_plain(q, k, v)
    chunked = sgam_flash.position_attention_plain_chunked(q, k, v, chunk)
    assert chunked.shape == out.shape
    assert (chunked - out).abs().max() <= 1e-6 * out.abs().max()
    delta = sgam_flash.attention_delta_plain(out, dout)
    assert delta.shape == (2, n) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), (dout * out).sum(-1).numpy(),
                               rtol=1e-6, atol=1e-6)
    got = sgam_flash.position_attention_bwd_from_delta(q, k, v, out, dout)
    want = sgam_flash.position_attention_bwd_plain(q, k, v, dout)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-6 * max(float(w.abs().max()), 1.0)
