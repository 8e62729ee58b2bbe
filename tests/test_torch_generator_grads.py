"""The port's SRADSGAN generator against the JAX package's: parameter and
input gradients in float32, and forwards at x8 and x9.

The gradient runs through every kernel op of the generator (48 CLAM pools
and SLAM gates at full depth, here 2 groups x 2 RABs; the SGAM attention
with both gains non-zero) and its plain backward.  Weights come over the
bridge (``tools/from_jax.py``), which maps a gradient tree the same way as
a param tree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu_torch.tools.from_jax import sradsgan_state_dict  # noqa
from test_torch_sradsgan import (  # noqa: E402
    ATOL, RTOL, SMALL, jax_generator, port_generator)

GRAD_ATOL = 3e-5  # float32, of max|grad| of each tensor


@pytest.mark.parametrize("scale,base_filters", [(4, 16), (2, 64)])
def test_generator_grads_match_jax(scale, base_filters):
    gen, params = jax_generator(scale, base_filters, **SMALL)
    rng = np.random.default_rng(2)
    x = rng.random((2, 12, 12, 3)).astype(np.float32)
    r = rng.normal(0, 1, (2, 12 * scale, 12 * scale, 3)).astype(np.float32)

    def loss(params, x):
        return jnp.mean(gen.apply({"params": params}, x) * r)

    dp, dx_want = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    want = sradsgan_state_dict(jax.tree.map(np.asarray, dp))

    model = port_generator(scale, base_filters, params, **SMALL)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    out = model(tx)
    tr = torch.from_numpy(r.transpose(0, 3, 1, 2).copy())
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad((out * tr).mean(), (tx,) + tensors)
    np.testing.assert_allclose(grads[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(dx_want), rtol=1e-4,
                               atol=GRAD_ATOL * np.abs(dx_want).max())
    assert set(names) == set(want)
    # A tensor's bar scales with its own largest gradient, floored at 1e-4
    # of the largest of all: the key conv's bias has a gradient of exactly
    # zero (a per-row shift of the energies), which both sides round to
    # about 1e-12.
    floor = 1e-4 * max(float(w.abs().max()) for w in want.values())
    for name, g in zip(names, grads[1:]):
        w = want[name].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4,
            atol=GRAD_ATOL * max(np.abs(w).max(), floor), err_msg=name)
    # the attention and the deepest gate carry gradient
    for name in ("GAB_UP.sa.query_conv.weight",
                 "res_groups.1.RG.1.sa.conv1.weight"):
        assert np.abs(want[name].numpy()).max() > 0, name


@pytest.mark.parametrize("scale", [8, 9])
def test_generator_matches_jax_at_x8_and_x9(scale):
    gen, params = jax_generator(scale, 16, lr=8, **SMALL)
    x = np.random.default_rng(1).random((1, 8, 8, 3)).astype(np.float32)
    want = np.asarray(gen.apply({"params": params}, jnp.asarray(x)))
    model = port_generator(scale, 16, params, **SMALL)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 8 * scale, 8 * scale, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(want).max() > 0.1
