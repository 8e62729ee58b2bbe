"""The port's fidelity metrics against the JAX package's, on seeded images:
the host tier (numpy, protocol-exact) and the batched tier (NCHW tensors in
the port, NHWC arrays in JAX)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.metrics import fidelity as jax_fidelity  # noqa: E402
from sradsgan_tpu_torch.metrics import fidelity  # noqa: E402

TOL = 1e-5  # relative: float32 sums in another order (batched tier)


def _pair(seed, shape=(3, 40, 36, 3), noise=0.05):
    """(pred, target) NHWC float32 in and slightly out of [0, 1]."""
    rng = np.random.default_rng(seed)
    target = rng.random(shape).astype(np.float32)
    pred = target + rng.normal(0, noise, shape).astype(np.float32)
    return pred, target


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("layout", ["hwc", "chw", "tensor"])
def test_tensor_to_uint8_truncates_like_jax(layout):
    pred, _ = _pair(0)
    x = pred[0] if layout == "hwc" else pred[0].transpose(2, 0, 1)
    want = jax_fidelity.tensor_to_uint8(x)
    got = fidelity.tensor_to_uint8(torch.from_numpy(x.copy())
                                   if layout == "tensor" else x)
    assert got.dtype == np.uint8 and got.shape == (40, 36, 3)
    np.testing.assert_array_equal(got, want)
    assert got.max() == 255 and got.min() == 0  # clipped, not wrapped


@pytest.mark.parametrize("name", ["compare_mse", "compare_psnr",
                                  "compare_ssim", "compare_ergas"])
def test_host_tier_equals_the_jax_host_tier(name):
    pred, target = _pair(1)
    p8 = fidelity.tensor_to_uint8(pred[0])
    t8 = fidelity.tensor_to_uint8(target[0])
    got = getattr(fidelity, name)(t8, p8)
    want = getattr(jax_fidelity, name)(t8, p8)
    assert got == pytest.approx(want, rel=1e-12)
    assert np.isfinite(got)


def test_host_psnr_of_equal_images_is_infinite():
    t8 = fidelity.tensor_to_uint8(_pair(2)[1][0])
    assert fidelity.compare_psnr(t8, t8) == float("inf")
    assert fidelity.compare_psnr(t8 / 255.0, t8 / 255.0 * 0.5) == \
        pytest.approx(jax_fidelity.compare_psnr(t8 / 255.0, t8 / 255.0 * 0.5))


@pytest.mark.parametrize("noise", [0.02, 0.2])
@pytest.mark.parametrize("name", ["batched_psnr", "batched_ssim",
                                  "batched_ergas"])
def test_batched_tier_matches_the_jax_batched_tier(name, noise):
    pred, target = _pair(3, noise=noise)
    want = np.asarray(getattr(jax_fidelity, name)(jnp.asarray(pred),
                                                  jnp.asarray(target)))
    got = getattr(fidelity, name)(_nchw(pred), _nchw(target))
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=0)


def test_batched_ergas_takes_the_scale():
    pred, target = _pair(4)
    want = np.asarray(jax_fidelity.batched_ergas(jnp.asarray(pred),
                                                 jnp.asarray(target), 2))
    got = fidelity.batched_ergas(_nchw(pred), _nchw(target), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL)


@pytest.mark.parametrize("name,host,tol", [
    ("batched_psnr", "compare_psnr", 1e-3),      # dB
    ("batched_ssim", "compare_ssim", 1e-4),
    ("batched_ergas", "compare_ergas", 1e-4)])
def test_batched_tier_lines_up_with_the_host_tier(name, host, tol):
    """The same formulas after the same truncation: float32 on tensors
    against float64 on uint8 arrays."""
    pred, target = _pair(5)
    got = getattr(fidelity, name)(_nchw(pred), _nchw(target)).numpy()
    for i in range(3):
        t8 = fidelity.tensor_to_uint8(target[i])
        p8 = fidelity.tensor_to_uint8(pred[i])
        assert got[i] == pytest.approx(getattr(fidelity, host)(t8, p8),
                                       abs=tol)


def test_batched_tier_takes_bf16_predictions():
    pred, target = _pair(6)
    got = fidelity.batched_psnr(_nchw(pred).to(torch.bfloat16),
                                _nchw(target))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
