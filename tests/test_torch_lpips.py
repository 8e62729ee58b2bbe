"""The port's LPIPS (``sradsgan_tpu_torch/losses/lpips.py``) against the JAX
package's, on the CPU.

The JAX trunk and heads are drawn from a seed (numpy, in the flax tree's
shapes) and carried across by
``tools/from_jax.py:lpips_state_dict``; both sides then score the same
seeded numpy images.  Tolerance: 1e-5 of max |ref| per image (float32
convs summed in another order).  The env-var trunk files go through both
packages' loaders, and the uncalibrated score is marked as such."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.losses import lpips as jax_lpips  # noqa: E402
from sradsgan_tpu_torch.losses import lpips  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    lpips_state_dict, save_npz)

TOL = 1e-5
SIZES = {"alex": 64, "squeeze": 64, "vgg": 32}


def _images(size, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.random((batch, size, size, 3)).astype(np.float32)
            for _ in range(2)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jax_params(net, size, seed):
    """JAX LPIPS params of the flax tree's shapes, drawn with numpy: conv
    kernels normal(0, 1 / sqrt(fan_in)) (flax's LeCun scale), biases
    normal(0, 0.05), heads uniform [0, 1) so that every channel weighs
    differently."""
    model = jax_lpips.LPIPS(net=net)
    dummy = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), dummy,
                            dummy)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name.startswith("lin"):
            return rng.random(leaf.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_matches_jax(net):
    size = SIZES[net]
    model, params = _jax_params(net, size, seed=1)
    x, y = _images(size)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                  jnp.asarray(y)))
    port = lpips.LPIPS(net)
    port.load_state_dict(lpips_state_dict(params, net))
    got = port(_nchw(x), _nchw(y)).numpy()
    assert got.shape == want.shape == (2,)
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), (err, got, want)
    same = port(_nchw(x), _nchw(x)).numpy()
    np.testing.assert_array_equal(same, np.zeros(2, np.float32))


def _trunk_file(net, tmp_path, monkeypatch, seed):
    """A trunk ``.npz`` in the JAX layout (as
    ``sradsgan_tpu/tools/convert_torch.py`` writes it) named by the env var;
    returns the params it came from."""
    _, params = _jax_params(net, 64, seed)
    path = tmp_path / f"{net}.npz"
    save_npz(str(path), params[lpips.NETS[net][2]])
    monkeypatch.setenv(lpips.NETS[net][1], str(path))
    return params


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_trunk_file_loads_into_the_port(net, tmp_path, monkeypatch):
    """``load_lpips`` gives exactly the model that ``lpips_state_dict``
    gives for the file's trunk beside the bundled heads, and says
    calibrated."""
    params = _trunk_file(net, tmp_path, monkeypatch, seed=2)
    assert lpips.lpips_is_calibrated(net)
    model, calibrated = lpips.load_lpips(net)
    assert calibrated
    with np.load(f"{lpips._WEIGHTS_DIR}/lpips_{net}_v01.npz") as heads:
        tree = dict(params, **{k: heads[k] for k in heads.files})
    want = lpips_state_dict(tree, net)
    assert set(model.state_dict()) == set(want)
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name]), name


def test_trunk_file_reaches_both_packages(tmp_path, monkeypatch):
    """The AlexNet trunk file, the CLI's, through both packages' loaders
    beside the bundled heads.  JAX scores through ``jax.jit``, which on
    the CPU is itself up to 1.9e-6 (alex) and 2.8e-5 (squeeze) of the
    value from the float64 reference (the port's model in float64; the
    port's float32 is within 1.7e-7 of it), so the two packages are held
    to 1e-4 relative here, the bar of the evaluation protocol's LPIPS
    columns."""
    _trunk_file("alex", tmp_path, monkeypatch, seed=2)
    caches = (jax_lpips._build_lpips, lpips._cached)
    for cache in caches:
        cache.cache_clear()
    try:
        assert jax_lpips.lpips_is_calibrated("alex")
        x, y = _images(64, seed=3)
        want = np.asarray(jax_lpips.batched_lpips(jnp.asarray(x),
                                                  jnp.asarray(y)))
        got = lpips.batched_lpips(_nchw(x), _nchw(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
        one = lpips.lpips_fn()(x[1], y[1])
        # one pair alone convolves in another blocking than the batch
        assert one == pytest.approx(float(got[1]), rel=TOL)
        assert one == pytest.approx(float(jax_lpips.lpips_fn()(x[1], y[1])),
                                    rel=1e-4)
    finally:
        for cache in caches:
            cache.cache_clear()


def test_uncalibrated_trunk_is_seeded_and_marked(monkeypatch):
    monkeypatch.delenv(lpips.ALEXNET_WEIGHTS_ENV, raising=False)
    assert not lpips.lpips_is_calibrated("alex")
    a, calibrated = lpips.load_lpips("alex")
    b, _ = lpips.load_lpips("alex")
    assert not calibrated
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name  # seeded: the same trunk each time
    with np.load(lpips._WEIGHTS_DIR + "/lpips_alex_v01.npz") as heads:
        np.testing.assert_array_equal(a.lin2.numpy(), heads["lin2"])


def test_lpips_runs_in_float32_under_bf16_autocast():
    x, y = (_nchw(a) for a in _images(64, seed=4))
    want = lpips.batched_lpips(x, y)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = lpips.batched_lpips(x, y)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
