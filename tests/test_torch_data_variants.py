"""The port's dataset variants, the loader's augmentation draws and the
degradation ops against the JAX package's.

- The datasets (``sradsgan_tpu_torch/data/datasets.py``) take the same
  numpy draws in the same order and make the same PIL calls as JAX's, so
  their samples are held bit-equal, and so is what each leaves of the
  generator it was handed.
- ``ops/degrade.py``'s deterministic cores are held against JAX's random
  functions given JAX's own draws (the bits of ``jax.random`` cannot be
  matched by a ``torch.Generator``); the port's random wrappers are held to
  the laws of their draws.
- ``ops/kernel_ops.py`` is float64 numpy and scipy on both sides.
"""

import io
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from sradsgan_tpu.data import datasets as jax_datasets  # noqa: E402
from sradsgan_tpu.data.loader import DataLoader as JaxDataLoader  # noqa
from sradsgan_tpu.ops import degrade as jax_degrade  # noqa: E402
from sradsgan_tpu.ops import kernel_ops as jax_kernel_ops  # noqa: E402
from sradsgan_tpu.tools.prepare_data import (  # noqa: E402
    iter_triplet_records as jax_records, prepare_triplets as jax_triplets)
from sradsgan_tpu_torch.data import datasets  # noqa: E402
from sradsgan_tpu_torch.data.loader import DataLoader  # noqa: E402
from sradsgan_tpu_torch.ops import degrade, kernel_ops  # noqa: E402

SCALE, CROP, LR = 4, 32, 8
N_IMAGES = 3


class _Txn:
    def __init__(self, store):
        self.store = store

    def get(self, key):
        return self.store.get(key)


class DictEnv:
    """lmdb's ``begin()`` interface over a dict."""

    def __init__(self, store):
        self.store = store

    def begin(self, write=False):
        import contextlib

        @contextlib.contextmanager
        def txn():
            yield _Txn(self.store)
        return txn()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three 40 x 36 RGB pngs, their GDP triplet folders (written by the JAX
    tool) with an ``hr_mask_32`` folder, and their LMDB records in a
    dict."""
    root = tmp_path_factory.mktemp("variants")
    src = root / "src"
    src.mkdir()
    rng = np.random.default_rng(0)
    files = []
    for i in range(N_IMAGES):
        path = str(src / f"im{i}.png")
        Image.fromarray(rng.integers(0, 256, (36, 40, 3), dtype=np.uint8)
                        ).save(path)
        files.append(path)
    trip = str(root / "trip")
    jax_triplets(str(src), trip, CROP, LR, workers=2)
    os.makedirs(os.path.join(trip, f"hr_mask_{CROP}"))
    for i in range(N_IMAGES):
        mask = (rng.random((CROP, CROP, 3)) > 0.5).astype(np.uint8) * 255
        Image.fromarray(mask).save(
            os.path.join(trip, f"hr_mask_{CROP}", f"{i:05d}.png"))
    store = dict(jax_records(str(src), CROP, LR))
    no_lr = {k: v for k, v in store.items() if not k.startswith(b"lr_")}
    return {"files": files, "trip": trip, "store": store, "no_lr": no_lr}


def _pair(name, t):
    """(port dataset, JAX dataset) of the variant ``name``."""
    f = t["files"]
    folder = dict(files=f, scale=SCALE, crop_size=CROP)
    cases = {
        "folder_augment": ("FolderDataset", dict(folder, augment=True)),
        "folder_gray": ("FolderDataset", dict(folder, gray=True)),
        "folder_gray_augment_bilinear": (
            "FolderDataset", dict(folder, gray=True, augment=True,
                                  lr_filter="bilinear")),
        "augmented_crop": ("AugmentedCropDataset", folder),
        "augmented_crop_fixed_scale": (
            "AugmentedCropDataset", dict(folder, random_scale=False)),
        "noisy_gaussian": ("NoisyDataset", dict(folder, noise="gaussian",
                                                noise_level=0.05)),
        "noisy_sp": ("NoisyDataset", dict(folder, noise="sp",
                                          noise_level=0.2)),
        "noisy_poisson": ("NoisyDataset", dict(folder, noise="poisson")),
        "blur": ("BlurDegradedDataset", dict(folder, blur_sigma=1.2)),
        "triplet_hflip": ("TripletFolderDataset",
                          dict(root=t["trip"], lr_size=LR, hr_size=CROP,
                               hflip=True)),
        "triplet_hflip_mask": ("TripletFolderDataset",
                               dict(root=t["trip"], lr_size=LR, hr_size=CROP,
                                    hflip=True, hr_mask=True)),
    }
    if name.startswith("lmdb"):
        store = t["no_lr"] if name == "lmdb_no_lr" else t["store"]
        kw = dict(lr_size=LR, hr_size=CROP, hflip=True)
        return (datasets.LMDBTripletDataset(DictEnv(store), **kw),
                jax_datasets.LMDBTripletDataset(DictEnv(store), **kw))
    cls, kw = cases[name]
    return getattr(datasets, cls)(**kw), getattr(jax_datasets, cls)(**kw)


def _assert_same_sample(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            assert got[key].shape == value.shape, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


VARIANTS = ["folder_augment", "folder_gray", "folder_gray_augment_bilinear",
            "augmented_crop", "augmented_crop_fixed_scale", "noisy_gaussian",
            "noisy_sp", "noisy_poisson", "blur", "triplet_hflip",
            "triplet_hflip_mask", "lmdb", "lmdb_no_lr"]


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_samples_are_bit_equal_to_jax(name, tree):
    """Every image with no generator and with generators of four seeds:
    equal samples, and the generators left in equal states."""
    port, jax_ds = _pair(name, tree)
    assert len(port) == len(jax_ds) == N_IMAGES
    for index in range(N_IMAGES):
        _assert_same_sample(port.load(index), jax_ds.load(index))
        for seed in range(4):
            a = np.random.default_rng(seed)
            b = np.random.default_rng(seed)
            _assert_same_sample(port.load(index, a), jax_ds.load(index, b))
            assert a.random() == b.random()
    if name.startswith("folder_gray"):
        assert port.load(0)["hr"].shape == (CROP, CROP, 1)


def test_synthetic_dataset_takes_and_ignores_a_generator():
    ds = datasets.SyntheticDataset(2, SCALE, 16)
    rng = np.random.default_rng(0)
    _assert_same_sample(ds.load(1, rng), ds.load(1))
    assert rng.random() == np.random.default_rng(0).random()


@pytest.mark.parametrize("augment_rng", [True, False])
def test_loader_augment_rng_equals_the_jax_loader(augment_rng, tree):
    """Two passes over the augmented-crop set at batch 2 (shuffled, tail
    kept): the same batches as the JAX loader, and each image's draw the
    same in both passes (it depends on the index, not the pass)."""
    kw = dict(files=tree["files"], scale=SCALE, crop_size=CROP)
    loader_kw = dict(batch_size=2, shuffle=True, drop_last=False,
                     num_workers=2, seed=3, augment_rng=augment_rng)
    port = DataLoader(datasets.AugmentedCropDataset(**kw), **loader_kw)
    ref = JaxDataLoader(jax_datasets.AugmentedCropDataset(**kw), **loader_kw)
    by_path = {}
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == ["bc", "hr", "lr", "path"]
            assert g["path"] == w["path"]
            for key in ("lr", "hr", "bc"):
                np.testing.assert_array_equal(g[key], w[key])
            for i, path in enumerate(g["path"]):
                seen = by_path.setdefault(path, g["hr"][i])
                np.testing.assert_array_equal(seen, g["hr"][i])


def test_loader_drops_hr_mask_from_the_batch(tree):
    ds = datasets.TripletFolderDataset(tree["trip"], LR, CROP, hflip=True,
                                       hr_mask=True)
    batch = next(iter(DataLoader(ds, 3, shuffle=False, augment_rng=True)))
    assert sorted(batch) == ["bc", "hr", "lr", "path"]
    assert batch["hr"].shape == (3, CROP, CROP, 3)


def test_hr_mask_flips_with_hr_and_sr(tree):
    """A generator whose draw flips, and one whose draw does not: the mask
    turns with the HR and the SR twin, or none turns."""
    ds = datasets.TripletFolderDataset(tree["trip"], LR, CROP, hflip=True,
                                       hr_mask=True)
    plain = datasets.TripletFolderDataset(tree["trip"], LR, CROP,
                                          hr_mask=True).load(1)
    outcomes = set()
    for seed in range(8):
        flips = bool(np.random.default_rng(seed).integers(0, 2))
        out = ds.load(1, np.random.default_rng(seed))
        for key in ("lr", "hr", "bc", "hr_mask"):
            want = plain[key][:, ::-1] if flips else plain[key]
            np.testing.assert_array_equal(out[key], want, err_msg=key)
        outcomes.add(flips)
    assert outcomes == {True, False}
    assert (plain["hr_mask"] != plain["hr_mask"][:, ::-1]).any()


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_lmdb_round_trip_and_invalid_index_redraw(tree):
    """The records read back as the folder triplets hold them; index 1
    missing from a store is redrawn, to the index JAX redraws."""
    lmdb_ds = datasets.LMDBTripletDataset(DictEnv(tree["store"]), LR, CROP)
    folder = datasets.TripletFolderDataset(tree["trip"], LR, CROP)
    assert len(lmdb_ds) == N_IMAGES
    for i in range(N_IMAGES):
        got, want = lmdb_ds.load(i), folder.load(i)
        assert got["path"] == f"lmdb:{i:05d}"
        for key in ("lr", "hr", "bc"):
            np.testing.assert_array_equal(got[key], want[key])

    rng = np.random.default_rng(1)
    store = {b"length": b"3"}
    for i in (0, 2):
        tag = f"{i:05d}"
        store[f"hr_16_{tag}".encode()] = _png(np.full((16, 16, 3), 40 * i,
                                                      np.uint8))
        store[f"sr_8_16_{tag}".encode()] = _png(rng.integers(
            0, 256, (16, 16, 3), dtype=np.uint8))
        store[f"lr_8_{tag}".encode()] = _png(rng.integers(
            0, 256, (8, 8, 3), dtype=np.uint8))
    port = datasets.LMDBTripletDataset(DictEnv(store), 8, 16)
    ref = jax_datasets.LMDBTripletDataset(DictEnv(store), 8, 16)
    for seed in range(4):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        got = port.load(1, a)
        _assert_same_sample(got, ref.load(1, b))
        assert got["path"] in ("lmdb:00000", "lmdb:00002")
        assert a.random() == b.random()
    _assert_same_sample(port.load(1), ref.load(1))


def test_lmdb_path_without_the_package_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "lmdb", None)
    with pytest.raises(ImportError, match="TripletFolderDataset"):
        datasets.LMDBTripletDataset(str(tmp_path), LR, CROP)


def test_noisy_poisson_levels_depend_on_the_data(tmp_path):
    """A JAX-side gap kept as JAX has it: ``NoisyDataset`` scales its shot
    noise by 2**ceil(log2(#distinct LR values)), ``ops/degrade.py`` by a
    static 256.  On a three-level image the dataset's LR lies on a grid of
    quarters, the op's on a grid of 1/256."""
    path = str(tmp_path / "levels.png")
    levels = np.array([0, 128, 255], np.uint8)
    img = levels[np.random.default_rng(12).integers(0, 3, (32, 32))]
    Image.fromarray(np.repeat(img[..., None], 3, -1)).save(path)
    kw = dict(files=[path], scale=1, crop_size=32, lr_filter="bilinear",
              noise="poisson")
    out = datasets.NoisyDataset(**kw).load(0, np.random.default_rng(0))
    want = jax_datasets.NoisyDataset(**kw).load(0, np.random.default_rng(0))
    np.testing.assert_array_equal(out["lr"], want["lr"])
    assert len(np.unique(datasets.FolderDataset(
        [path], 1, 32, "bilinear").load(0)["lr"])) == 3
    np.testing.assert_array_equal(out["lr"] * 4, np.round(out["lr"] * 4))
    op = degrade.add_poisson_noise(torch.Generator().manual_seed(0),
                                   torch.from_numpy(out["lr"]))
    assert not torch.equal(op * 4, torch.round(op * 4))
    torch.testing.assert_close(op * 256, torch.round(op * 256), rtol=0,
                               atol=0)


# --------------------------------------------------------------- degrade


def _jax_kernel_draws(key, batch, sigma_min, sigma_max, isotropic):
    """The draws inside JAX's ``gaussian_kernels`` (its three key splits)."""
    k_sig, k_sig2, k_theta = jax.random.split(key, 3)
    sx = jax.random.uniform(k_sig, (batch,), minval=sigma_min,
                            maxval=sigma_max)
    if isotropic:
        return sx, sx, jnp.zeros((batch,))
    sy = jax.random.uniform(k_sig2, (batch,), minval=sigma_min,
                            maxval=sigma_max)
    theta = jax.random.uniform(k_theta, (batch,), minval=0.0,
                               maxval=np.pi)
    return sx, sy, theta


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


@pytest.mark.parametrize("isotropic", [True, False])
@pytest.mark.parametrize("size", [21, 8])
def test_gaussian_kernels_from_matches_jax(isotropic, size):
    key = jax.random.PRNGKey(3)
    want = jax_degrade.gaussian_kernels(key, 6, size, 0.2, 4.0, isotropic)
    draws = _jax_kernel_draws(key, 6, 0.2, 4.0, isotropic)
    got = degrade.gaussian_kernels_from(*map(_t, draws), size)
    assert got.shape == (6, size, size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_batch_blur_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.random((3, 24, 20, 3), dtype=np.float32)
    k = rng.random((3, 21, 21)).astype(np.float32)
    k /= k.sum(axis=(1, 2), keepdims=True)
    got = degrade.batch_blur(_t(x), _t(k))
    want = jax_degrade.batch_blur(jnp.asarray(x), jnp.asarray(k))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("isotropic,noise_sigma", [(True, 0.0), (True, 0.05),
                                                   (False, 0.05)])
def test_srmd_preprocess_from_matches_jax(isotropic, noise_sigma):
    """JAX's ``srmd_preprocess`` against the port's core fed JAX's kernels
    and JAX's noise draw (its second key)."""
    hr = np.random.default_rng(5).random((2, 32, 32, 3), dtype=np.float32)
    key = jax.random.PRNGKey(7)
    want_lr, want_k = jax_degrade.srmd_preprocess(
        key, jnp.asarray(hr), SCALE, 21, 4.0, noise_sigma, isotropic)
    _, k_noise = jax.random.split(key)
    noise = jax.random.normal(k_noise, want_lr.shape, jnp.float32)
    got = degrade.srmd_preprocess_from(_t(hr), _t(want_k), SCALE, _t(noise),
                                       noise_sigma)
    assert got.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_lr), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["gaussian", "poisson", "salt_pepper"])
def test_noise_cores_match_jax(kind):
    x = np.random.default_rng(6).random((2, 12, 10, 3), dtype=np.float32)
    key = jax.random.PRNGKey(8)
    if kind == "gaussian":
        want = jax_degrade.add_gaussian_noise(key, jnp.asarray(x), 0.05)
        draw = jax.random.normal(key, x.shape, jnp.float32)
        got = degrade.add_gaussian_noise_from(_t(x), _t(draw), 0.05)
    elif kind == "poisson":
        want = jax_degrade.add_poisson_noise(key, jnp.asarray(x))
        draw = jax.random.poisson(key, jnp.maximum(jnp.asarray(x) * 256.0,
                                                   0.0))
        got = degrade.add_poisson_noise_from(_t(x), _t(draw))
    else:
        want = jax_degrade.add_salt_pepper_noise(key, jnp.asarray(x), 0.2)
        k1, _ = jax.random.split(key)
        draw = jax.random.uniform(k1, x.shape[:3] + (1,))
        got = degrade.add_salt_pepper_noise_from(_t(x), _t(draw), 0.2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("isotropic", [True, False])
def test_gaussian_kernels_draw_their_widths_in_range(isotropic):
    """The draws a seed gives, read back from a second generator of that
    seed: widths in [0.2, 4), angles in [0, pi), and the kernels exactly
    the core's of those draws, each of unit sum."""
    got = degrade.gaussian_kernels(torch.Generator().manual_seed(0), 256, 21,
                                   0.2, 4.0, isotropic)
    gen = torch.Generator().manual_seed(0)
    sx = 0.2 + 3.8 * torch.rand(256, generator=gen)
    if isotropic:
        sy, theta = sx, torch.zeros(256)
    else:
        sy = 0.2 + 3.8 * torch.rand(256, generator=gen)
        theta = np.pi * torch.rand(256, generator=gen)
    for s in (sx, sy):
        assert 0.2 <= float(s.min()) and float(s.max()) < 4.0
        assert float(s.max()) - float(s.min()) > 3.0  # spans the range
    assert 0.0 <= float(theta.min()) and float(theta.max()) < np.pi
    torch.testing.assert_close(
        got, degrade.gaussian_kernels_from(sx, sy, theta, 21), rtol=0, atol=0)
    np.testing.assert_allclose(got.sum(dim=(1, 2)).numpy(), 1.0, atol=1e-6)


def test_noise_wrappers_follow_their_laws():
    """Means and standard deviations within four standard errors."""
    n = 64 * 64 * 3 * 8
    x = torch.full((8, 64, 64, 3), 0.5)
    gen = torch.Generator().manual_seed(1)
    d = (degrade.add_gaussian_noise(gen, x, 0.01) - x).double()
    assert abs(float(d.mean())) <= 4 * 0.01 / n ** 0.5
    assert abs(float(d.std()) - 0.01) <= 4 * 0.01 / (2 * n) ** 0.5

    x = torch.full((8, 64, 64, 3), 0.3)
    y = degrade.add_poisson_noise(gen, x).double()
    sd = (0.3 / 256) ** 0.5  # Poisson(76.8) / 256
    assert abs(float(y.mean()) - 0.3) <= 4 * sd / n ** 0.5
    assert abs(float(y.std()) - sd) <= 4 * sd / (2 * n) ** 0.5
    assert torch.equal(y * 256, torch.round(y * 256))

    pixels = 8 * 64 * 64
    y = degrade.add_salt_pepper_noise(gen, x, 0.1)
    for value in (1.0, 0.0):
        hit = (y == value).all(-1).double().mean()
        se = (0.05 * 0.95 / pixels) ** 0.5
        assert abs(float(hit) - 0.05) <= 4 * se
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 0.3, 1.0]))


@pytest.mark.parametrize("call", [
    lambda x: degrade.gaussian_kernels(None, 2),
    lambda x: degrade.add_gaussian_noise(None, x),
    lambda x: degrade.add_poisson_noise(None, x),
    lambda x: degrade.add_salt_pepper_noise(None, x),
    lambda x: degrade.srmd_preprocess(None, x, SCALE),
], ids=["kernels", "gaussian", "poisson", "salt_pepper", "srmd"])
def test_random_functions_require_a_generator(call):
    """No default draws on the CPU: the caller hands in the generator, as
    JAX's counterparts require their key."""
    with pytest.raises(TypeError, match="torch.Generator"):
        call(torch.full((2, 16, 16, 3), 0.5))


def test_srmd_preprocess_draws_kernels_then_noise():
    hr = torch.rand((3, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    lr, k = degrade.srmd_preprocess(torch.Generator().manual_seed(9), hr,
                                    SCALE, 21, 4.0, 0.05, isotropic=False)
    gen = torch.Generator().manual_seed(9)
    k_again = degrade.gaussian_kernels(gen, 3, 21, 0.2, 4.0, False)
    noise = torch.randn((3, 8, 8, 3), generator=gen)
    torch.testing.assert_close(k, k_again, rtol=0, atol=0)
    torch.testing.assert_close(
        lr, degrade.srmd_preprocess_from(hr, k_again, SCALE, noise, 0.05),
        rtol=0, atol=0)
    assert lr.shape == (3, 8, 8, 3) and 0 <= lr.min() and lr.max() <= 1


# ------------------------------------------------------------ kernel_ops


@pytest.mark.parametrize("target_size", [None, 15, 25])
def test_post_process_kernel_matches_jax(target_size):
    rng = np.random.default_rng(10)
    k = rng.random((21, 21)) * np.exp(-((np.arange(21) - 13.0) ** 2) / 20.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        got = kernel_ops.post_process_kernel(k, n_keep=40,
                                             target_size=target_size)
    want = jax_kernel_ops.post_process_kernel(k, n_keep=40,
                                              target_size=target_size)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert abs(got.sum() - 1.0) <= 1e-12


def test_centralize_and_zeroize_match_jax():
    k = np.zeros((15, 15))
    k[3:8, 9:13] = np.random.default_rng(11).random((5, 4))
    got = kernel_ops.centralize_kernel(k)
    np.testing.assert_allclose(got, jax_kernel_ops.centralize_kernel(k),
                               rtol=0, atol=1e-12)
    from scipy import ndimage
    np.testing.assert_allclose(ndimage.center_of_mass(got), (7.0, 7.0),
                               atol=0.05)
    z = kernel_ops.zeroize_negligible(k, 6)
    np.testing.assert_allclose(z, jax_kernel_ops.zeroize_negligible(k, 6),
                               rtol=0, atol=1e-12)
    assert np.count_nonzero(z) == 7
