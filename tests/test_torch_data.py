"""The port's data feed against the JAX package's: the PIL-coefficient
resize, the synthetic and folder datasets, the loader's order and batches,
and the prefetch to the device (here the CPU)."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from sradsgan_tpu.core.config import DataConfig as JaxDataConfig  # noqa: E402
from sradsgan_tpu.data import datasets as jax_datasets  # noqa: E402
from sradsgan_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from sradsgan_tpu.ops import resize as jax_resize  # noqa: E402
from sradsgan_tpu_torch.config import DataConfig  # noqa: E402
from sradsgan_tpu_torch.data import datasets  # noqa: E402
from sradsgan_tpu_torch.data.loader import (DataLoader,  # noqa: E402
                                            device_prefetch)
from sradsgan_tpu_torch.ops import resize  # noqa: E402

PIL_FILTERS = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("sizes", [(216, 54), (54, 216), (7, 216), (27, 9),
                                   (31, 31), (50, 37)])
def test_resize_matrix_equals_the_jax_one(sizes, method):
    got = resize.resize_matrix(*sizes, method)
    want = jax_resize.resize_matrix(*sizes, method)
    assert got.shape == want.shape == sizes[::-1] and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_float_resize_matches_jax_and_pil(method):
    """Against the JAX matmul resize at 1e-5 (float32 sums in another
    order) and against PIL's own float ('F' mode) resize at 1e-3 mean abs,
    the bar of the JAX package's tests/test_resize.py."""
    x = np.random.default_rng(0).random((2, 24, 20, 3)).astype(np.float32)
    got = resize.bicubic_resize(torch.from_numpy(x), 9, 31, method).numpy()
    want = np.asarray(jax_resize.bicubic_resize(jnp.asarray(x), 9, 31,
                                                method))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    single = resize.bicubic_resize(torch.from_numpy(x[0]), 9, 31, method)
    np.testing.assert_allclose(single.numpy(), got[0], rtol=0, atol=1e-6)
    pil = np.stack([np.asarray(Image.fromarray(x[0, :, :, c], mode="F")
                               .resize((31, 9), PIL_FILTERS[method]))
                    for c in range(3)], axis=-1)
    assert np.abs(got[0] - pil).mean() <= 1e-3


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("sizes", [((216, 216), (54, 54)),
                                   ((54, 54), (216, 216)),
                                   ((21, 21), (216, 216)),
                                   ((30, 44), (17, 90))])
def test_uint8_resize_matches_pil(sizes, method):
    """PIL's 8-bit resize, rounding included.  Found: equal except where a
    weighted sum lands next to a half (PIL's coefficients are 22-bit fixed
    point), at most 2 % of the pixels (bilinear, 30x44 -> 17x90), each one
    level off; held to one level, 5 % of the pixels and 1e-3 mean abs of
    [0, 1]."""
    (h, w), (oh, ow) = sizes
    img = np.random.default_rng(1).integers(0, 256, (h, w, 3)).astype(
        np.uint8)
    want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                  PIL_FILTERS[method]))
    got = resize.resize_uint8(torch.from_numpy(img.astype(np.float32)), oh,
                              ow, method).numpy()
    assert got.shape == want.shape and (got == np.round(got)).all()
    diff = np.abs(got - want.astype(np.float32))
    assert diff.max() <= 1.0
    assert diff.mean() / 255.0 <= 1e-3
    assert (diff > 0).mean() <= 5e-2


def test_degrade_pair_matches_jax():
    hr = np.random.default_rng(2).random((2, 24, 24, 3)).astype(np.float32)
    lr, bc = resize.degrade_pair(torch.from_numpy(hr), 4, "bilinear")
    want_lr, want_bc = jax_resize.degrade_pair(jnp.asarray(hr), 4, "bilinear")
    np.testing.assert_allclose(lr.numpy(), np.asarray(want_lr), atol=1e-5)
    np.testing.assert_allclose(bc.numpy(), np.asarray(want_bc), atol=1e-5)


@pytest.mark.parametrize("scale,crop,lr_filter,seed", [
    (4, 216, "bicubic", 1234), (4, 216, "bilinear", 99),
    (2, 32, "bicubic", 1234), (3, 27, "bilinear", 99),
    (4, 64, "bicubic", 5)])
def test_synthetic_triplets_match_the_jax_dataset(scale, crop, lr_filter,
                                                  seed):
    """The JAX dataset resizes with PIL, the port with its own resize_uint8
    (no Pillow on the card's machine).  Found: mean abs up to 5.2e-5 of
    [0, 1], a few pixels one level off and, in the twin (two resizes
    deep), two; held to 1e-4 mean abs and 2 / 255 per pixel."""
    want_ds = jax_datasets.SyntheticDataset(8, scale, crop, lr_filter, seed)
    got_ds = datasets.SyntheticDataset(8, scale, crop, lr_filter, seed)
    assert len(got_ds) == len(want_ds) == 8
    for index in (0, 3, 7):
        want, got = want_ds.load(index), got_ds.load(index)
        assert got["path"] == want["path"]
        for key in ("lr", "hr", "bc"):
            assert got[key].dtype == np.float32
            assert got[key].shape == want[key].shape
            diff = np.abs(got[key] - want[key])
            assert diff.mean() <= 1e-4, (key, diff.mean())
            assert diff.max() <= 2 / 255 + 1e-6, (key, diff.max())
            # both sides hold uint8 levels
            np.testing.assert_allclose(got[key] * 255,
                                       np.round(got[key] * 255), atol=1e-4)


def test_build_datasets_follow_the_jax_sizes(tmp_path):
    cfg = DataConfig(synthetic=True, synthetic_size=40, crop_size=32,
                     test_crop_size=24)
    want = JaxDataConfig(synthetic=True, synthetic_size=40, crop_size=32,
                         test_crop_size=24)
    for build in ("build_train_dataset", "build_test_dataset"):
        got_ds = getattr(datasets, build)(cfg, 4)
        want_ds = getattr(jax_datasets, build)(want, 4)
        assert (len(got_ds), got_ds.crop_size, got_ds.lr_filter,
                got_ds.seed) == (len(want_ds), want_ds.crop_size,
                                 want_ds.lr_filter, want_ds.seed)
    cfg = DataConfig(data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no training images"):
        datasets.build_train_dataset(cfg, 4)


def test_folder_dataset_equals_the_jax_one(tmp_path):
    """Same files, same PIL protocol: equal bit for bit, in the train
    (bicubic) and the test (bilinear) flavour; class dirs scan alike."""
    rng = np.random.default_rng(3)
    for cls in ("b_class", "a_class"):
        (tmp_path / cls).mkdir()
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (40, 44, 3)).astype(
                np.uint8)).save(tmp_path / cls / f"im{i}.png")
    (tmp_path / "a_class" / "notes.txt").write_text("not an image")
    assert (datasets.scan_class_dirs(str(tmp_path))
            == jax_datasets.scan_class_dirs(str(tmp_path)))
    dirs = [p for _, p in datasets.scan_class_dirs(str(tmp_path))]
    files = datasets.scan_image_dirs(dirs)
    assert files == jax_datasets.scan_image_dirs(dirs) and len(files) == 4
    assert datasets.is_image_file("x.TIF") and not datasets.is_image_file(
        "x.txt")
    for lr_filter in ("bicubic", "bilinear"):
        got_ds = datasets.FolderDataset(files, 4, 32, lr_filter)
        want_ds = jax_datasets.FolderDataset(files, 4, 32, lr_filter)
        for i in range(len(files)):
            got, want = got_ds.load(i), want_ds.load(i)
            assert got["path"] == want["path"]
            for key in ("lr", "hr", "bc"):
                np.testing.assert_array_equal(got[key], want[key])
    cfg = DataConfig(data_dir=str(tmp_path.parent),
                     test_dataset=tmp_path.name, test_crop_size=32)
    assert datasets.build_test_dataset(cfg, 4).files == files


class _Memory:
    """An in-memory dataset both loaders can walk."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.items = [{"lr": rng.random((4, 4, 3), dtype=np.float32),
                       "hr": rng.random((8, 8, 3), dtype=np.float32),
                       "bc": rng.random((8, 8, 3), dtype=np.float32),
                       "path": f"item_{i}"} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def load(self, index, rng=None):  # rng: the JAX loader passes one
        return dict(self.items[index])


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_loader_order_and_batches_equal_the_jax_loader(shuffle, drop_last):
    ds = _Memory(11)
    kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=3, seed=5)
    got_loader, want_loader = DataLoader(ds, 4, **kw), JaxDataLoader(ds, 4,
                                                                     **kw)
    assert len(got_loader) == len(want_loader) == (2 if drop_last else 3)
    orders = []
    for _ in range(2):  # two epochs: the second one reshuffles
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader)
        for g, w in zip(got, want):
            assert g["path"] == w["path"]
            for key in ("lr", "hr", "bc"):
                np.testing.assert_array_equal(g[key], w[key])
        orders.append([p for b in got for p in b["path"]])
    assert (orders[0] != orders[1]) == shuffle
    # a loader seeded one higher starts where this one's second epoch did
    nxt = DataLoader(ds, 4, **dict(kw, seed=6))
    assert [p for b in nxt for p in b["path"]] == (
        orders[1] if shuffle else orders[0])


def test_device_prefetch_hands_out_nchw_tensors_in_order():
    ds = _Memory(10, seed=1)
    loader = DataLoader(ds, 4, shuffle=False, drop_last=False, num_workers=2)
    want = list(loader)
    got = list(device_prefetch(iter(loader), "cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["path"] == w["path"]
        for key in ("lr", "hr", "bc"):
            assert g[key].is_contiguous() and g[key].dtype == torch.float32
            np.testing.assert_array_equal(g[key].numpy(),
                                          w[key].transpose(0, 3, 1, 2))


def test_device_prefetch_reraises_a_producer_exception():
    def broken():
        yield next(iter(DataLoader(_Memory(4), 4, num_workers=1)))
        raise OSError("decode failed")

    feed = device_prefetch(broken(), "cpu")
    assert next(feed)["lr"].shape == (4, 3, 4, 4)
    with pytest.raises(OSError, match="decode failed"):
        next(feed)


def test_closing_the_prefetch_early_stops_its_producer():
    before = threading.active_count()
    loader = DataLoader(_Memory(64), 2, num_workers=1)
    feed = device_prefetch(iter(loader), "cpu")
    next(feed)
    feed.close()  # the producer is blocked on a full queue at this point
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
