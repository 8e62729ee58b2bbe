"""The port's evaluation protocol (``sradsgan_tpu_torch/evaluation/
validate.py``) against the JAX package's, on the CPU.

SRADSGAN at base_filters 16, one group of one RAB, x2, with the JAX
generator's weights drawn from a seed and carried across by
``tools/from_jax.py``; AlexNet LPIPS on both sides with one seeded trunk,
handed to both through ``SRADSGAN_TPU_ALEXNET_NPZ``, and the bundled
heads.  Inputs: a folder tree of 3 classes x 2 pngs of 32^2, and
the synthetic test set at 32^2.

Bars, per metric: PSNR 1e-3 dB, SSIM 1e-5, ERGAS and LPIPS 1e-4
relative, MSE 2.3e-4 relative (the PSNR bar's).  The SR goes through two
frameworks' float32 convs, so a few uint8 values may truncate apart; the
LPIPS of JAX's ``jax.jit`` path is itself up to 1.9e-6 from float64
(``test_torch_lpips.py``).  The bicubic twin has no network: where both
sides score the same twin (the folder tree, made by PIL on both sides, and
the tests that hand both one in-memory set) its uint8 metrics must be
equal, and its LPIPS, which still goes through the two frameworks' trunks,
is held to the LPIPS bar.  Each package's own synthetic set makes the twin
with its own resize (the port's a few pixels one level off PIL's,
``test_torch_data.py``), so there the twin's rows are held to the SR bars.
"""

import glob
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from sradsgan_tpu.core.config import DataConfig as JaxDataConfig  # noqa
from sradsgan_tpu.data.datasets import (  # noqa: E402
    build_test_dataset as jax_build_test_dataset)
from sradsgan_tpu.evaluation import validate as jax_validate  # noqa: E402
from sradsgan_tpu.losses import lpips as jax_lpips  # noqa: E402
from sradsgan_tpu.models.sradsgan import (  # noqa: E402
    SRADSGANGenerator as JaxGenerator)
from sradsgan_tpu.train import trainer as jax_trainer_module  # noqa: E402
from sradsgan_tpu_torch import models  # noqa: E402
from sradsgan_tpu_torch.config import DataConfig  # noqa: E402
from sradsgan_tpu_torch.data.datasets import build_test_dataset  # noqa
from sradsgan_tpu_torch.evaluation import validate  # noqa: E402
from sradsgan_tpu_torch.losses import lpips  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    save_npz, sradsgan_state_dict)
from sradsgan_tpu_torch.train import trainer as trainer_module  # noqa
from sradsgan_tpu_torch.train.trainer import Trainer  # noqa: E402
from sradsgan_tpu_torch.utils import plotting  # noqa: E402
from test_torch_lpips import _jax_params  # noqa: E402
from test_torch_sradsgan import random_params  # noqa: E402
from test_torch_trainer import _config  # noqa: E402

SCALE = 2
SIZE = 32
TINY = dict(base_filters=16, n_groups=1, n_blocks=1)
CLASSES = ("beach", "airplane", "forest")  # sorted: airplane, beach, forest
BARS = {"psnr": dict(abs=1e-3), "ssim": dict(abs=1e-5),
        "ergas": dict(rel=1e-4), "lpips": dict(rel=1e-4),
        "mse": dict(rel=2.3e-4)}


@pytest.fixture(scope="module")
def shared_trunk(tmp_path_factory):
    """One AlexNet trunk for both packages' LPIPS, through the env var."""
    _, params = _jax_params("alex", 64, seed=7)
    path = tmp_path_factory.mktemp("trunk") / "alexnet.npz"
    save_npz(str(path), params["AlexNetFeatures_0"])
    caches = (jax_lpips._build_lpips, lpips._cached)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(lpips.ALEXNET_WEIGHTS_ENV, str(path))
        for cache in caches:
            cache.cache_clear()
        yield
    for cache in caches:
        cache.cache_clear()


@pytest.fixture(scope="module")
def carried():
    """The JAX generator with seeded fan-in weights, and the port's holding
    the same."""
    gen = JaxGenerator(scale=SCALE, **TINY)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))["params"]
    params = random_params(shapes, seed=4)
    model = models.create_generator("sradsgan", SCALE, **TINY)
    model.load_state_dict(sradsgan_state_dict(params))
    return gen, {"params": params}, model.eval()


@pytest.fixture(scope="module")
def folder_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for cls in CLASSES:
        os.makedirs(root / "UCMerced_LandUse" / cls)
        for i in range(2):
            u8 = rng.integers(0, 256, (SIZE + 4, SIZE + 2, 3), np.uint8)
            Image.fromarray(u8).save(root / "UCMerced_LandUse" / cls
                                     / f"{cls}{i:02d}.png")
    return str(root)


def _configs(data, folder_tree):
    kw = dict(test_crop_size=SIZE, crop_size=SIZE)
    if data == "folder":
        kw.update(data_dir=folder_tree, test_dataset="UCMerced_LandUse")
    else:
        kw.update(synthetic=True, synthetic_size=16)  # an 8-image test set
    return JaxDataConfig(**kw), DataConfig(**kw)


def _assert_row(got, want, what, exact=()):
    assert set(got) == set(want), what
    for key, value in want.items():
        if key in exact:
            assert got[key] == value, (what, key)
        else:
            assert got[key] == pytest.approx(value, **BARS[key]), (what, key)


EXACT_BC = {"folder": ("mse", "psnr", "ssim", "ergas"), "synthetic": ()}


@pytest.mark.parametrize("data", ["folder", "synthetic"])
def test_by_class_table_matches_jax(data, carried, folder_tree, shared_trunk):
    gen, variables, model = carried
    jax_cfg, cfg = _configs(data, folder_tree)
    want = jax_validate.mfe_new_validate_by_class(
        gen, variables, jax_cfg, SCALE, lpips_fn=jax_lpips.lpips_fn())
    got = validate.mfe_new_validate_by_class(
        model, cfg, SCALE, lpips_fn=lpips.lpips_fn(), device="cpu")
    classes = ["airplane", "beach", "forest"] if data == "folder" else ["all"]
    assert list(got) == list(want) == classes + ["Total"]
    for cls in want:
        _assert_row(got[cls]["sr"], want[cls]["sr"], (cls, "sr"))
        _assert_row(got[cls]["bicubic"], want[cls]["bicubic"],
                    (cls, "bicubic"), EXACT_BC[data])
    assert set(got["Total"]["sr"]) == {"mse", "psnr", "ssim", "ergas",
                                       "lpips"}


def test_table_text_and_csv_are_jax_bytes(carried, folder_tree, tmp_path,
                                          shared_trunk):
    """For the same table, the CSV and the text table are JAX's, byte for
    byte (column order, six decimals, the five text columns)."""
    gen, variables, _ = carried
    jax_cfg, _ = _configs("folder", folder_tree)
    table = jax_validate.mfe_new_validate_by_class(
        gen, variables, jax_cfg, SCALE, lpips_fn=jax_lpips.lpips_fn())
    assert (validate.format_by_class_table(table)
            == jax_validate.format_by_class_table(table))
    jax_validate.save_by_class_csv(table, str(tmp_path / "jax.csv"))
    validate.save_by_class_csv(table, str(tmp_path / "port.csv"))
    port_bytes = (tmp_path / "port.csv").read_bytes()
    assert port_bytes == (tmp_path / "jax.csv").read_bytes()
    assert port_bytes.startswith(b"class,sr_ergas,sr_lpips,sr_mse")


class _Samples:
    """One in-memory copy of a dataset, loadable by both packages' loaders
    (the JAX one passes a generator as well)."""

    def __init__(self, dataset):
        self.samples = [dataset.load(i) for i in range(len(dataset))]

    def __len__(self):
        return len(self.samples)

    def load(self, index, rng=None):
        return dict(self.samples[index])


def test_evaluator_rows_match_jax_with_a_tail_batch(carried, folder_tree,
                                                    shared_trunk):
    """Per image, the same 8 synthetic triplets on both sides, in batches
    of 3: JAX pads the tail batch of 2, the port forwards it as it is.  The
    inputs are the same, so the bicubic rows' uint8 metrics are equal."""
    gen, variables, model = carried
    _, cfg = _configs("synthetic", folder_tree)
    dataset = _Samples(build_test_dataset(cfg, SCALE))
    want = jax_validate.Evaluator(gen, variables, SCALE, jax_lpips.lpips_fn(),
                                  batch_size=3).run(dataset)
    ev = validate.Evaluator(model, SCALE, lpips.lpips_fn(), batch_size=3,
                            device="cpu")
    got = ev.run(dataset)
    assert list(got) == list(want) == ["all"]
    for side, exact in (("sr", ()), ("bc", EXACT_BC["folder"])):
        assert len(got["all"][side]) == len(want["all"][side]) == 8
        for i, (g, w) in enumerate(zip(got["all"][side], want["all"][side])):
            _assert_row(g, w, (side, i), exact)
    assert ev.stats["images"] == 8 and ev.stats["batches"] == 3
    assert ev.stats["wall"] >= ev.stats["score"] > 0


def test_mfe_new_validate_matches_jax(carried, folder_tree, shared_trunk):
    gen, variables, model = carried
    jax_cfg, cfg = _configs("folder", folder_tree)
    want = jax_validate.mfe_new_validate(gen, variables, jax_cfg, SCALE,
                                         lpips_fn=jax_lpips.lpips_fn())
    got = validate.mfe_new_validate(model, cfg, SCALE,
                                    lpips_fn=lpips.lpips_fn(), device="cpu")
    assert set(got) == {"sr", "bicubic"}
    _assert_row(got["sr"], want["sr"], "sr")
    _assert_row(got["bicubic"], want["bicubic"], "bicubic",
                EXACT_BC["folder"])


def test_save_img_writes_sr_pngs_and_panels(carried, folder_tree, tmp_path):
    _, _, model = carried
    _, cfg = _configs("folder", folder_tree)
    cfg.test_dataset = os.path.join("UCMerced_LandUse")
    out = tmp_path / "eval"
    validate.mfe_new_validate_by_class(model, cfg, SCALE, save_img=True,
                                       save_dir=str(out), device="cpu")
    for cls in ("airplane", "beach", "forest"):
        assert len(glob.glob(str(out / cls / "SR_*_x2.png"))) == 2
        assert len(glob.glob(str(out / cls / "panel_*_x2.png"))) == 2
    # the png is the SR truncated to uint8
    ds = build_test_dataset(cfg, SCALE)
    sample = ds.load(0)
    name = os.path.splitext(os.path.basename(sample["path"]))[0]
    sr = validate.Evaluator(model, SCALE, device="cpu").super_resolve(
        sample["lr"][None])[0]
    png = np.asarray(Image.open(out / "airplane" / f"SR_{name}_x2.png"))
    np.testing.assert_array_equal(
        png, (np.clip(sr, 0, 1) * 255).astype(np.uint8))


def test_save_image_needs_pillow_and_the_panel_skips_without_matplotlib(
        tmp_path, monkeypatch, capsys):
    img = np.zeros((4, 4, 3), np.float32)
    for name in ("PIL", "matplotlib"):
        monkeypatch.setitem(sys.modules, name, None)  # import raises
    with pytest.raises(ImportError, match="Pillow"):
        plotting.save_image(img, str(tmp_path / "a.png"))
    assert not plotting.plot_test_panel([img], ["SR"], None,
                                        str(tmp_path / "p.png"))
    assert "matplotlib does not import" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "p.png")
    # the old import place still works
    assert validate.save_image is plotting.save_image
    assert validate.plot_test_panel is plotting.plot_test_panel


def test_trainer_sweep_with_lpips_matches_jax(tmp_path, monkeypatch,
                                              shared_trunk):
    """The training loop's validation sweep with ``val_lpips``: the means
    of all seven metrics within 1e-5 relative of the JAX trainer's, from
    the same generator weights and the same 8 test triplets of 32^2 in
    batches of 3; the SR's SSIM, 0.01 with these weights, within 1e-6
    absolute (found 6.8e-7: float32 rounding of a mean near 0; its range
    is [-1, 1]).  (Each package's own synthetic set would not do: the
    port's twin is a few pixels one level off PIL's, test_torch_data.py,
    which moves the twin's small LPIPS by 7e-5 relative.)"""
    cfg, port_cfg = _config(tmp_path)
    _, data_cfg = _configs("synthetic", None)
    dataset = _Samples(build_test_dataset(data_cfg, SCALE))
    for module in (jax_trainer_module, trainer_module):
        monkeypatch.setattr(module, "build_test_dataset",
                            lambda data, scale: dataset)
    for c in (cfg, port_cfg):
        c.val_lpips = True
        c.data.crop_size = c.data.test_crop_size = SIZE
        c.data.test_batch_size = 3
        c.data.num_workers = 2
    jt = jax_trainer_module.Trainer(cfg)
    g_params = random_params(jax.tree.map(np.asarray, jt.state.g_params),
                             seed=6)
    jt.state = jt.state.replace(g_params=jax.tree.map(jnp.asarray, g_params))
    pt = Trainer(port_cfg, device="cpu")
    pt.generator.load_state_dict(sradsgan_state_dict(g_params))
    want = jt.validate()
    got = pt.validate()
    assert set(got) == set(want) == {"psnr", "ssim", "ergas", "bc_psnr",
                                     "bc_ssim", "lpips", "bc_lpips"}
    for key, value in want.items():
        bar = dict(abs=1e-6) if key == "ssim" else dict(rel=1e-5)
        assert got[key] == pytest.approx(value, **bar), key
