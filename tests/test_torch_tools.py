"""The port's offline tools and dry run against the JAX package's.

- ``tools/prepare_data.py``: the files and LMDB records it writes are
  byte-equal to the JAX tool's.
- ``tools/scene_classification.py``: the split is JAX's; with JAX's VGG16
  trunk carried (``tools/from_jax.py:lpips_state_dict``) the features lie
  within 1e-4 of max|ref| of JAX's, the head trained 20 Adam steps from
  JAX's initial head on the same features within 1e-4 of JAX's, and the
  accuracies and confusion matrices are equal.
- ``tools/dryrun.py``: ``entry``'s forward against ``__graft_entry__``'s
  with the weights carried, within 1e-4 of max|ref|; the dry run over two
  gloo ranks (one spawn).
"""

import filecmp
import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

import __graft_entry__  # noqa: E402
from sradsgan_tpu.tools import prepare_data as jax_prepare  # noqa: E402
from sradsgan_tpu.tools import scene_classification as jax_scene  # noqa
from sradsgan_tpu_torch.tools import dryrun, prepare_data  # noqa: E402
from sradsgan_tpu_torch.tools import scene_classification as scene  # noqa
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    generator_state_dict, lpips_state_dict, save_npz)

REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def dry_run():
    """``dryrun_multichip(2, device="cpu")`` started in a thread when the
    module starts, so that its two gloo ranks run beside the JAX work of
    the tests before :func:`test_dryrun_over_two_gloo_ranks`; what it
    prints is kept."""
    from concurrent.futures import ThreadPoolExecutor

    printed = []
    dryrun.print = lambda *args: printed.append(" ".join(map(str, args)))
    pool = ThreadPoolExecutor(1)
    future = pool.submit(dryrun.dryrun_multichip, 2, "cpu")
    yield future, printed
    future.exception()  # waits
    pool.shutdown()
    del dryrun.print


def _class_tree(root, n_classes, n_imgs, size=(36, 40)):
    """Class-coloured random pngs (one channel at 255), so that even a
    random trunk separates the classes."""
    rng = np.random.default_rng(0)
    for c in range(n_classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(n_imgs):
            arr = rng.integers(0, 255, size + (3,), dtype=np.uint8)
            arr[:, :, c % 3] = 255
            Image.fromarray(arr).save(os.path.join(d, f"img{i}.png"))
    return str(root)


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    return _class_tree(tmp_path_factory.mktemp("tree") / "src", 3, 6)


def _same_trees(a, b):
    files_a = sorted(os.path.relpath(os.path.join(r, f), a)
                     for r, _, fs in os.walk(a) for f in fs)
    files_b = sorted(os.path.relpath(os.path.join(r, f), b)
                     for r, _, fs in os.walk(b) for f in fs)
    assert files_a == files_b and files_a
    _, mismatch, errors = filecmp.cmpfiles(a, b, files_a, shallow=False)
    assert not mismatch and not errors
    return files_a


def test_prepare_triplets_writes_the_jax_files(small_tree, tmp_path):
    n = prepare_data.prepare_triplets(small_tree, str(tmp_path / "port"),
                                      32, 8, workers=3)
    assert n == jax_prepare.prepare_triplets(small_tree, str(tmp_path / "jax"),
                                             32, 8, workers=3) == 18
    files = _same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(files) == 54 and "sr_8_32/00017.png" in files


def test_iter_triplet_records_are_the_jax_records(small_tree):
    got = list(prepare_data.iter_triplet_records(small_tree, 32, 8))
    assert got == list(jax_prepare.iter_triplet_records(small_tree, 32, 8))
    assert len(got) == 3 * 18 + 1 and got[-1] == (b"length", b"18")
    assert [k for k, _ in got[:3]] == [b"hr_32_00000", b"lr_8_00000",
                                       b"sr_8_32_00000"]


def test_prepare_classdirs_writes_the_jax_files(small_tree, tmp_path):
    n = prepare_data.prepare_classdirs(small_tree, str(tmp_path / "port"),
                                       32, 4, workers=3)
    assert n == jax_prepare.prepare_classdirs(
        small_tree, str(tmp_path / "jax"), 32, 4, workers=3) == 18
    _same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_prepare_data_main_and_lmdb_without_the_package(small_tree, tmp_path,
                                                        capsys, monkeypatch):
    assert prepare_data.main(["classdirs", "--src", small_tree, "--dst",
                              str(tmp_path / "c"), "--size", "32"]) == 0
    assert capsys.readouterr().out.strip() == "processed 18 images"
    assert sorted(os.listdir(tmp_path / "c")) == ["class0", "class1",
                                                  "class2"]
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="folder layout"):
        prepare_data.main(["lmdb", "--src", small_tree, "--dst",
                           str(tmp_path / "l")])


@pytest.mark.parametrize("seed", [0, 3])
def test_split_dataset_equals_jax(seed, tmp_path):
    root = _class_tree(tmp_path / "uc", 4, 11, (8, 8))
    assert scene.split_dataset(root, seed=seed) == jax_scene.split_dataset(
        root, seed=seed)
    splits, classes = scene.split_dataset(root, seed=seed)
    assert classes == ["class0", "class1", "class2", "class3"]
    assert [len(splits[k]) for k in ("train", "val", "test")] == [28, 4, 12]


# ---------------------------------------------------------- scene classes

IMAGE, EPOCHS, SEED, PER_CLASS = 32, 20, 0, 10


class _JitInitVGG16(jax_scene.VGG16Features):
    """JAX's trunk with its ``init`` jitted: Flax's eager init of the VGG16
    costs ≈ 10 s on the CPU, the jitted one ≈ 3 s; the weights are carried
    to the port whatever they are."""

    def init(self, *args, **kwargs):
        return jax.jit(super().init)(*args, **kwargs)


def _jax_initial_head(dim, num_classes, seed):
    """The draws of JAX ``SceneClassifier.train_head``'s initial head."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"w1": np.asarray(jax.random.normal(k1, (dim, 256))
                             * (1.0 / np.sqrt(dim))),
            "b1": np.zeros(256, np.float32),
            "w2": np.asarray(jax.random.normal(k2, (256, num_classes))
                             * 0.0625),
            "b2": np.zeros(num_classes, np.float32)}


@pytest.fixture(scope="module")
def classifiers(tmp_path_factory):
    """A 3-class x 10-image tree, JAX's classifier and the port's with
    JAX's trunk, each head trained 20 steps on the port's features.  Both
    take a class's 10 images in one batch (one compile of JAX's
    features)."""
    root = _class_tree(tmp_path_factory.mktemp("scene") / "uc", 3,
                       PER_CLASS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_scene, "VGG16Features", _JitInitVGG16)
        ref = jax_scene.SceneClassifier(image_size=IMAGE,
                                        feature_batch=PER_CLASS, seed=SEED)
    trunk = jax.tree.map(np.asarray, ref.trunk_params)
    port = scene.SceneClassifier(image_size=IMAGE, feature_batch=PER_CLASS,
                                 seed=SEED, device="cpu")
    state = lpips_state_dict({"VGG16Features_0": trunk}, "vgg")
    port.trunk.load_state_dict({k[len("net."):]: v for k, v in state.items()})
    splits, _ = scene.split_dataset(root)
    files = [f for part in splits.values() for f, _ in part]
    feats = dict(zip(files, port.features(files)))
    head0 = _jax_initial_head(feats[files[0]].shape[-1], 3, SEED)
    jax_features = ref.features
    ref.features = lambda fs: np.stack([feats[f] for f in fs])
    want = ref.train_head(root, epochs=EPOCHS)
    ref.features = jax_features
    got = port.train_head(root, epochs=EPOCHS, head=head0)
    return {"root": root, "ref": ref, "port": port, "trunk": trunk,
            "files": files, "got": got, "want": want}


def test_scene_features_match_jax(classifiers):
    ref, port = classifiers["ref"], classifiers["port"]
    files = classifiers["files"][:PER_CLASS]
    want = ref.features(files)
    got = port.features(files)
    assert got.shape == want.shape == (PER_CLASS, 512)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    assert port.pretrained is False


def test_scene_head_matches_jax_after_twenty_adam_steps(classifiers):
    ref, port = classifiers["ref"], classifiers["port"]
    for key, value in ref.head.items():
        value = np.asarray(value)
        got = port.head[key].numpy()
        assert got.shape == value.shape
        assert np.abs(got - value).max() <= REL * np.abs(value).max(), key
    got, want = classifiers["got"], classifiers["want"]
    assert abs(got["train_loss"] - want["train_loss"]) <= REL * abs(
        want["train_loss"])
    assert got["val_acc"] == want["val_acc"]


def test_scene_accuracy_and_confusion_equal_jax(classifiers, tmp_path):
    ref, port = classifiers["ref"], classifiers["port"]
    png = str(tmp_path / "confusion.png")
    got = port.evaluate_folder(classifiers["root"], save_confusion=png)
    want = ref.evaluate_folder(classifiers["root"])
    assert got == want
    assert np.sum(got["confusion"]) == 30 and got["accuracy"] > 0.5
    assert os.path.getsize(png) > 0


def test_scene_trunk_file_and_cli(classifiers, tmp_path, monkeypatch,
                                  capsys):
    """The trunk read from ``SRADSGAN_TPU_VGG16_NPZ`` (JAX's ``.npz``
    layout) gives the carried trunk's features; ``main`` on the CPU."""
    path = str(tmp_path / "vgg16.npz")
    save_npz(path, classifiers["trunk"])
    monkeypatch.setenv("SRADSGAN_TPU_VGG16_NPZ", path)
    port = classifiers["port"]
    clf = scene.SceneClassifier(image_size=IMAGE, feature_batch=8,
                                device="cpu")
    assert clf.pretrained
    files = classifiers["files"][:4]
    np.testing.assert_array_equal(clf.features(files), port.features(files))
    monkeypatch.setattr(scene, "SceneClassifier", functools.partial(
        scene.SceneClassifier, image_size=IMAGE, feature_batch=8))
    out = str(tmp_path / "scene.json")
    assert scene.main(["--hr-root", classifiers["root"], "--sr-root",
                       classifiers["root"], "--out", out,
                       "--device", "cpu"]) == 0
    with open(out) as f:
        result = json.load(f)
    assert result["pretrained_trunk"] is True
    assert json.loads(capsys.readouterr().out.strip()) == result


def test_cuda_defaults_raise_without_a_card(monkeypatch):
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        scene.SceneClassifier(image_size=IMAGE)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        dryrun.dryrun_multichip(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices, have 1"):
        dryrun.dryrun_multichip(2)


# ------------------------------------------------------------- dry run


def test_entry_matches_the_jax_entry():
    """The full-width flagship of ``__graft_entry__.entry`` (both gains set
    to 0.5, so the global attention counts) carried into the port's entry
    model: the zero image and a random one within 1e-4 of max|ref|."""
    forward, (variables, x) = __graft_entry__.entry()
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.full(v.shape, 0.5, np.float32)
                      if p[-1].key == "gamma" else np.asarray(v)),
        variables["params"])
    variables = {"params": params}
    port_forward, (model, zeros) = dryrun.entry(device="cpu")
    assert not model.training and zeros.shape == (1, 3, 54, 54)
    model.load_state_dict(generator_state_dict("sradsgan", variables))
    image = np.random.default_rng(0).random((1, 54, 54, 3), dtype=np.float32)
    jitted = jax.jit(forward)
    for lr in (np.array(x), image):
        want = np.asarray(jitted(variables, jnp.asarray(lr)))
        got = port_forward(model, torch.from_numpy(lr).permute(0, 3, 1, 2))
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (1, 216, 216, 3)
        assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_dryrun_over_two_gloo_ranks(dry_run):
    future, lines = dry_run
    out = future.result()
    assert len(lines) == 2
    assert lines[0] == f"dryrun_multichip(2) ok: {out['gan']}"
    assert lines[1] == (f"dryrun_multichip(2) diffusion ok: "
                        f"loss={out['diffusion']:.4f}")
    assert sorted(out["gan"]) == ["adv_g", "content", "loss_D", "loss_G",
                                  "pixel"]
    assert all(np.isfinite(v) for v in out["gan"].values())


def test_dryrun_runs_on_the_cards_where_jax_runs_a_cpu_mesh(tmp_path):
    """A JAX-side gap: JAX's dry run forces its virtual CPU mesh
    (``jax_platforms`` = "cpu") whatever the machine holds; the port's runs
    NCCL ranks on the cards, gloo only when asked for the CPU."""
    import inspect

    src = inspect.getsource(__graft_entry__.dryrun_multichip)
    assert 'jax.config.update("jax_platforms", "cpu")' in src
    cuda = dryrun.dry_spec(4, "cuda", str(tmp_path))
    os.makedirs(tmp_path / "cpu")
    cpu = dryrun.dry_spec(2, "cpu", str(tmp_path / "cpu"))
    assert (cuda["device"], cuda["backend"]) == ("cuda", "nccl")
    assert (cpu["device"], cpu["backend"]) == ("cpu", "gloo")
    assert cuda["scenarios"][0]["batch"] == 8
    with open(cuda["scenarios"][0]["config"]) as f:
        cfg = json.load(f)
    assert cfg["num_devices"] == 4 and cfg["data"]["crop_size"] == 16
    assert cfg["model_kwargs"] == {"n_groups": 1, "n_blocks": 1}
