"""The port's ``cli infer`` and ``cli train`` flags against what the JAX
command does, on the CPU at tiny widths.

``infer --ckpt`` reads the checkpoints ``cli train`` writes (the trainer's
``save_checkpoint`` and its ``ckpt_best.pt``) and writes the generator's own
SR, truncated to uint8 as the reference does; ``infer`` forwards an image of
any size as it is, as JAX ``Evaluator.super_resolve`` does (weights carried
across by ``tools/from_jax.py``); ``train --lpips`` trains, the flag only
feeding the final table that JAX prints after training; ``--ckpt`` and
``--weights`` together are refused.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from sradsgan_tpu.evaluation.validate import (  # noqa: E402
    Evaluator as JaxEvaluator)
from sradsgan_tpu.models.sradsgan import (  # noqa: E402
    SRADSGANGenerator as JaxGenerator)
from sradsgan_tpu_torch import cli, models  # noqa: E402
from sradsgan_tpu_torch.evaluation.tiled import forward_numpy  # noqa: E402
from sradsgan_tpu_torch.evaluation.validate import Evaluator  # noqa: E402
from sradsgan_tpu_torch.serving import Predictor  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    save_npz, sradsgan_state_dict)
from sradsgan_tpu_torch.train import trainer as trainer_module  # noqa: E402
from test_torch_sradsgan import random_params  # noqa: E402

SCALE = 2
TINY = dict(base_filters=16, n_groups=1, n_blocks=1)
INFER = ["infer", "--device", "cpu", "--model", "sradsgan", "--scale",
         str(SCALE), "--model-kwargs", json.dumps(TINY)]
TRAIN = ["train", "--device", "cpu", "--data", "synthetic", "--scale",
         str(SCALE), "--crop-size", "16", "--batch-size", "4", "--no-bf16",
         "--model-kwargs", json.dumps(TINY)]
SHAPE = (20, 26)  # no bucket and not square


def _image(tmp_path, seed=0):
    """A (20, 26) RGB png and its float [0, 1] pixels."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, SHAPE + (3,), dtype=np.uint8)
    path = tmp_path / "scene.png"
    Image.fromarray(u8).save(path)
    return str(path), u8.astype(np.float32) / 255.0


def _sr_png(out):
    return np.asarray(Image.open(json.loads(out)["sr"]))


def _truncated(sr01):
    return (np.clip(sr01, 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny trainer whose generator is moved off its seeded init, and the
    two kinds of checkpoint it writes."""
    run = tmp_path_factory.mktemp("run")
    cfg = models.config_for_model("sradsgan", SCALE, bf16=False,
                                  save_dir=str(run), model_kwargs=TINY)
    cfg.data.synthetic = True
    trainer = trainer_module.Trainer(cfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in trainer.generator.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    best = run / "ckpt_best.pt"
    trainer._save_best(str(best))
    return trainer.generator.eval(), [trainer.save_checkpoint(0), str(best)]


@pytest.mark.parametrize("which", ["epoch", "best"])
def test_infer_reads_what_train_writes(trained, tmp_path, capsys, which):
    generator, ckpts = trained
    image, lr01 = _image(tmp_path)
    ckpt = ckpts[which == "best"]
    assert cli.main(INFER + ["--image", image, "--ckpt", ckpt,
                             "--out-dir", str(tmp_path / "out")]) == 0
    got = _sr_png(capsys.readouterr().out.strip().splitlines()[-1])
    want = forward_numpy(generator, lr01[None], "cpu")[0]
    assert got.shape == (SHAPE[0] * SCALE, SHAPE[1] * SCALE, 3)
    np.testing.assert_array_equal(got, _truncated(want))
    # and not the seeded init's SR: the checkpoint was read
    seeded = forward_numpy(models.create_generator(
        "sradsgan", SCALE, **TINY).eval(), lr01[None], "cpu")[0]
    assert not np.array_equal(got, _truncated(seeded))


@pytest.fixture(scope="module")
def carried():
    """JAX generator params drawn from a seed, and the port's generator
    holding them (``tools/from_jax.py``)."""
    gen = JaxGenerator(scale=SCALE, **TINY)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 12, 12, 3)))["params"]
    params = random_params(shapes, seed=3)
    model = models.create_generator("sradsgan", SCALE, **TINY)
    model.load_state_dict(sradsgan_state_dict(params))
    return gen, params, model.eval()


def test_infer_forwards_an_image_off_every_bucket_as_jax_does(carried,
                                                               tmp_path,
                                                               capsys):
    gen, params, model = carried
    image, lr01 = _image(tmp_path, seed=1)
    want = JaxEvaluator(gen, {"params": params}, SCALE).super_resolve(
        lr01[None])
    got = Evaluator(model, SCALE, device="cpu").super_resolve(lr01[None])
    assert got.shape == want.shape == (1, 40, 52, 3)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err
    # the fault this closes: the serving path pads to a bucket of 54 and
    # crops, and the attention over the padding moves the SR (0.45 of
    # max |ref| on this input)
    padded = Predictor(model, SCALE, device="cpu")(lr01)
    assert float(np.abs(padded - want[0]).max()) > 0.1 * np.abs(want).max()
    npz = tmp_path / "g.npz"
    save_npz(str(npz), params)
    assert cli.main(INFER + ["--image", image, "--weights", str(npz),
                             "--out-dir", str(tmp_path / "out")]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    np.testing.assert_array_equal(_sr_png(out), _truncated(got[0]))


def test_train_with_lpips_trains(tmp_path, monkeypatch, capsys):
    """In JAX ``--lpips`` only reaches the by-class table after training;
    here that table is not ported, so the flag reaches nothing."""
    seen = []
    init = trainer_module.Trainer.__init__

    def spy(self, cfg, *args, **kwargs):
        seen.append(cfg.val_lpips)
        init(self, cfg, *args, **kwargs)
    monkeypatch.setattr(trainer_module.Trainer, "__init__", spy)
    assert cli.main(TRAIN + ["--lpips", "--no-final-eval", "--steps", "1",
                             "--save-dir", str(tmp_path / "run")]) == 0
    assert seen == [False]
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(list(out["final"].values())).all()


def test_infer_refuses_ckpt_with_weights(tmp_path):
    image, _ = _image(tmp_path)
    with pytest.raises(SystemExit, match="not both"):
        cli.main(INFER + ["--image", image, "--ckpt", "a.pt", "--weights",
                          "b.npz"])
