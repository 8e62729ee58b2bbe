"""The port's CLI against what the JAX command does, on the CPU at tiny
widths.

``infer --ckpt`` reads the checkpoints ``cli train`` writes (the trainer's
``save_checkpoint`` and its ``ckpt_best.pt``) and writes the generator's own
SR, truncated to uint8 as the reference does; ``infer`` forwards an image of
any size as it is, as JAX ``Evaluator.super_resolve`` does (weights carried
across by ``tools/from_jax.py``); ``--ckpt`` and ``--weights`` together are
refused.  ``validate`` and ``validate-by-class`` print what the evaluation
functions return (their parity with JAX is ``test_torch_eval.py``), the
latter also the CSV; ``train`` prints the by-class table after training,
with LPIPS where ``--lpips`` asks; ``chain-train`` hands each scale the
previous one's checkpoint.  The other models of the zoo: ``list-models``
lists the eight, ``infer --weights`` maps a JAX SRAGAN's variables through
the bridges' dispatcher, ``validate-by-class`` runs EDSR.
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
from sradsgan_tpu_torch.config import DataConfig  # noqa: E402
from sradsgan_tpu_torch.evaluation.tiled import forward_numpy  # noqa: E402
from sradsgan_tpu_torch.evaluation.validate import (  # noqa: E402
    Evaluator, mfe_new_validate, mfe_new_validate_by_class, save_by_class_csv)
from sradsgan_tpu_torch.losses.lpips import lpips_fn  # noqa: E402
from sradsgan_tpu_torch.serving import Predictor  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    generator_state_dict, save_npz, sradsgan_state_dict)
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
    """As in JAX, ``--lpips`` only reaches the by-class table after
    training, never the training's own config."""
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


VALIDATE = ["--device", "cpu", "--data", "synthetic", "--scale", str(SCALE),
            "--model-kwargs", json.dumps(TINY)]


def test_validate_prints_what_mfe_new_validate_returns(carried, tmp_path,
                                                       capsys):
    _, params, model = carried
    npz = tmp_path / "g.npz"
    save_npz(str(npz), params)
    assert cli.main(["validate"] + VALIDATE + [
        "--crop-size", "16", "--weights", str(npz), "--save-dir",
        str(tmp_path / "run")]) == 0
    got = json.loads(capsys.readouterr().out)
    cfg = DataConfig(synthetic=True, crop_size=16, test_crop_size=16)
    assert got == mfe_new_validate(model, cfg, SCALE, device="cpu")
    assert set(got["sr"]) == {"mse", "psnr", "ssim", "ergas"}


def test_validate_by_class_prints_the_table_and_writes_the_csv(
        carried, tmp_path, capsys, monkeypatch):
    """With ``--lpips`` and no trunk weights: the ``lpips*`` note, the
    five-column table ending in Total, and a CSV with the LPIPS columns,
    the bytes of ``save_by_class_csv`` of the same call made directly."""
    monkeypatch.delenv("SRADSGAN_TPU_ALEXNET_NPZ", raising=False)
    _, params, model = carried
    npz = tmp_path / "g.npz"
    save_npz(str(npz), params)
    run = tmp_path / "run"
    assert cli.main(["validate-by-class"] + VALIDATE + [
        "--crop-size", "32", "--lpips", "--weights", str(npz),
        "--save-dir", str(run)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "uncalibrated lpips*" in lines[0]
    assert lines[1].split() == ["class", "PSNR", "SSIM", "ERGAS", "bcPSNR",
                                "bcSSIM"]
    assert [line.split()[0] for line in lines[2:4]] == ["all", "Total"]
    csv = run / "SRADSGAN_x2" / "by_class_x2.csv"
    assert lines[4] == f"table saved: {csv}"
    cfg = DataConfig(synthetic=True, crop_size=32, test_crop_size=32)
    table = mfe_new_validate_by_class(model, cfg, SCALE,
                                      lpips_fn=lpips_fn(), device="cpu")
    save_by_class_csv(table, str(tmp_path / "direct.csv"))
    assert csv.read_bytes() == (tmp_path / "direct.csv").read_bytes()
    assert csv.read_text().startswith(
        "class,sr_ergas,sr_lpips,sr_mse,sr_psnr,sr_ssim,bc_ergas,bc_lpips,")


@pytest.mark.parametrize("command", ["validate", "validate-by-class"])
def test_eval_commands_refuse_ckpt_with_weights(command):
    with pytest.raises(SystemExit, match="not both"):
        cli.main([command] + VALIDATE + ["--ckpt", "a.pt", "--weights",
                                         "b.npz"])


def test_train_prints_the_by_class_table_after_training(tmp_path, capsys):
    """Without ``--no-final-eval``, as every reference main does: the
    final JSON line, then (``--lpips``) the note and the table of the
    trained generator over the synthetic test set."""
    argv = [a if a != "16" else "32" for a in TRAIN]  # LPIPS needs 32^2
    assert cli.main(argv + ["--lpips", "--steps", "1", "--save-dir",
                            str(tmp_path / "run")]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "final" in json.loads(lines[-5])
    assert "uncalibrated lpips*" in lines[-4]
    assert lines[-3].split()[:4] == ["class", "PSNR", "SSIM", "ERGAS"]
    assert [line.split()[0] for line in lines[-2:]] == ["all", "Total"]
    assert np.isfinite([float(v) for v in lines[-1].split()[1:]]).all()


def test_chain_train_hands_each_scale_the_previous_checkpoint(
        tmp_path, monkeypatch, capsys):
    """``--scales 2 3``: x3 starts from the checkpoint x2 wrote (here its
    last epoch's: a one-step run writes no ckpt_best.pt), with every
    tensor of the same shape taken from it."""
    seen = []
    init = trainer_module.Trainer.__init__

    def spy(self, cfg, *args, **kwargs):
        init(self, cfg, *args, **kwargs)
        seen.append((cfg.scale, cfg.init_from,
                     {k: v.clone() for k, v in
                      self.generator.state_dict().items()}))
    monkeypatch.setattr(trainer_module.Trainer, "__init__", spy)
    run = tmp_path / "run"
    argv = ["chain-train", "--scales", "2", "3", "--steps", "1", "--epochs",
            "1", "--device", "cpu", "--data", "synthetic", "--crop-size",
            "24", "--batch-size", "2", "--no-bf16", "--model-kwargs",
            json.dumps(TINY), "--save-dir", str(run)]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    ckpt = str(run / "SRADSGAN_x2" / "ckpt_epoch_0.pt")
    assert [(s, f) for s, f, _ in seen] == [(2, None), (3, ckpt)]
    assert f"scale x2 done; next init_from={ckpt}" in out
    assert set(json.loads(out[-1])) == {"x2", "x3"}
    x2 = torch.load(ckpt, weights_only=True)["generator"]
    x3 = seen[1][2]
    same = [k for k in x3 if x3[k].shape == x2[k].shape]
    assert len(same) == len(x3) - 2  # all but the upsample conv
    for key in same:
        assert torch.equal(x3[key], x2[key]), key


def test_list_models_lists_the_eight_ported_models(capsys):
    assert cli.main(["list-models"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    # tests register tiny twins named "*_port" (test_torch_trainer.py keeps
    # its own for the worker's life)
    assert [line.split() for line in lines
            if not line.split()[0].endswith("_port")] == [
        ["amssrn", "pixel"], ["drcan", "GAN(wgan-gp)"], ["dssr", "pixel"],
        ["edsr", "pixel"], ["hat", "pixel"], ["ndsrgan", "GAN(lsgan)"],
        ["sradsgan", "GAN(wgan-gp)"], ["sragan", "GAN(wgan-gp)"],
        ["srgan", "GAN(lsgan)"]]


def test_infer_weights_of_a_jax_sragan_go_through_the_dispatcher(tmp_path,
                                                                 capsys):
    """``--model sragan --weights``: JAX variables with their BatchNorm
    statistics, as ``.npz``, mapped by ``generator_state_dict``; the SR
    png is the truncated uint8 of JAX ``Evaluator.super_resolve``'s SR
    within 1e-4 of max|ref| (equal where no value sits at a uint8 step)."""
    from test_torch_zoo import jax_variables

    gen, variables = jax_variables("sragan", SCALE)
    image, lr01 = _image(tmp_path, seed=2)
    want = JaxEvaluator(gen, variables, SCALE).super_resolve(lr01[None])[0]
    npz = tmp_path / "sragan.npz"
    save_npz(str(npz), variables)
    tiny = {"base_filters": 16, "n_groups": 2, "n_blocks": 2}
    assert cli.main(["infer", "--device", "cpu", "--model", "sragan",
                     "--scale", str(SCALE), "--model-kwargs",
                     json.dumps(tiny), "--image", image, "--weights",
                     str(npz), "--out-dir", str(tmp_path / "out")]) == 0
    got = _sr_png(capsys.readouterr().out.strip().splitlines()[-1])
    model = models.create_generator("sragan", SCALE, **tiny)
    model.load_state_dict(generator_state_dict("sragan", variables))
    sr = Evaluator(model, SCALE, device="cpu").super_resolve(lr01[None])[0]
    assert float(np.abs(sr - want).max()) <= 1e-4 * float(
        np.abs(want).max())
    np.testing.assert_array_equal(got, _truncated(sr))
    near = np.abs(np.clip(want, 0, 1) * 255 - np.round(
        np.clip(want, 0, 1) * 255)) < 1e-2
    np.testing.assert_array_equal(got[~near], _truncated(want)[~near])


def test_validate_by_class_runs_a_pixel_model(tmp_path, capsys):
    """``validate-by-class --model edsr``: EDSR's seeded generator, its
    table and its CSV under ``EDSR_x2``, the bytes of the direct call's."""
    tiny = {"base_filters": 8, "num_residuals": 1}
    run = tmp_path / "run"
    assert cli.main(["validate-by-class", "--device", "cpu", "--data",
                     "synthetic", "--scale", str(SCALE), "--crop-size", "16",
                     "--model", "edsr", "--model-kwargs", json.dumps(tiny),
                     "--save-dir", str(run)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[0] for line in lines[1:3]] == ["all", "Total"]
    csv = run / "EDSR_x2" / "by_class_x2.csv"
    cfg = DataConfig(synthetic=True, crop_size=16, test_crop_size=16)
    table = mfe_new_validate_by_class(
        models.create_generator("edsr", SCALE, **tiny), cfg, SCALE,
        device="cpu")
    save_by_class_csv(table, str(tmp_path / "direct.csv"))
    assert csv.read_bytes() == (tmp_path / "direct.csv").read_bytes()
