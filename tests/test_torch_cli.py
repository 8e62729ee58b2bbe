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
the bridges' dispatcher, ``validate-by-class`` runs EDSR.  The diffusion
commands: ``diffusion-train`` writes the checkpoint that
``diffusion-validate`` and ``diffusion-sample`` read, ``--gdp-config`` sets
the scale and the schedule, ``--weights`` carries a JAX UNet across, and
``--ckpt`` with ``--weights`` is refused.
"""

import json
import os
import sys

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
    # the CPU steps eagerly
    assert out["steps"] == {"eager": 1, "captured": 0, "replayed": 0}


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


# ---------------------------------------------------------------------------
# the diffusion commands, at tiny widths

UNET_TINY = {"inner_channel": 32, "channel_mults": [1, 2], "res_blocks": 1}
DIFFUSION = ["--device", "cpu", "--data", "synthetic", "--scale",
             str(SCALE), "--crop-size", "32", "--timesteps", "8",
             "--no-bf16", "--unet-kwargs", json.dumps(UNET_TINY)]


def _diffusion_trainer(run, **kwargs):
    from sradsgan_tpu_torch.diffusion.trainer import DiffusionTrainer

    cfg = DataConfig(synthetic=True, crop_size=32, test_crop_size=32)
    return DiffusionTrainer(cfg, SCALE, save_dir=str(run / "GDP"),
                            n_timestep=8, bf16=False,
                            unet_kwargs=UNET_TINY, device="cpu", **kwargs)


def _bicubic01(u8):
    """The conditioner of an ``.npy`` image: the port's 8-bit resize."""
    from sradsgan_tpu_torch.ops.resize import resize_uint8

    h, w = u8.shape[:2]
    return resize_uint8(torch.from_numpy(u8.astype(np.float32)), h * SCALE,
                        w * SCALE, "bicubic").numpy()[None] / 255.0


def _pil_bicubic01(u8):
    """The conditioner of an image Pillow opens: Pillow's resize, as the
    JAX command makes it (``sradsgan_tpu/cli.py:252-254``)."""
    pil = Image.fromarray(u8).resize((u8.shape[1] * SCALE,
                                      u8.shape[0] * SCALE), Image.BICUBIC)
    return np.asarray(pil, np.float32)[None] / 255.0


def test_diffusion_train_writes_what_validate_and_sample_read(tmp_path,
                                                              capsys):
    run = tmp_path / "run"
    assert cli.main(["diffusion-train", "--n-iter", "2", "--batch-size",
                     "2", "--save-dir", str(run)] + DIFFUSION) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["final_loss"])
    ckpt = out["ckpt"]
    assert ckpt == str(run / "GDP" / "gdp_ckpt_latest.pt")
    assert torch.load(ckpt, weights_only=True)["step"] == 2

    result_dir = tmp_path / "val"
    assert cli.main(["diffusion-validate", "--ckpt", ckpt, "--max-images",
                     "1", "--result-dir", str(result_dir), "--continuous",
                     "--save-dir", str(run)] + DIFFUSION) == 0
    val = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert val.pop("result_dir") == str(result_dir)
    assert len(val) == 10 and np.isfinite(list(val.values())).all()
    files = os.listdir(result_dir)
    assert {"2_1_plot.png", "2_1_sr_process.png"} <= set(files), files

    image, lr01 = _image(tmp_path)
    assert cli.main(["diffusion-sample", "--ckpt", ckpt, "--image", image,
                     "--out-dir", str(tmp_path / "s"), "--save-dir",
                     str(run)] + DIFFUSION) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["sr"].endswith("GDP_SR_scene_x2.png")
    got = _sr_png(line)
    trainer = _diffusion_trainer(run)
    trainer.load_checkpoint(ckpt)
    want = trainer.super_resolution(
        _pil_bicubic01(np.round(lr01 * 255).astype(np.uint8)))[0]
    np.testing.assert_array_equal(got, _truncated(want))


def test_diffusion_sample_carries_a_jax_unet_across(tmp_path, capsys,
                                                    monkeypatch):
    """``--weights``: the JAX UNet's params as ``.npz`` through
    ``unet_state_dict``; the SR is the bridged trainer's own sample, on the
    port's bicubic re-upsample, which lies within one level of PIL's (the
    JAX command's)."""
    import jax
    import jax.numpy as jnp

    from sradsgan_tpu.diffusion.unet import UNet as JaxUNet
    from sradsgan_tpu_torch.tools.from_jax import unet_state_dict
    from test_torch_diffusion import random_params

    kwargs = {**UNET_TINY, "channel_mults": (1, 2)}
    shapes = jax.eval_shape(JaxUNet(**kwargs).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 6)),
                            jnp.zeros((1,), jnp.int32))["params"]
    params = random_params(shapes, 4)
    npz = tmp_path / "unet.npz"
    save_npz(str(npz), params)
    image, lr01 = _image(tmp_path, seed=3)
    from sradsgan_tpu_torch.diffusion.trainer import DiffusionTrainer
    conditioners = []
    sample = DiffusionTrainer.super_resolution

    def keep_conditioner(self, bc01, *args, **kwargs):
        conditioners.append(bc01)
        return sample(self, bc01, *args, **kwargs)
    monkeypatch.setattr(DiffusionTrainer, "super_resolution",
                        keep_conditioner)
    assert cli.main(["diffusion-sample", "--weights", str(npz), "--image",
                     image, "--out-dir", str(tmp_path / "s"), "--save-dir",
                     str(tmp_path / "run")] + DIFFUSION) == 0
    got = _sr_png(capsys.readouterr().out.strip().splitlines()[-1])
    trainer = _diffusion_trainer(tmp_path / "run")
    trainer.unet.load_state_dict(unet_state_dict(
        params, channel_mults=(1, 2), res_blocks=1))
    # the png's conditioner is Pillow's, as in the JAX command
    bc01 = _pil_bicubic01(np.round(lr01 * 255).astype(np.uint8))
    np.testing.assert_array_equal(conditioners[0], bc01)
    want = trainer.super_resolution(bc01)[0]
    np.testing.assert_array_equal(got, _truncated(want))


def test_diffusion_gdp_config_sets_the_scale_and_schedule(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """``--gdp-config gdp_train_54_216``: x4 and 1000 linear steps from the
    config (``--scale`` and ``--timesteps`` yield to it, as in JAX), the
    UNet replaced whole by ``--unet-kwargs``."""
    from sradsgan_tpu_torch.diffusion import trainer as trainer_module

    seen = {}

    def train(self, n_iter, val_freq=0, log_freq=50):
        seen.update(scale=self.scale, n=self.sched.num_timesteps,
                    inner=self.unet.inner_channel, bf16=self.bf16)
        return 0.5

    monkeypatch.setattr(trainer_module.DiffusionTrainer, "train", train)
    assert cli.main(["diffusion-train", "--gdp-config", "gdp_train_54_216",
                     "--n-iter", "1", "--save-dir", str(tmp_path)]
                    + DIFFUSION) == 0
    assert seen == {"scale": 4, "n": 1000, "inner": 32, "bf16": False}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "final_loss"] == 0.5


@pytest.mark.parametrize("command", ["diffusion-sample",
                                     "diffusion-validate"])
def test_diffusion_commands_refuse_ckpt_with_weights(tmp_path, command):
    extra = ["--image", "x.png"] if command == "diffusion-sample" else []
    with pytest.raises(SystemExit, match="not both"):
        cli.main([command, "--ckpt", "a.pt", "--weights", "b.npz",
                  "--save-dir", str(tmp_path)] + extra + DIFFUSION)


def test_diffusion_sample_runs_without_pillow(tmp_path, monkeypatch,
                                              capsys):
    """The card's machine has no Pillow: an HWC uint8 ``.npy`` in, the SR
    as float [0, 1] ``.npy`` out, with a note on stderr; a malformed array
    is refused."""
    u8 = np.random.default_rng(5).integers(0, 256, (9, 11, 3),
                                           dtype=np.uint8)
    np.save(tmp_path / "lr.npy", u8)
    np.save(tmp_path / "bad.npy", u8.astype(np.float32))
    pil01 = _pil_bicubic01(u8)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import raises
    argv = ["diffusion-sample", "--out-dir", str(tmp_path / "s"),
            "--save-dir", str(tmp_path / "run")] + DIFFUSION
    with pytest.raises(SystemExit, match="uint8"):
        cli.main(argv + ["--image", str(tmp_path / "bad.npy")])
    assert cli.main(argv + ["--image", str(tmp_path / "lr.npy")]) == 0
    captured = capsys.readouterr()
    path = json.loads(captured.out.strip().splitlines()[-1])["sr"]
    assert path.endswith("GDP_SR_lr_x2.npy")
    assert "Pillow does not import" in captured.err
    bc01 = _bicubic01(u8)
    # the port's resize stands within one level of Pillow's
    assert np.abs(bc01 - pil01).max() * 255 <= 1.0 + 1e-4
    want = _diffusion_trainer(tmp_path / "run").super_resolution(bc01)[0]
    np.testing.assert_array_equal(np.load(path), np.clip(want, 0, 1))
