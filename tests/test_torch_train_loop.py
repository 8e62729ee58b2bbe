"""The port's training entry point against the JAX package's: a two-epoch
run on the same in-memory triplets, the validation sweep, chain
initialization, and the ``train`` command.  The epoch loop's control flow
with a scripted validation is in ``test_torch_epoch_loop.py``."""

import importlib.util
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.core.checkpoint import (  # noqa: E402
    partial_restore as jax_partial_restore)
from sradsgan_tpu.core.config import load_config as jax_load_config  # noqa
from sradsgan_tpu.core.config import save_config as jax_save_config  # noqa
from sradsgan_tpu.models.sradsgan import (  # noqa: E402
    SRADSGANGenerator as JaxG)
from sradsgan_tpu.train import trainer as jax_trainer_module  # noqa: E402
from sradsgan_tpu_torch import cli, models  # noqa: E402
from sradsgan_tpu_torch.config import load_config, save_config  # noqa
from sradsgan_tpu_torch.data.datasets import SyntheticDataset  # noqa: E402
from sradsgan_tpu_torch.losses import gan as gan_losses  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    discriminator_state_dict, sradsgan_state_dict, vgg19_state_dict)
from sradsgan_tpu_torch.train import trainer as trainer_module  # noqa: E402
from sradsgan_tpu_torch.train.trainer import Trainer, partial_restore  # noqa
from test_torch_logging import read_events  # noqa: E402
from test_torch_sradsgan import random_params  # noqa: E402
from test_torch_trainer import D_BLOCKS, _config, _fields, _gains  # noqa

JaxTrainer = jax_trainer_module.Trainer
TINY = dict(base_filters=16, n_groups=1, n_blocks=1)


def _both_configs(tmp_path, **model_kwargs):
    """The tiny registered model of test_torch_trainer.py (x2, crop 16,
    float32) with the same data and epoch-loop fields on both sides."""
    cfg, port_cfg = _config(tmp_path)
    for c, save_dir in ((cfg, tmp_path / "jax"), (port_cfg, tmp_path / "pt")):
        c.save_dir = str(save_dir)
        c.model_kwargs = dict(TINY, **model_kwargs)
        c.data.synthetic = True
        c.data.synthetic_size = 8
        c.data.crop_size = c.data.test_crop_size = 16
        c.data.batch_size = c.data.test_batch_size = 4
        c.data.num_workers = 2
        c.sample_interval = 0
    return cfg, port_cfg


class _Memory:
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def load(self, index, rng=None):
        return dict(self.samples[index])


def test_two_epochs_match_the_jax_trainer(monkeypatch, tmp_path):
    """Two epochs of two steps and their validation sweeps, the fused RAB
    tail on both sides, from the same weights, the same in-memory triplets
    and the same penalty weights (lr 2e-3 and fan-in weights, so that
    the metrics move: PSNR 6.05 -> 8.17 dB).  Tolerances: the weights after
    four Adam steps agree to about 1e-4 (tests/test_torch_trainer.py), and
    the metrics are taken on uint8-truncated images, where one pixel of
    6 x 3 x 16 x 16 crossing a level moves the PSNR by some 1e-3 dB: PSNR
    within 5e-3 dB, SSIM within 1e-4, ERGAS within 0.1 % (found: 5e-7 dB,
    6e-8, 6e-8 relative)."""
    monkeypatch.setenv("SRADSGAN_TPU_RAB_TAIL", "fused")
    cfg, port_cfg = _both_configs(tmp_path, rab_tail="fused")
    cfg.model_kwargs = dict(TINY)  # JAX selects the fused tail by the env
    for c in (cfg, port_cfg):
        c.num_epochs = 2
        c.sample_interval = 3
        c.optim.lr = 2e-3

    train = _Memory([SyntheticDataset(8, 2, 16).load(i) for i in range(8)])
    test = _Memory([SyntheticDataset(6, 2, 16, "bilinear", 99).load(i)
                    for i in range(6)])
    for module in (jax_trainer_module, trainer_module):
        monkeypatch.setattr(module, "build_train_dataset",
                            lambda data, scale: train)
        monkeypatch.setattr(module, "build_test_dataset",
                            lambda data, scale: test)
    alpha = np.random.default_rng(11).random((4, 1, 1, 1)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(alpha))
    monkeypatch.setattr(gan_losses, "interpolation_weights",
                        lambda b, g, device: torch.from_numpy(alpha))

    jt = JaxTrainer(cfg)
    # fan-in weights: order-one outputs, so the truncated metrics move
    g_params = _gains(random_params(
        jax.tree.map(np.asarray, jt.state.g_params), seed=2), 0.5)
    jt.state = jt.state.replace(
        g_params=jax.tree.map(jnp.asarray, g_params),
        g_opt=jt.g_opt_tx.init(jax.tree.map(jnp.asarray, g_params)))
    d_vars = {"params": jax.tree.map(np.asarray, jt.state.d_params),
              "batch_stats": jax.tree.map(np.asarray, jt.state.d_stats)}
    pt = Trainer(port_cfg, device="cpu")
    pt.generator.load_state_dict(sradsgan_state_dict(g_params))
    pt.discriminator.load_state_dict(discriminator_state_dict(d_vars,
                                                              D_BLOCKS))
    pt.vgg.load_state_dict(vgg19_state_dict(
        jax.tree.map(np.asarray, jt.vgg_params)))

    want = jt.train()
    got = pt.train()
    assert pt.step == 4
    assert set(got) == set(want) == {"psnr", "ssim", "ergas", "bc_psnr",
                                     "bc_ssim"}
    for epoch in range(2):
        assert pt.history["psnr"][epoch] == pytest.approx(
            jt.history["psnr"][epoch], abs=5e-3)
        assert pt.history["ssim"][epoch] == pytest.approx(
            jt.history["ssim"][epoch], abs=1e-4)
        assert pt.history["ergas"][epoch] == pytest.approx(
            jt.history["ergas"][epoch], rel=1e-3)
        for key in ("loss_G", "loss_D"):
            assert pt.history[key][epoch] == pytest.approx(
                jt.history[key][epoch], rel=5e-4, abs=1e-4)
    for key in ("bc_psnr", "bc_ssim"):  # no network in these two
        assert got[key] == pytest.approx(want[key], rel=1e-5)
    assert pt.history["psnr"][0] != pt.history["psnr"][1]
    assert pt.feed_stats["epoch_s"] >= pt.feed_stats["feed_wait_s"] >= 0
    with open(os.path.join(port_cfg.model_dir, "logs", "loss_log.txt")) as f:
        assert "bc_psnr" in f.read()  # the sample_interval line, at step 3
    if None in (importlib.util.find_spec(m)
                for m in ("tensorboardX", "tensorboard")):
        return  # neither side writes events, or they cannot be read
    # the sample images of step 3: the same HR and bicubic pictures, SRs
    # within one uint8 level
    jt.logger.writer.close()
    got, want = (read_events(os.path.join(c.model_dir, "logs"))["images"]
                 for c in (port_cfg, cfg))
    assert set(got) == set(want) == {f"sample/sr_hr_bicubic/{i}"
                                     for i in range(3)}
    for tag, events in want.items():
        (step, width, height, png), = events
        (p_step, p_width, p_height, p_png), = got[tag]
        assert (p_step, p_width, p_height) == (step, width, height) == (
            3, 16, 16)
        if not tag.endswith("/0"):
            assert p_png == png, tag
    from PIL import Image
    sr = [np.asarray(Image.open(io.BytesIO(events[0][3])), np.int16)
          for events in (got["sample/sr_hr_bicubic/0"],
                         want["sample/sr_hr_bicubic/0"])]
    assert np.abs(sr[0] - sr[1]).max() <= 1


def test_validate_counts_each_image_once(tmp_path):
    """A tail batch (8 images in batches of 3) weighs by its true size, and
    max_batches caps the sweep."""
    _, port_cfg = _both_configs(tmp_path)
    port_cfg.data.synthetic_size = 64  # the test set is an eighth of it
    port_cfg.data.test_batch_size = 3
    pt = Trainer(port_cfg, device="cpu")
    whole = pt.validate()
    ds = trainer_module.build_test_dataset(port_cfg.data, port_cfg.scale)
    assert len(ds) == 8
    samples = [ds.load(i) for i in range(8)]
    batch = {k: np.stack([s[k] for s in samples]) for k in ("lr", "hr", "bc")}
    each = {k: v.numpy() for k, v in pt._eval_step(batch).items()}
    for key, value in whole.items():
        assert value == pytest.approx(float(each[key].mean()), rel=1e-5), key
    capped = pt.validate(max_batches=2)
    assert capped["psnr"] == pytest.approx(float(each["psnr"][:6].mean()),
                                           rel=1e-5)
    assert pt.generator.training  # the sweep leaves the mode as it was


def test_partial_restore_keeps_what_the_jax_one_keeps():
    """Chain init x2 -> x4: the same tensors restored and re-initialized as
    by the JAX package's partial_restore (only the upsample conv differs
    between the two scales' trees)."""
    kw = dict(base_filters=16, n_groups=1, n_blocks=1)
    shapes = {s: jax.eval_shape(
        JaxG(scale=s, **kw).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 8, 8, 3), jnp.float32))["params"]
        for s in (2, 3)}
    source = jax.tree.map(lambda s: np.ones(s.shape, np.float32), shapes[2])
    target = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes[3])
    merged, kept, skipped = jax_partial_restore(target, source)
    want = sradsgan_state_dict(merged)

    src = models.create_generator("sradsgan", 2, **kw)
    dst = models.create_generator("sradsgan", 3, **kw)
    with torch.no_grad():
        for p in src.parameters():
            p.fill_(1.0)
        for p in dst.parameters():
            p.zero_()
    assert partial_restore(dst, src.state_dict()) == (kept, skipped)
    assert skipped == 2 and kept == len(want) - 2
    for name, value in dst.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(),
                                      err_msg=name)
    # a name the source lacks counts as re-initialized
    state = src.state_dict()
    del state["conv3.0.bias"]
    assert partial_restore(dst, state) == (kept - 1, skipped + 1)


def test_chain_init_warm_starts_the_next_scale(tmp_path, capsys):
    cfg2 = models.config_for_model("sradsgan", 2, bf16=False,
                                   save_dir=str(tmp_path), model_kwargs=TINY)
    first = Trainer(cfg2, device="cpu")
    for name, buf in first.discriminator.named_buffers():
        if name.endswith("running_mean"):
            buf.fill_(0.25)
    path = first.save_checkpoint(0)
    cfg3 = models.config_for_model("sradsgan", 3, bf16=False, seed=5,
                                   save_dir=str(tmp_path), model_kwargs=TINY,
                                   init_from=path)
    capsys.readouterr()
    second = Trainer(cfg3, device="cpu")
    out = capsys.readouterr().out
    n = len(list(second.generator.parameters()))
    assert f"kept {n - 2} leaves, re-initialized 2" in out
    fresh = models.create_generator("sradsgan", 3, seed=5, **TINY)
    a, b, c = (m.state_dict() for m in (first.generator, second.generator,
                                        fresh))
    for name in b:
        if name.startswith("GAB_UP.upsampling"):
            torch.testing.assert_close(b[name], c[name], rtol=0, atol=0)
        else:
            torch.testing.assert_close(b[name], a[name], rtol=0, atol=0)
    for (name, p), q in zip(first.discriminator.named_parameters(),
                            second.discriminator.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
    # the D's running statistics stay fresh, as in the JAX package
    means = [b for n, b in second.discriminator.named_buffers()
             if n.endswith("running_mean")]
    assert means and all(float(b.abs().max()) == 0 for b in means)


CLI_ARGS = ["train", "--device", "cpu", "--data", "synthetic", "--scale", "2",
            "--crop-size", "16", "--batch-size", "4", "--no-bf16",
            "--model-kwargs", json.dumps(dict(TINY, rab_tail="fused"))]


def test_cli_train_runs_two_steps(tmp_path, capsys):
    save_dir = tmp_path / "run"
    assert cli.main(CLI_ARGS + ["--steps", "2", "--no-final-eval",
                                "--save-dir", str(save_dir)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(list(out["final"].values())).all()
    assert {"loss_G", "loss_D"} <= set(out["final"])
    assert 0 <= out["feed"]["feed_share"] <= 1
    # a second run archives the first one's directory instead of mixing
    stale = save_dir / "SRADSGAN_x2" / "stale.txt"
    stale.write_text("from the first run")
    assert cli.main(CLI_ARGS + ["--steps", "1", "--no-final-eval",
                                "--save-dir", str(save_dir)]) == 0
    archived = [p for p in save_dir.iterdir() if "_archived_" in p.name]
    assert len(archived) == 1 and (archived[0] / "stale.txt").exists()


def test_cli_train_one_epoch_writes_the_run_directory(tmp_path, capsys):
    cfg = models.config_for_model("sradsgan", 2, bf16=False,
                                  save_dir=str(tmp_path / "run"),
                                  model_kwargs=dict(TINY, rab_tail="fused"))
    cfg.data.synthetic = True
    cfg.data.synthetic_size = 8
    cfg.data.crop_size = cfg.data.test_crop_size = 16
    cfg.data.batch_size = cfg.data.test_batch_size = 4
    cfg.num_epochs = 1
    path = tmp_path / "cfg.json"
    jax_like = jax_load_config  # the port reads what the JAX package writes
    path.write_text(json.dumps(_fields_tree(cfg)))
    assert _fields(load_config(str(path))) == _fields(cfg)
    assert jax_like(str(path)).data.crop_size == 16
    assert cli.main(["train", "--device", "cpu", "--config", str(path),
                     "--no-final-eval"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["final"]) == {"psnr", "ssim", "ergas", "bc_psnr",
                                 "bc_ssim"}
    assert np.isfinite(list(out["final"].values())).all()
    run = tmp_path / "run" / "SRADSGAN_x2"
    for name in ("ckpt_best.pt", "ckpt_epoch_0.pt", "logs/val_log.txt"):
        assert (run / name).exists(), name


def _fields_tree(cfg):
    import dataclasses
    return {f.name: (_fields_tree(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def test_load_config_reads_a_jax_config_and_ignores_the_tpu_knobs(tmp_path):
    from sradsgan_tpu.core.config import config_for_model as jax_config
    cfg = jax_config("sradsgan", 4)
    cfg.steps_per_call = 4
    cfg.data.crop_size = 64
    cfg.optim.plateau_patience = 3
    path = tmp_path / "jax.json"
    jax_save_config(cfg, str(path))
    path.write_text("// a comment line\n" + path.read_text())
    got = load_config(str(path))
    assert got.data.crop_size == 64 and got.optim.plateau_patience == 3
    assert got.data.train_datasets == cfg.data.train_datasets
    assert not hasattr(got, "steps_per_call")
    want = _fields(cfg)
    assert _fields(got) == {k: want[k] for k in _fields(got)}


@pytest.mark.parametrize("where", ["top", "data"])
def test_load_config_refuses_an_unknown_key(tmp_path, where):
    """Only the JAX package's two TPU knobs are ignored: a misspelt key
    raises instead of silently leaving the default in place."""
    raw = {"scale": 4, "data": {"crop_size": 64, "device_degrade": True}}
    (raw if where == "top" else raw["data"])["crop_sise"] = 32
    path = tmp_path / "typo.json"
    path.write_text(json.dumps(raw))
    with pytest.raises(ValueError, match="crop_sise"):
        load_config(str(path))


def test_save_config_round_trips_through_both_packages(tmp_path):
    """The port's ``save_config`` writes what its own ``load_config`` and
    the JAX package's read back: every field the two configs share."""
    from sradsgan_tpu.core.config import load_config as jax_load
    cfg = models.config_for_model("sradsgan", 3, model_kwargs=TINY)
    cfg.data.crop_size = 48
    cfg.optim.step_decay_epochs = 7
    cfg.val_lpips = True
    path = tmp_path / "port.json"
    save_config(cfg, str(path))
    got = load_config(str(path))
    assert _fields(got) == _fields(cfg)
    assert got.data.train_datasets == cfg.data.train_datasets
    jax_cfg = jax_load(str(path))
    want = _fields(jax_cfg)
    assert _fields(cfg) == {k: want[k] for k in _fields(cfg)}
