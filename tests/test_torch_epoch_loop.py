"""The port's epoch loop against the JAX package's, with ``validate``
scripted on both sides: the plateau backtrack (reload, halvings, rewind,
history pops), the best-checkpoint saves, the lr-floor stop and the step
decay."""

import itertools
import os

import pytest

torch = pytest.importorskip("torch")

from sradsgan_tpu.train import trainer as jax_trainer_module  # noqa: E402
from sradsgan_tpu.train.state import get_lr as jax_get_lr  # noqa: E402
from sradsgan_tpu_torch.train.state import get_lr  # noqa: E402
from sradsgan_tpu_torch.train.trainer import Trainer  # noqa: E402
from test_torch_train_loop import _both_configs  # noqa: E402

JaxTrainer = jax_trainer_module.Trainer


def _scripted(values):
    def validate(max_batches=None):
        v = next(values)
        return {"psnr": v, "ssim": v / 100, "ergas": 100.0 - v,
                "bc_psnr": 30.0, "bc_ssim": 0.9}
    return validate


@pytest.mark.parametrize("rewind", [True, False])
def test_epoch_loop_follows_the_jax_trainer(monkeypatch, tmp_path, rewind):
    """With ``validate`` scripted on both sides (a steadily worsening run,
    as tests/test_train.py:138-186 scripts it): the same sequence of
    validated epochs (so the same best epoch and the same rewinds), the
    same best-checkpoint saves, G and D learning rates (the D's halves at
    the third plateau only) and history lengths, down to the lr-floor stop
    (raised to 5e-5 to keep the run short).  The lr starts at 3e-4, so that no
    halving lands on the 1e-4 threshold of the D's rule (see
    test_discriminator_lr_rule_at_the_threshold)."""
    cfg, port_cfg = _both_configs(tmp_path)
    for c in (cfg, port_cfg):
        c.optim.plateau_patience = 2
        c.optim.plateau_rewind = rewind
        c.optim.lr = 3e-4
        c.optim.lr_floor = 5e-5  # three plateaus: 1.5e-4, 7.5e-5, 3.75e-5
        c.num_epochs = 5 if rewind else 9
        c.data.synthetic_size = 4  # one step per epoch

    seen = {"jax": [], "port": []}
    saves = {"jax": [], "port": []}

    def spy_log(side, original):
        def log(mode, results):
            if mode == "val":
                seen[side].append(results["epoch"])
            return original(mode, results)
        return log

    jt = JaxTrainer(cfg)
    monkeypatch.setattr(jt, "validate", _scripted(
        30.0 - 0.5 * i for i in itertools.count()))
    monkeypatch.setattr(jt.logger, "print_format_results",
                        spy_log("jax", jt.logger.print_format_results))
    save_pytree = jax_trainer_module.save_pytree

    def spy_save(path, tree):
        if path.endswith("ckpt_best"):
            saves["jax"].append(seen["jax"][-1])
        return save_pytree(path, tree)

    monkeypatch.setattr(jax_trainer_module, "save_pytree", spy_save)
    jt.train()

    pt = Trainer(port_cfg, device="cpu")
    monkeypatch.setattr(pt, "validate", _scripted(
        30.0 - 0.5 * i for i in itertools.count()))
    monkeypatch.setattr(pt.logger, "print_format_results",
                        spy_log("port", pt.logger.print_format_results))
    save_best = pt._save_best
    monkeypatch.setattr(pt, "_save_best", lambda path: (
        saves["port"].append(seen["port"][-1]), save_best(path)))
    pt.train()

    assert seen["port"] == seen["jax"]
    assert saves["port"] == saves["jax"] == [0, 1, 2]
    if rewind:  # 3 and 4 plateau -> back to best epoch 2 + 1
        assert seen["port"][:6] == [0, 1, 2, 3, 4, 3]
    assert get_lr(pt.g_opt) == pytest.approx(jax_get_lr(jt.state.g_opt),
                                             rel=1e-6)
    assert get_lr(pt.d_opt) == pytest.approx(jax_get_lr(jt.state.d_opt),
                                             rel=1e-6)
    assert get_lr(pt.d_opt) > get_lr(pt.g_opt)
    assert ({k: len(v) for k, v in pt.history.items()}
            == {k: len(v) for k, v in jt.history.items()})
    assert os.path.exists(os.path.join(port_cfg.model_dir, "ckpt_best.pt"))
    logs = os.path.join(port_cfg.model_dir, "logs")
    with open(os.path.join(logs, "val_log.txt")) as f:
        assert len(f.readlines()) == len(seen["port"])


def test_discriminator_lr_rule_at_the_threshold(monkeypatch, tmp_path):
    """The D lr halves only when the G lr before its halving is under 1e-4
    (the reference tests ``self.lr < 0.0001`` on a Python float).  From
    2e-4 the second plateau finds exactly 1e-4, which is not under it: to
    a floor of 4e-5 the G lr takes three halvings, the D lr one.  (The JAX
    trainer keeps its lr as a float32 in the optimizer state, reads
    9.99999975e-05 there and halves the D once more; the port keeps the
    reference's arithmetic.)"""
    _, port_cfg = _both_configs(tmp_path)
    port_cfg.optim.plateau_patience = 2
    port_cfg.optim.lr = 2e-4
    port_cfg.optim.lr_floor = 4e-5
    port_cfg.num_epochs = 5
    port_cfg.data.synthetic_size = 4
    pt = Trainer(port_cfg, device="cpu")
    monkeypatch.setattr(pt, "validate", _scripted(
        30.0 - 0.5 * i for i in itertools.count()))
    pt.train()
    assert get_lr(pt.g_opt) == pytest.approx(2e-4 / 2 ** 3)
    assert get_lr(pt.d_opt) == pytest.approx(2e-4 / 2)


def test_step_decay_halves_the_generator_lr(monkeypatch, tmp_path):
    _, port_cfg = _both_configs(tmp_path)
    port_cfg.optim.step_decay_epochs = 1
    port_cfg.num_epochs = 2
    port_cfg.data.synthetic_size = 4
    pt = Trainer(port_cfg, device="cpu")
    monkeypatch.setattr(pt, "validate", _scripted(
        30.0 + i for i in itertools.count()))
    pt.train()
    assert get_lr(pt.g_opt) == pytest.approx(port_cfg.optim.lr / 4)
    assert get_lr(pt.d_opt) == port_cfg.optim.lr
    for epoch in (0, 1):
        assert os.path.exists(os.path.join(port_cfg.model_dir,
                                           f"ckpt_epoch_{epoch}.pt"))
