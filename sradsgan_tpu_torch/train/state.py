"""Optimizers of a GAN train step, counterpart of
``sradsgan_tpu/train/state.py``: one Adam for the generator and one for the
discriminator, with the learning rate readable and settable between steps
(the plateau controller halves it)."""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   b1: float, b2: float) -> torch.optim.Adam:
    """Adam(lr, (b1, b2), eps 1e-8): optax.adam's update, bias-corrected."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)


def get_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
