"""Optimizers of a GAN train step, counterpart of
``sradsgan_tpu/train/state.py``: one Adam for the generator and one for the
discriminator, with the learning rate readable and settable between steps
(the plateau controller halves it).  A trainer whose step replays from a
CUDA graph builds them ``capturable``: the same update, its bias correction
computed on the device from a step count kept there."""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   b1: float, b2: float,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam(lr, (b1, b2), eps 1e-8): optax.adam's update, bias-corrected."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8,
                            capturable=capturable)


def set_capturable(opt: torch.optim.Optimizer, capturable: bool) -> None:
    """Make a loaded state the one :func:`make_optimizer` built with
    ``capturable``: a state dict carries the flag of the optimizer that
    saved it, and a capturable Adam keeps its step count beside the
    parameter, the other on the CPU."""
    for group in opt.param_groups:
        group["capturable"] = capturable
        for p in group["params"]:
            state = opt.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(
                    p.device if capturable else "cpu", torch.float32)


def get_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
