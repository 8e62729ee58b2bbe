"""Model FLOPs of a step and of a request, counted with the formulas of
``torch.utils.flop_counter`` (``FlopCounterMode``'s table) over the plain
reference on the meta device, so that the count is the model's and does
not change with what implements the step.  The counting mode is the
table's own dispatch without ``FlopCounterMode``'s module hooks, which
refuse the penalty's gradient of an input."""

from __future__ import annotations

import functools
from typing import Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from port_bench.harness import (adversarial, build_generator,
                                build_reference, reference_path)
from port_bench.reference.models import build
from port_bench.reference.step import pixel_only, wgan_gp


class FlopCount(TorchDispatchMode):
    """Adds up the FLOPs of every operator the table knows."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.total += count(*args, **kwargs, out_val=out)
        return out


def train_step_flops(config: Mapping, batch: int, lr_size: int) -> int:
    """FLOPs of one step of the reference at (batch, lr_size), by the
    configuration's recipe: the G step's forward and backward, and for
    WGAN-GP the D step with the penalty's double backward; Adam's
    elementwise updates are not counted."""
    scale = config["scale"]
    with torch.device("meta"):
        lr = torch.empty(batch, 3, lr_size, lr_size)
        hr = torch.empty(batch, 3, lr_size * scale, lr_size * scale)
        alpha = torch.empty(batch, 1, 1, 1)
    g = build_generator(config, "meta").train()
    if not adversarial(config):
        with FlopCount() as counter:
            pixel_only(g, config["recipe"], lr, hr)
        return int(counter.total)
    d = build("discriminator", "meta").train()
    vgg = build("vgg", "meta").requires_grad_(False)
    with FlopCount() as counter:
        wgan_gp(g, d, vgg, config["recipe"], lr, hr, alpha)
    return int(counter.total)


@functools.lru_cache(maxsize=None)
def _forward_flops(reference: Optional[str], model: str, widths: Tuple,
                   b: int, h: int, w: int) -> int:
    g = build_reference(reference, model, "meta", dict(widths)).eval()
    with FlopCount() as counter, torch.no_grad():
        g(torch.empty(b, 3, h, w, device="meta"))
    return int(counter.total)


def forward_flops(config: Mapping, b: int, h: int, w: int) -> int:
    """FLOPs of the reference generator's forward at (b, h, w)."""
    return _forward_flops(reference_path(config), config["model"],
                          tuple(sorted(config["widths"].items())), b, h, w)
