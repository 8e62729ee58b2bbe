"""The weights of a run, made by the benchmark from ``--seed`` on the card.

Both sides get the same tensors: the program loads them into its networks
by name, the reference into its own.  They are drawn in one large normal
draw and one uniform draw on a ``torch.Generator`` of the device, in the
order of the reference's ``state_dict``:

- convolution, dense and MLP kernels normal(0, 0.02), the published init
  of the generators and the discriminator, and VGG19's normal(0,
  fan_in^-1/2);
- biases, and any other leaf not named below, normal(0, 0.02), so that
  every bias takes part;
- by the kind of module that holds them: BatchNorm scale one, shift zero,
  fresh running statistics; LayerNorm and GroupNorm gain one, shift zero;
- both global-attention gains ``gamma`` uniform in [0.25, 0.75]: the
  published init leaves them at 0, and SGAM and CGAM would count for
  nothing.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

WEIGHT_STD = 0.02
GAMMA_RANGE = (0.25, 0.75)
NORMS = (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)

# sub-streams of a run's seed
STREAMS = {"generator": 1, "discriminator": 2, "vgg": 3, "data": 4,
           "alpha": 5, "requests": 6, "sample": 7}


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    seq = np.random.SeedSequence([int(seed) & (2 ** 63 - 1),
                                  STREAMS[stream]])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_weights(model: nn.Module, seed: int, stream: str,
                 fan_in_std: bool = False) -> Dict[str, torch.Tensor]:
    """A state dict for ``model`` (the reference network, on the device
    the weights go to), drawn from the run's seed."""
    state = model.state_dict()
    device = next(iter(state.values())).device
    gen = torch.Generator(device).manual_seed(sub_seed(seed, stream))
    drawn = [k for k, v in state.items()
             if v.is_floating_point() and _kind(model, k) == "normal"]
    flat = torch.randn(sum(state[k].numel() for k in drawn),
                       generator=gen, device=device)
    out = {}
    for k, part in zip(drawn, flat.split([state[k].numel() for k in drawn])):
        t = state[k]
        std = (t[0].numel() ** -0.5 if fan_in_std and t.dim() > 1
               else WEIGHT_STD)
        out[k] = (part * std).view_as(t)
    gammas = [k for k in state if _kind(model, k) == "gamma"]
    lo, hi = GAMMA_RANGE
    u = torch.rand(len(gammas), generator=gen, device=device)
    for k, v in zip(gammas, u):
        out[k] = (lo + (hi - lo) * v).reshape(1)
    for k, t in state.items():
        kind = _kind(model, k)
        if kind == "one":
            out[k] = torch.ones_like(t)
        elif kind == "zero":
            out[k] = torch.zeros_like(t)
    return out


def _kind(model: nn.Module, key: str) -> str:
    """How a state dict entry is made: "normal", "gamma", "one" or
    "zero"."""
    prefix, _, leaf = key.rpartition(".")
    if leaf == "gamma":
        return "gamma"
    owner = model.get_submodule(prefix) if prefix else model
    if isinstance(owner, NORMS):
        return "one" if leaf in ("weight", "running_var") else "zero"
    return "normal"
