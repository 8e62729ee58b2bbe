"""BatchNorm with torch semantics, computed in float32.

Counterpart of ``sradsgan_tpu/nn/norm.py``, which reproduces torch's
``BatchNorm2d``: train mode normalizes by the biased batch variance and
updates ``running_var`` with the unbiased one, with torch momentum 0.1 (Flax
momentum 0.9).  Here that is ``nn.BatchNorm2d`` itself; the only addition is
that statistics and normalization run in float32 whatever the input's dtype
(autocast included), and the output returns to the input's dtype, as the
JAX discriminator's f32 BatchNorm chain does under bf16 convs.
"""

from __future__ import annotations

import torch
from torch import nn

from sradsgan_tpu_torch.ops import plain_dtype


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (its defaults are the reference's: momentum 0.1,
    eps 1e-5) computed in float32 (float64 for a float64 input)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return super().forward(x.to(plain_dtype(x))).to(x.dtype)
