"""EDSR generator in PyTorch (NCHW): a deep residual CNN, pixel loss only.

Counterpart of ``sradsgan_tpu/models/edsr.py``: a conv head, 32 ReLU
residual blocks without norm, a mid conv with the global skip, the shared
sub-pixel upsample (LeakyReLU 0.01) and a conv out, at 256 filters.  Module
names follow the reference's ``state_dict`` (``input_conv.conv``,
``residual_layers.{i}.conv1``, ``mid_conv.conv``, ``upsampling.0``,
``output_conv.conv``), which ``import_reference.import_edsr`` reads.
"""

from __future__ import annotations

import torch
from torch import nn

from sradsgan_tpu_torch.nn.blocks import (ConvLayer, ResBlock, UpsampleHead,
                                          materialize)


class EDSR(nn.Module):
    """(B, num_channels, H, W) -> (B, num_channels, sH, sW), weights drawn
    as the JAX package inits them (``nn.blocks.materialize``)."""

    def __init__(self, scale: int = 4, num_channels: int = 3,
                 base_filters: int = 256, num_residuals: int = 32, *,
                 seed: int = 0, device: torch.device | str = "cpu"):
        super().__init__()
        f = base_filters
        with torch.device("meta"):  # skip torch's default init
            self.input_conv = ConvLayer(num_channels, f)
            self.residual_layers = nn.Sequential(
                *(ResBlock(f) for _ in range(num_residuals)))
            self.mid_conv = ConvLayer(f, f)
            self.upsampling = UpsampleHead(f, scale)
            self.output_conv = ConvLayer(f, num_channels)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.input_conv(x)
        x = self.mid_conv(self.residual_layers(x)) + x
        return self.output_conv(self.upsampling(x))
