"""SRGAN generator in PyTorch (NCHW): 16 BatchNorm residual blocks, a 9x9
head and tail, tanh output.

Counterpart of ``sradsgan_tpu/models/srgan.py``.  The two x2 stages of the
upsample share one conv and one BatchNorm, as the reference appends one
[conv, bn, shuffle, relu] list per stage, so in train mode the shared
BatchNorm's running statistics update once a stage (twice a forward at x4).
Module names follow the reference's ``state_dict`` (``conv1.0``,
``res_blocks.{i}.conv_block.{0,1,3,4}``, ``conv2.{0,1}``,
``upsampling.{0,1}``, ``conv3.0``), which ``import_reference.import_srgan``
reads.
"""

from __future__ import annotations

import torch
from torch import nn

from sradsgan_tpu_torch.nn.blocks import (ConvBlock, UpsampleHead, conv,
                                          materialize)
from sradsgan_tpu_torch.nn.norm import BatchNorm2d


class ResidualBlock(nn.Module):
    """``conv_block`` = conv, BN, ReLU, conv, BN; plus the input."""

    def __init__(self, features: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            conv(features, features), BatchNorm2d(features), nn.ReLU(),
            conv(features, features), BatchNorm2d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class SRGANGenerator(nn.Module):
    """(B, num_channels, H, W) -> (B, num_channels, sH, sW) in [-1, 1],
    weights drawn as the JAX package inits them."""

    def __init__(self, scale: int = 4, num_channels: int = 3,
                 base_filters: int = 64, num_residuals: int = 16, *,
                 seed: int = 0, device: torch.device | str = "cpu"):
        super().__init__()
        f = base_filters
        with torch.device("meta"):  # skip torch's default init
            self.conv1 = ConvBlock(num_channels, f, "relu", kernel_size=9)
            self.res_blocks = nn.Sequential(
                *(ResidualBlock(f) for _ in range(num_residuals)))
            self.conv2 = ConvBlock(f, f, norm="batch")
            self.upsampling = UpsampleHead(f, scale, "relu", norm="batch")
            self.conv3 = ConvBlock(f, num_channels, kernel_size=9)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(x)
        out = out1 + self.conv2(self.res_blocks(out1))
        return torch.tanh(self.conv3(self.upsampling(out)))
