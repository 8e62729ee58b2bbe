"""DSSR generator in PyTorch (NCHW): wide-activation blocks, and one shared
upsample head applied to the head conv's output and to every group's, the
upsampled maps summed.

Counterpart of ``sradsgan_tpu/models/dssr.py``: 3 groups of 10 WABs (a 4x
wide conv pair with ReLU between, then the "Avg"-only channel gate, which
runs no pool kernel), a group conv and skip.  Module names follow the
reference's ``state_dict`` (``conv1.0``, ``res_groups.{g}.RG.{b}.conv1``,
``.ca.fc1``, ``res_groups.{g}.conv``, ``UP.upsampling.0``, ``conv3.0``),
which ``import_reference.import_dssr`` reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.attention import ChannelGate
from sradsgan_tpu_torch.nn.blocks import (ConvBlock, UpsampleHead, conv,
                                          materialize)


class WAB(nn.Module):
    """Wide-activation block: conv1 to 4C, ReLU, conv2 back to C, the
    average-pool channel gate ``ca``; plus the input."""

    def __init__(self, features: int, expand: int = 4):
        super().__init__()
        self.conv1 = conv(features, expand * features)
        self.conv2 = conv(expand * features, features)
        self.ca = ChannelGate(features, pool_mode="Avg")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ca(self.conv2(F.relu(self.conv1(x)))) + x


class DSSRGroup(nn.Module):
    """``RG``: ``n_blocks`` WABs, then ``conv``; plus the input."""

    def __init__(self, features: int, n_blocks: int):
        super().__init__()
        self.RG = nn.Sequential(*(WAB(features) for _ in range(n_blocks)))
        self.conv = conv(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.RG(x)) + x


class _UP(nn.Module):
    """The reference's ``UP`` holder of the shared upsample head."""

    def __init__(self, features: int, scale: int):
        super().__init__()
        self.upsampling = UpsampleHead(features, scale, activation=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.upsampling(x)


class DSSR(nn.Module):
    """(B, num_channels, H, W) -> (B, num_channels, sH, sW), weights drawn
    as the JAX package inits them."""

    def __init__(self, scale: int = 4, num_channels: int = 3,
                 n_feats: int = 64, n_groups: int = 3, n_blocks: int = 10,
                 *, seed: int = 0, device: torch.device | str = "cpu"):
        super().__init__()
        f = n_feats
        with torch.device("meta"):  # skip torch's default init
            self.conv1 = ConvBlock(num_channels, f)
            self.res_groups = nn.ModuleList(
                DSSRGroup(f, n_blocks) for _ in range(n_groups))
            self.UP = _UP(f, scale)
            self.conv3 = ConvBlock(f, num_channels)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        out_all = self.UP(out)
        for group in self.res_groups:
            out = group(out)
            out_all = out_all + self.UP(out)
        return self.conv3(out_all)
