"""DRCAN generator in PyTorch (NCHW): RCAN with 5 residual groups of 10
RCABs, channel-attention reduction 4.

Counterpart of ``sradsgan_tpu/models/drcan.py``.  Module names follow the
reference's ``state_dict`` (``head.0``; ``body.{g}.body.{b}.body.{0,2}``
convs and ``.body.3.conv_du.{0,2}`` the CALayer; ``body.{g}.body.{10}`` the
group conv; ``body.5`` the trunk conv; ``tail.0.{0,2}`` the upsampler's
convs, one a stage, no activation; ``tail.1`` the conv out), which
``import_reference.import_drcan`` reads.
"""

from __future__ import annotations

import torch
from torch import nn

from sradsgan_tpu_torch.nn.attention import CALayer
from sradsgan_tpu_torch.nn.blocks import UpsampleHead, conv, materialize


class RCAB(nn.Module):
    """``body`` = conv, ReLU, conv, CALayer; plus the input."""

    def __init__(self, features: int, reduction: int):
        super().__init__()
        self.body = nn.Sequential(conv(features, features), nn.ReLU(),
                                  conv(features, features),
                                  CALayer(features, reduction))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class ResidualGroup(nn.Module):
    """``body`` = ``n_resblocks`` RCABs and a conv; plus the input."""

    def __init__(self, features: int, reduction: int, n_resblocks: int):
        super().__init__()
        self.body = nn.Sequential(
            *(RCAB(features, reduction) for _ in range(n_resblocks)),
            conv(features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class DRCAN(nn.Module):
    """(B, num_channels, H, W) -> (B, num_channels, sH, sW), weights drawn
    as the JAX package inits them."""

    def __init__(self, scale: int = 4, num_channels: int = 3,
                 n_feats: int = 64, n_resgroups: int = 5,
                 n_resblocks: int = 10, reduction: int = 4, *,
                 seed: int = 0, device: torch.device | str = "cpu"):
        super().__init__()
        f = n_feats
        with torch.device("meta"):  # skip torch's default init
            self.head = nn.Sequential(conv(num_channels, f))
            self.body = nn.Sequential(
                *(ResidualGroup(f, reduction, n_resblocks)
                  for _ in range(n_resgroups)),
                conv(f, f))
            self.tail = nn.Sequential(
                UpsampleHead(f, scale, activation=None, share_stages=False),
                conv(f, num_channels))
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x)
        return self.tail(self.body(x) + x)
