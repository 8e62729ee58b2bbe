"""SRAGAN generator in PyTorch (NCHW): local CA-SA attention blocks, global
CAM/PAM attention, a BatchNorm'd sub-pixel upsample and a tanh output.

Counterpart of ``sradsgan_tpu/models/sragan.py``: a conv head (LeakyReLU
0.01); 12 groups of 5 BasicBlocks, each conv (LeakyReLU 0.2), conv, then the
CLAM + SLAM + 1x1 tail with its residual, then LeakyReLU 0.2, except the
last block of a group, which has neither activation; a group-level tail and
skip; conv2 + BatchNorm with the global skip; CGAM then SGAM then a 1x1 conv
(the flagship's ``GlobalAttention``, whose SGAM is the attention kernel at
d_qk 8, d_v 64); one up conv and one BatchNorm shared by the stages (their
running statistics update once a stage); a conv out and tanh.

The blocks and groups subclass the port's ``LocalAttention``, as the
flagship's RAB and ResGroup do, so their 72 tails go through
``LocalAttention.tail``: ``rab_tail="fused"`` sends them to the fused
RAB-tail op over the same ``state_dict``.  Module names follow the
reference's (``conv1.0``, ``res_blocks.{g}.blocks.{b}.conv1.conv``,
``.ca.fc1``, ``.sa.conv1``, ``.conv``, ``res_blocks.{g}.last_conv``,
``conv2.{0,1}``, ``ca.gamma``, ``sa.query_conv``, ``conv``,
``upsampling.{0,1}``, ``conv3.0``), which ``import_reference.import_sragan``
reads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.attention import GlobalAttention, LocalAttention
from sradsgan_tpu_torch.nn.blocks import (ConvBlock, ConvLayer, UpsampleHead,
                                          materialize)


class BasicAttentionBlock(LocalAttention):
    """conv1 (with ``activation``), conv2, the CA-SA tail plus the input,
    then LeakyReLU 0.2 when ``activation`` is "lrelu"."""

    def __init__(self, features: int, activation: Optional[str] = "lrelu",
                 rab_tail: str = "unfused"):
        super().__init__(features, rab_tail)
        self.conv1 = ConvLayer(features, features, activation)
        self.conv2 = ConvLayer(features, features)
        self.post_activation = activation == "lrelu"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.tail(self.conv2(self.conv1(x)), x)
        return F.leaky_relu(out, 0.2) if self.post_activation else out


class SRAGANGroup(LocalAttention):
    """``blocks`` (n - 1 activated BasicBlocks), ``last_conv`` (one without
    activations), the group's CA-SA tail plus the input."""

    def __init__(self, features: int, n_blocks: int,
                 rab_tail: str = "unfused"):
        super().__init__(features, rab_tail)
        self.blocks = nn.Sequential(
            *(BasicAttentionBlock(features, "lrelu", rab_tail)
              for _ in range(n_blocks - 1)))
        self.last_conv = BasicAttentionBlock(features, None, rab_tail)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.last_conv(self.blocks(x)), x)


class SRAGANGenerator(GlobalAttention):
    """(B, num_channels, H, W) -> (B, num_channels, sH, sW) in [-1, 1],
    weights drawn as the JAX package inits them (the gains ``gamma``
    zero).  The global attention's ``ca``, ``sa`` and ``conv`` are the
    generator's own, as in the reference's ``state_dict``; ``ga_mode``
    composes them by the grammar (``nn/attention.py``), always with the
    conv, as JAX's ``SRAGANGenerator`` does; the groups stay 'CA-SA'."""

    def __init__(self, scale: int = 4, num_channels: int = 3,
                 base_filters: int = 64, n_groups: int = 12,
                 n_blocks: int = 5, ga_mode: str = "CA-SA",
                 rab_tail: str = "unfused", *,
                 seed: int = 0, device: torch.device | str = "cpu"):
        f = base_filters
        with torch.device("meta"):  # skip torch's default init
            super().__init__(f, ga_mode)
            self.conv1 = ConvBlock(num_channels, f, "lrelu01")
            self.res_blocks = nn.ModuleList(
                SRAGANGroup(f, n_blocks, rab_tail) for _ in range(n_groups))
            self.conv2 = ConvBlock(f, f, norm="batch")
            self.upsampling = UpsampleHead(f, scale, "lrelu01",
                                           norm="batch")
            self.conv3 = ConvBlock(f, num_channels)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(x)
        out = out1
        for group in self.res_blocks:
            out = group(out)
        out = super().forward(out1 + self.conv2(out))
        return torch.tanh(self.conv3(self.upsampling(out)))
