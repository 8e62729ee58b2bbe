"""NDSRGAN generator in PyTorch (NCHW): 23 doubly-dense DCRDB blocks, a
nearest-neighbour + conv upsample.

Counterpart of ``sradsgan_tpu/models/ndsrgan.py``: a dense block is 4
conv + LeakyReLU(0.2) layers over the running concat and a fuse conv,
``x + 0.2 * out``; a DCRDB three dense blocks fed 0.2-scaled running sums
and a conv, ``0.2 * out + x``; block i of the trunk takes ``x + 0.2 *
(m_1 + ... + m_{i-1})``.  Module names follow the reference's
``state_dict`` (``conv1.0``, ``DCRDB_block.DRRDB{k}.RDB{r}.CL_blocks.{j}.0``,
``.RDB{r}.conv``, ``DRRDB{k}.conv``, ``conv2``, ``upsampling.1``,
``conv3.{0,2}``), which ``import_reference.import_ndsrgan`` reads.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import torch
from torch import nn

from sradsgan_tpu_torch.nn.blocks import (ConvBlock, NearestConvUpsample,
                                          conv, materialize)

# NDSRGAN's 4x4 stride-2 markovian patch D: (out_filters, stride, normalize)
NDSRGAN_D_BLOCKS: Tuple[Tuple[int, int, bool], ...] = (
    (64, 2, False), (128, 2, True), (256, 2, True), (512, 1, True),
)


class DenseBlock(nn.Module):
    """``CL_blocks``: conv + LeakyReLU(0.2) layers, each over the concat of
    the input and the layers before; ``conv`` fuses; ``x + 0.2 * out``."""

    def __init__(self, nf: int, nc: int, n_layers: int = 4):
        super().__init__()
        self.CL_blocks = nn.ModuleList(
            ConvBlock(nf + i * nc, nc, "lrelu") for i in range(n_layers))
        self.conv = conv(nf + n_layers * nc, nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        start = x
        for layer in self.CL_blocks:
            x = torch.cat([x, layer(x)], dim=1)
        return start + 0.2 * self.conv(x)


class DCRDB(nn.Module):
    def __init__(self, nf: int, nc: int):
        super().__init__()
        self.RDB1 = DenseBlock(nf, nc)
        self.RDB2 = DenseBlock(nf, nc)
        self.RDB3 = DenseBlock(nf, nc)
        self.conv = conv(nf, nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.RDB1(x)
        out2 = self.RDB2(x + 0.2 * out1)
        out3 = self.RDB3(x + 0.2 * out1 + 0.2 * out2)
        out4 = self.conv(x + 0.2 * out1 + 0.2 * out2 + 0.2 * out3)
        return 0.2 * out4 + x


class NDSRGANGenerator(nn.Module):
    """(B, num_channels, H, W) -> (B, num_channels, sH, sW), weights drawn
    as the JAX package inits them."""

    def __init__(self, scale: int = 4, num_channels: int = 3, nf: int = 64,
                 nc: int = 32, n_dcrdb: int = 23, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        with torch.device("meta"):  # skip torch's default init
            self.conv1 = ConvBlock(num_channels, nf)
            self.DCRDB_block = nn.Sequential(OrderedDict(
                (f"DRRDB{k + 1}", DCRDB(nf, nc)) for k in range(n_dcrdb)))
            self.conv2 = conv(nf, nf)
            self.upsampling = NearestConvUpsample(nf, scale, "lrelu")
            self.conv3 = nn.Sequential(conv(nf, nf), nn.LeakyReLU(0.2),
                                       conv(nf, num_channels))
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        acc = out
        for block in self.DCRDB_block:  # 0.2-scaled running sum
            acc = acc + 0.2 * block(acc)
        out = out + self.conv2(acc)
        return self.conv3(self.upsampling(out))
