"""ESRGAN-family blocks and the two alternative generators (NCHW).

Counterpart of ``sradsgan_tpu/nn/esrgan.py``: the residual dense block, the
residual-in-residual dense block, the ESRGAN generator ``RRDBNet`` and
``SRResNet`` (MSRResNet), which the reference keeps beside its models but no
main trains.  Every conv is 3x3, stride 1, SAME, with a bias; LeakyReLU
slope 0.2; the upsamplers are sub-pixel with a conv of their own per stage,
as JAX's ``UpsampleHead`` by default.  Weights as the JAX package inits
them (kernels normal(0.02), biases zero), drawn from ``seed``; JAX weights
arrive through ``tools/from_jax.py:rrdbnet_state_dict`` and
``srresnet_state_dict``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.blocks import (ConvBlock, ResBlock, UpsampleHead,
                                          conv, materialize)


class ResidualDenseBlock5C(nn.Module):
    """conv1..conv4 (``gc`` each, LeakyReLU, each on the concatenation of
    the input and the earlier outputs), conv5 back to ``nf``; x + 0.2 *
    conv5."""

    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i + 1}", conv(nf + i * gc, gc))
        self.conv5 = conv(nf + 4 * gc, nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = x
        for i in range(4):
            y = F.leaky_relu(getattr(self, f"conv{i + 1}")(feats), 0.2)
            feats = torch.cat([feats, y], dim=1)
        return x + 0.2 * self.conv5(feats)


class RRDB(nn.Module):
    """Three residual dense blocks ``RDB1..3``; x + 0.2 * their output."""

    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nf, gc)
        self.RDB2 = ResidualDenseBlock5C(nf, gc)
        self.RDB3 = ResidualDenseBlock5C(nf, gc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + 0.2 * self.RDB3(self.RDB2(self.RDB1(x)))


class RRDBNet(nn.Module):
    """ESRGAN generator: ``conv_first``, ``nb`` RRDBs (``trunk``),
    ``trunk_conv``, the skip from ``conv_first``, the sub-pixel upsampler
    (LeakyReLU after each stage), ``HRconv`` (LeakyReLU), ``conv_last``."""

    def __init__(self, scale: int = 4, num_channels: int = 3, nf: int = 64,
                 nb: int = 23, gc: int = 32, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        with torch.device("meta"):  # skip torch's default init
            self.conv_first = conv(num_channels, nf)
            self.trunk = nn.Sequential(*(RRDB(nf, gc) for _ in range(nb)))
            self.trunk_conv = conv(nf, nf)
            self.upsampling = UpsampleHead(nf, scale, "lrelu",
                                           share_stages=False)
            self.HRconv = ConvBlock(nf, nf, "lrelu")
            self.conv_last = ConvBlock(nf, num_channels)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = self.conv_first(x)
        fea = fea + self.trunk_conv(self.trunk(fea))
        return self.conv_last(self.HRconv(self.upsampling(fea)))


class SRResNet(nn.Module):
    """MSRResNet: ``conv_first`` (LeakyReLU), ``nb`` residual blocks
    (conv, LeakyReLU, conv, plus the input) in ``body``, ``trunk_conv``,
    the skip from ``conv_first``, the sub-pixel upsampler (LeakyReLU after
    each stage), ``conv_last``."""

    def __init__(self, scale: int = 4, num_channels: int = 3, nf: int = 64,
                 nb: int = 16, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        with torch.device("meta"):  # skip torch's default init
            self.conv_first = ConvBlock(num_channels, nf, "lrelu")
            self.body = nn.Sequential(*(ResBlock(nf, "lrelu")
                                        for _ in range(nb)))
            self.trunk_conv = ConvBlock(nf, nf)
            self.upsampling = UpsampleHead(nf, scale, "lrelu",
                                           share_stages=False)
            self.conv_last = ConvBlock(nf, num_channels)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = self.conv_first(x)
        fea = fea + self.trunk_conv(self.body(fea))
        return self.conv_last(self.upsampling(fea))
