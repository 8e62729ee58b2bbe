"""AMSSRN generator in PyTorch (NCHW): multi-scale dense blocks, quadrant
non-local attention and an FPN fusion of the trunk's taps.

Counterpart of ``sradsgan_tpu/models/amssrn.py``:

- RB: ``x + conv3X3(x) + rb(x)``, ``rb`` = conv, PReLU, conv;
- DB: four chained RBs, the concat of the input and their outputs through a
  PReLU CALayer (reduction 16) and a 1x1 conv, plus the input; DB_ASPP
  (the second half of the trunk) concats the RBs' outputs alone and runs
  them first through ASPP: three dilated convs (1, 2, 3), each through the
  one PReLU ``act`` the reference shares between them;
- a non-local block shared by the four spatial quadrants: 1x1 ``g``,
  ``theta``, ``phi`` to C / 8, the unscaled softmax of theta . phi^T in plain
  ``matmul`` and ``softmax`` (JAX computes it outside any kernel too), and
  a zero-init 1x1 ``W`` back to C, plus the input;
- the gain ``gamma`` (zero init) on the first non-local output, added to
  each block's output; an FPN over the 11 taps (head, non-local, 8 blocks,
  the second non-local) and a 1x1 feature bank, plus the head; a per-stage
  sub-pixel upsample without activation, and a conv out.

Module names follow the reference's ``state_dict`` (``head.0``, ``gamma``,
``non_local_1.non_local.{g,theta,phi,W}``, ``body.{i}.c{1..4}.conv3X3``,
``.rb.{0,1,2}``, ``body.{i}.ca.conv_du.{0,1,2}``, ``body.{i}.aspp.d{1,2,3}``,
``.aspp.act``, ``body.{i}.c5``, ``fpn_fusion.fusion.{k}``,
``feature_bank``, ``tail.{0,2}``, ``reconstruction``), which
``import_reference.import_amssrn`` reads.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from sradsgan_tpu_torch.nn.attention import CALayer
from sradsgan_tpu_torch.nn.blocks import (ConvBlock, PReLU, UpsampleHead,
                                          conv, materialize)


class RB(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv3X3 = conv(features, features)
        self.rb = nn.Sequential(conv(features, features), PReLU(),
                                conv(features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv3X3(x) + self.rb(x)


class ASPP(nn.Module):
    """Dilated convs ``d1``, ``d2``, ``d3`` (C -> C), the shared PReLU
    ``act`` after each, concatenated to 3C."""

    def __init__(self, channels: int):
        super().__init__()
        for d in (1, 2, 3):
            self.add_module(f"d{d}", conv(channels, channels, dilation=d))
        self.act = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.act(getattr(self, f"d{d}")(x))
                          for d in (1, 2, 3)], dim=1)


class DB(nn.Module):
    """Four chained RBs ``c1``-``c4``, their concat (with the input, or
    through ``aspp`` for a DB_ASPP) through ``ca`` and the 1x1 ``c5``, plus
    the input."""

    def __init__(self, features: int, aspp: bool = False):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"c{i}", RB(features))
        cat = 12 * features if aspp else 5 * features
        self.aspp = ASPP(4 * features) if aspp else None
        self.ca = CALayer(cat, 16, activation="prelu")
        self.c5 = nn.Conv2d(cat, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [x]
        for i in range(1, 5):
            outs.append(getattr(self, f"c{i}")(outs[-1]))
        if self.aspp is None:
            cat = torch.cat(outs, dim=1)
        else:
            cat = self.aspp(torch.cat(outs[1:], dim=1))
        return self.c5(self.ca(cat)) + x


class NonLocalBlock(nn.Module):
    """Embedded-Gaussian non-local block with a zero-init output conv."""

    def __init__(self, channels: int, inner: int):
        super().__init__()
        self.g = nn.Conv2d(channels, inner, 1)
        self.theta = nn.Conv2d(channels, inner, 1)
        self.phi = nn.Conv2d(channels, inner, 1)
        self.W = nn.Conv2d(inner, channels, 1)
        self.W.zero_init = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape

        def positions(t):  # (B, d, H, W) -> (B, H*W, d)
            return t.flatten(2).transpose(1, 2)

        attn = torch.softmax(torch.matmul(
            positions(self.theta(x)), positions(self.phi(x)).transpose(1, 2)),
            dim=-1)
        y = torch.matmul(attn, positions(self.g(x)))
        return self.W(y.transpose(1, 2).reshape(b, -1, h, w)) + x


class QuadrantNonLocal(nn.Module):
    """One ``non_local`` block applied to each of the four quadrants."""

    def __init__(self, channels: int, inner: int):
        super().__init__()
        self.non_local = NonLocalBlock(channels, inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1, w1 = x.shape[2] // 2, x.shape[3] // 2
        nl = self.non_local
        top = torch.cat([nl(x[:, :, :h1, :w1]), nl(x[:, :, :h1, w1:])], 3)
        bottom = torch.cat([nl(x[:, :, h1:, :w1]), nl(x[:, :, h1:, w1:])], 3)
        return torch.cat([top, bottom], dim=2)


class _FPN(nn.Module):
    """The reference's ``fpn_fusion`` holder of the fusion convs."""

    def __init__(self, features: int, n_taps: int):
        super().__init__()
        self.fusion = nn.ModuleList(conv(features, features)
                                    for _ in range(n_taps))

    def forward(self, taps: List[torch.Tensor]) -> torch.Tensor:
        fused = [self.fusion[0](taps[-1])]
        for i in range(len(taps) - 1):
            fused.append(self.fusion[i + 1](taps[-(i + 2)] + taps[-(i + 1)]))
        return torch.cat(fused, dim=1)


class AMSSRN(nn.Module):
    """(B, num_channels, H, W) -> (B, num_channels, sH, sW), weights drawn
    as the JAX package inits them (``gamma`` and the non-local output convs
    zero)."""

    def __init__(self, scale: int = 4, num_channels: int = 3,
                 n_feats: int = 64, n_blocks: int = 8, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        f = n_feats
        n_taps = n_blocks + 3
        with torch.device("meta"):  # skip torch's default init
            self.head = ConvBlock(num_channels, f)
            self.gamma = nn.Parameter(torch.zeros(1))
            self.non_local_1 = QuadrantNonLocal(f, f // 8)
            self.non_local_2 = QuadrantNonLocal(f, f // 8)
            self.body = nn.ModuleList(DB(f, aspp=i >= n_blocks // 2)
                                      for i in range(n_blocks))
            self.fpn_fusion = _FPN(f, n_taps)
            self.feature_bank = nn.Conv2d(n_taps * f, f, 1)
            self.tail = UpsampleHead(f, scale, activation=None,
                                     share_stages=False)
            self.reconstruction = conv(f, num_channels)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = self.head(x)
        nl1 = self.non_local_1(head)
        gamma = self.gamma.to(head.dtype)
        taps = [head, nl1]
        out = nl1
        for block in self.body:
            out = block(out) + gamma * nl1
            taps.append(out)
        taps.append(self.non_local_2(taps[-1]))
        bottleneck = head + self.feature_bank(self.fpn_fusion(taps))
        return self.reconstruction(self.tail(bottleneck))
