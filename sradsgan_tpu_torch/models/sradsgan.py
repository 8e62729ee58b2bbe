"""SRADSGAN generator in PyTorch (NCHW), the unrolled formulation.

Counterpart of ``sradsgan_tpu/models/sradsgan.py``: an MSB stem and a conv
head, ``n_groups`` ResGroups of ``n_blocks`` RABs whose outputs are all
summed (stratified dense sampling), CGAM + SGAM global attention with a 1x1
fuse conv, a shared sub-pixel upsample, and a 3x3 output conv.

Module names follow the reference's torch ``state_dict`` (``conv1.0``,
``MSB.conv2.0``, ``res_groups.{g}.RG.{b}.ca.fc1``, ``GAB_UP.sa.query_conv``,
``GAB_UP.upsampling.0``, ``conv3.0``, ...), so a reference-trained state
dict loads unchanged and ``sradsgan_tpu/tools/import_reference.py`` maps a
port state dict into the JAX param tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.attention import GlobalAttention, LocalAttention
from sradsgan_tpu_torch.nn.blocks import ConvBlock, UpsampleHead, materialize


class MSB(nn.Module):
    """Multi-scale stem: 3x3 || 1x1->3x3 || 1x1, concat, 1x1 fuse, lrelu."""

    def __init__(self, in_channels: int = 3, features: int = 64):
        super().__init__()
        f = features
        self.conv1 = nn.Conv2d(in_channels, f, 3, padding=1)
        self.conv2 = nn.Sequential(nn.Conv2d(in_channels, f, 1),
                                   nn.Conv2d(f, f, 3, padding=1))
        self.conv3 = nn.Conv2d(in_channels, f, 1)
        self.conv = nn.Conv2d(3 * f, f, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.conv1(x), self.conv2(x), self.conv3(x)], dim=1)
        return F.leaky_relu(self.conv(out), 0.01)


class RAB(LocalAttention):
    """Residual attention block: 3x3 to 4C, lrelu(0.2), 3x3 back to C, then
    the local attention of ``la_mode`` (CLAM + SLAM + 1x1 fuse by default),
    plus the block input."""

    def __init__(self, features: int = 64, rab_tail: str = "unfused",
                 la_mode: str = "CA-SA", pool_mode: str = "Avg|Max",
                 add_conv: bool = True):
        super().__init__(features, rab_tail, la_mode, pool_mode, add_conv)
        self.conv1 = nn.Conv2d(features, 4 * features, 3, padding=1)
        self.conv2 = nn.Conv2d(4 * features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(F.leaky_relu(self.conv1(x), 0.2))
        return self.tail(out, x)


class ResGroup(LocalAttention):
    """``n_blocks`` RABs (``RG``) with ``bla_mode``, group-level local
    attention of ``rla_mode``, skip."""

    def __init__(self, features: int = 64, n_blocks: int = 3,
                 rab_tail: str = "unfused", rla_mode: str = "CA-SA",
                 bla_mode: str = "CA-SA", pool_mode: str = "Avg|Max",
                 add_conv: bool = True):
        super().__init__(features, rab_tail, rla_mode, pool_mode, add_conv)
        self.RG = nn.ModuleList(
            RAB(features, rab_tail, bla_mode, pool_mode, add_conv)
            for _ in range(n_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for rab in self.RG:
            out = rab(out)
        return self.tail(out, x)


class GABUp(GlobalAttention):
    """GAB_UP: global attention, then the shared sub-pixel upsample."""

    def __init__(self, features: int, scale: int, ga_mode: str = "CA-SA",
                 add_conv: bool = True):
        super().__init__(features, ga_mode, add_conv)
        self.upsampling = UpsampleHead(features, scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.upsampling(super().forward(x))


class SRADSGANGenerator(nn.Module):
    """(B, num_channels, H, W) in [0, 1] -> (B, num_channels, sH, sW).

    Weights are drawn from ``torch.Generator().manual_seed(seed)`` on the
    CPU, as the JAX package inits them: conv and MLP kernels normal(0.02),
    biases and the attention gains ``gamma`` zero; then the module moves to
    ``device``.

    The attention grammar of the paper's ablations, JAX's arguments and
    defaults: ``bla_mode`` the RABs' local attention, ``rla_mode`` the
    groups', ``ga_mode`` GAB_UP's global attention, ``pool_mode`` the
    gates' statistics ("Avg|Max", "Avg", "Max"), ``add_conv`` the 1x1 conv
    after a sequential composition (``nn/attention.py``).
    ``rab_tail="fused"`` runs in the fused RAB-tail op each RAB and group
    tail that JAX would fuse ('CA-SA', "Avg|Max", with the conv: all 48 at
    the defaults), the others unfused; the weights and the ``state_dict``
    are the same either way.
    """

    def __init__(self, scale: int = 4, num_channels: int = 3,
                 base_filters: int = 64, n_groups: int = 12,
                 n_blocks: int = 3, rla_mode: str = "CA-SA",
                 bla_mode: str = "CA-SA", ga_mode: str = "CA-SA",
                 pool_mode: str = "Avg|Max", add_conv: bool = True,
                 rab_tail: str = "unfused", *,
                 seed: int = 0, device: torch.device | str = "cpu"):
        super().__init__()
        f = base_filters
        with torch.device("meta"):  # skip torch's default init
            self.conv1 = ConvBlock(num_channels, f, activation="lrelu01")
            self.MSB = MSB(num_channels, f)
            self.res_groups = nn.ModuleList(
                ResGroup(f, n_blocks, rab_tail, rla_mode, bla_mode,
                         pool_mode, add_conv) for _ in range(n_groups))
            self.GAB_UP = GABUp(f, scale, ga_mode, add_conv)
            self.conv3 = ConvBlock(f, num_channels)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        out_all = self.MSB(x) + out
        for group in self.res_groups:  # stratified dense sampling
            out = group(out)
            out_all = out_all + out
        return self.conv3(self.GAB_UP(out_all))
