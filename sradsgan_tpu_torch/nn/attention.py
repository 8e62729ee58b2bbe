"""Attention blocks of the port's generators (NCHW).

Counterpart of ``sradsgan_tpu/nn/attention.py``, for the compositions the
ported models use:

- :class:`ChannelGate`, the CLAM: sigmoid(MLP(avg) + MLP(max)) * x, the two
  pools from the fused pool kernel, one MLP pass over both stacked (DSSR's
  "Avg" mode: the mean alone);
- :class:`CALayer`, RCAN's squeeze-and-excite (DRCAN, AMSSRN);
- :class:`SpatialGate`, the SLAM: the spatial-gate kernel;
- :class:`LocalAttention`: CLAM then SLAM then a 1x1 fuse conv ('CA-SA', the
  mode of SRADSGAN's and SRAGAN's blocks), or, with ``rab_tail="fused"``,
  the whole tail with its residual add in the fused RAB-tail op (same
  parameters, same ``state_dict``);
- :class:`SpatialSelfAttention`, the SGAM: the position-attention kernel;
- :class:`ChannelSelfAttention`, the CGAM: a Gram matrix softmaxed over
  ``max(energy) - energy`` in float32;
- :class:`GlobalAttention`: CGAM then SGAM then a 1x1 fuse conv.

Submodule and parameter names follow the reference's torch ``state_dict``
(``ca.fc1``, ``sa.conv1``, ``sa.query_conv``, ``gamma``, ...), which
``sradsgan_tpu/tools/import_reference.py`` reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.blocks import make_act
from sradsgan_tpu_torch.ops import plain_dtype
from sradsgan_tpu_torch.ops.pooling import avg_max_pool
from sradsgan_tpu_torch.ops.rab_tail import fused_rab_tail
from sradsgan_tpu_torch.ops.sgam_flash import position_attention
from sradsgan_tpu_torch.ops.spatial_gate import KERNEL_SIZE, spatial_gate


POOL_MODES = ("Avg|Max", "Avg")


class ChannelGate(nn.Module):
    """CLAM: a shared bias-free MLP (1x1 convs fc1, fc2, reduction 16) over
    both pools, which come from the fused pool kernel; with
    ``pool_mode="Avg"`` (DSSR) over the plain channel mean alone, as JAX
    calls its pool kernel only for "Avg|Max"."""

    def __init__(self, channels: int, pool_mode: str = "Avg|Max"):
        super().__init__()
        if pool_mode not in POOL_MODES:
            raise ValueError(f"pool_mode must be one of {POOL_MODES}, got "
                             f"{pool_mode!r}")
        self.pool_mode = pool_mode
        hidden = max(channels // 16, 1)
        self.fc1 = nn.Conv2d(channels, hidden, 1, bias=False)
        self.fc2 = nn.Conv2d(hidden, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_mode == "Avg":
            pooled = x.mean((2, 3))
        else:
            pooled = torch.cat(avg_max_pool(x))
        hidden = F.relu(F.linear(pooled, self.fc1.weight.flatten(1)))
        o = F.linear(hidden, self.fc2.weight.flatten(1))
        if self.pool_mode != "Avg":
            b = x.shape[0]
            o = o[:b] + o[b:]
        return torch.sigmoid(o)[:, :, None, None] * x


class CALayer(nn.Module):
    """RCAN's squeeze-and-excite: ``x * sigmoid(conv_du(mean_hw x))``, with
    ``conv_du`` = 1x1 conv (bias) to C // reduction, the activation (ReLU;
    AMSSRN's a PReLU), 1x1 conv back to C."""

    def __init__(self, channels: int, reduction: int = 16,
                 activation: str = "relu"):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.conv_du = nn.Sequential(nn.Conv2d(channels, hidden, 1),
                                     make_act(activation),
                                     nn.Conv2d(hidden, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.conv_du(x.mean((2, 3), keepdim=True))) * x


class SpatialGate(nn.Module):
    """SLAM: ``conv1`` holds the (1, 2, 7, 7) gate kernel, no bias."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, KERNEL_SIZE, padding=KERNEL_SIZE // 2,
                               bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spatial_gate(x, self.conv1.weight)


RAB_TAILS = ("unfused", "fused")


class LocalAttention(nn.Module):
    """'CA-SA' local attention with its 1x1 fuse conv: conv(sa(ca(x))).

    RAB and ResGroup subclass it, so that ``ca``, ``sa`` and ``conv`` sit
    beside their own convs as in the reference's ``state_dict``.  They end
    in :meth:`tail`, which adds the residual; ``rab_tail="fused"`` sends the
    tail through the fused RAB-tail op (counterpart of the JAX package's
    ``FusedCASATail``) over the very same parameters, so a ``state_dict``
    loads into either formulation.
    """

    def __init__(self, channels: int, rab_tail: str = "unfused"):
        super().__init__()
        if rab_tail not in RAB_TAILS:
            raise ValueError(f"rab_tail must be one of {RAB_TAILS}, got "
                             f"{rab_tail!r}")
        self.rab_tail = rab_tail
        self.ca = ChannelGate(channels)
        self.sa = SpatialGate()
        self.conv = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.sa(self.ca(x)))

    def tail(self, t: torch.Tensor, x_res: torch.Tensor) -> torch.Tensor:
        """conv(sa(ca(t))) + x_res."""
        if self.rab_tail == "unfused":
            return LocalAttention.forward(self, t) + x_res
        # the op takes float32 parameters: w1 (C, hidden), w2 (hidden, C),
        # W_fuse (C_in, C_out); activations keep their type
        return fused_rab_tail(
            t.contiguous(), x_res.to(t.dtype).contiguous(),
            self.ca.fc1.weight.flatten(1).t().float().contiguous(),
            self.ca.fc2.weight.flatten(1).t().float().contiguous(),
            self.sa.conv1.weight.float(),
            self.conv.weight.flatten(1).t().float().contiguous(),
            self.conv.bias.float())


class SpatialSelfAttention(nn.Module):
    """SGAM: q, k project to C // 8, v to C; ``gamma * attn + x``."""

    def __init__(self, channels: int):
        super().__init__()
        inner = max(channels // 8, 1)
        self.query_conv = nn.Conv2d(channels, inner, 1)
        self.key_conv = nn.Conv2d(channels, inner, 1)
        self.value_conv = nn.Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape

        def positions(t):  # (B, d, H, W) -> (B, H*W, d)
            return t.flatten(2).transpose(1, 2).contiguous()

        out = position_attention(positions(self.query_conv(x)),
                                 positions(self.key_conv(x)),
                                 positions(self.value_conv(x)))
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return self.gamma.to(x.dtype) * out + x


class ChannelSelfAttention(nn.Module):
    """CGAM: Gram energy and its softmax in float32, whatever x's dtype
    (autocast included)."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        flat = x.flatten(2)                                   # (B, C, N)
        f32 = flat.to(plain_dtype(flat))
        with torch.autocast(x.device.type, enabled=False):
            energy = torch.bmm(f32, f32.transpose(1, 2))      # (B, C, C)
            energy = energy.amax(dim=-1, keepdim=True) - energy
            attn = torch.softmax(energy, dim=-1).to(x.dtype)
        out = torch.bmm(attn, flat).reshape(b, c, h, w)
        return self.gamma.to(x.dtype) * out + x


class GlobalAttention(nn.Module):
    """'CA-SA' global attention with its 1x1 fuse conv: conv(sa(ca(x)))."""

    def __init__(self, channels: int):
        super().__init__()
        self.ca = ChannelSelfAttention()
        self.sa = SpatialSelfAttention(channels)
        self.conv = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.sa(self.ca(x)))
