"""Attention blocks of the port's generators and discriminators (NCHW).

Counterpart of ``sradsgan_tpu/nn/attention.py`` and its composition
grammar:

- :class:`ChannelGate`, the CLAM: sigmoid(sum of MLP(pool)) * x over the
  pools its ``pool_mode`` names; "Avg|Max" takes both from the fused pool
  kernel and runs one MLP pass over them stacked, "Avg" (DSSR's) and "Max"
  a plain mean or max, as JAX calls its pool kernel only for "Avg|Max";
- :class:`CALayer`, RCAN's squeeze-and-excite (DRCAN, AMSSRN);
- :class:`SpatialGate`, the SLAM: "Avg|Max" is the spatial-gate kernel, a
  single statistic the plain float32 stencil (JAX runs no kernel there);
- :class:`LocalAttention`: the grammar '' | 'CA' | 'SA' | 'CA-SA' | 'SA-CA'
  | 'CA|SA' over CLAM and SLAM with its 1x1 conv, and with
  ``rab_tail="fused"`` the 'CA-SA' + conv tail with its residual add in the
  fused RAB-tail op (same parameters, same ``state_dict``), for exactly the
  tails JAX's ``use_fused_rab_tail`` fuses;
- :class:`SpatialSelfAttention`, the SGAM: the position-attention kernel,
  or the plain composition where its caller asks for it (the patch D's
  global attention);
- :class:`ChannelSelfAttention`, the CGAM: a Gram matrix softmaxed over
  ``max(energy) - energy`` in float32;
- :class:`GlobalAttention`: the same grammar over CGAM and SGAM.

Submodule and parameter names follow the reference's torch ``state_dict``
(``ca.fc1``, ``sa.conv1``, ``sa.query_conv``, ``gamma``, ``conv``, ...),
which ``sradsgan_tpu/tools/import_reference.py`` reads; a composition
holds only the submodules its mode uses, as the JAX tree holds only their
leaves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.blocks import make_act
from sradsgan_tpu_torch.ops import plain_dtype
from sradsgan_tpu_torch.ops.pooling import avg_max_pool
from sradsgan_tpu_torch.ops.rab_tail import fused_rab_tail
from sradsgan_tpu_torch.ops.sgam_flash import (position_attention,
                                               position_attention_plain)
from sradsgan_tpu_torch.ops.spatial_gate import (KERNEL_SIZE, PAD,
                                                 spatial_gate)

KERNEL_POOL = "Avg|Max"  # the pool mode the pool and gate kernels serve
MODES = ("", "CA", "SA", "CA-SA", "SA-CA", "CA|SA")


def pool_stats(pool_mode: str) -> tuple:
    """The statistics a pool mode names, in JAX's order: ("Avg", "Max"),
    ("Avg",) or ("Max",).  A mode that names neither raises."""
    stats = tuple(s for s in ("Avg", "Max") if s in pool_mode)
    if not stats:
        raise ValueError(f"pool_mode {pool_mode!r} names neither 'Avg' nor "
                         "'Max'")
    return stats


class ChannelGate(nn.Module):
    """CLAM: a shared bias-free MLP (1x1 convs fc1, fc2, reduction 16) over
    the pools of ``pool_mode``, summed.  "Avg|Max" takes both pools from
    the fused pool kernel and runs the MLP once over them stacked; any
    other mode the plain mean and max (``attention.py:74-79``)."""

    def __init__(self, channels: int, pool_mode: str = KERNEL_POOL):
        super().__init__()
        self.stats = pool_stats(pool_mode)
        self.pool_mode = pool_mode
        hidden = max(channels // 16, 1)
        self.fc1 = nn.Conv2d(channels, hidden, 1, bias=False)
        self.fc2 = nn.Conv2d(hidden, channels, 1, bias=False)

    def _mlp(self, v: torch.Tensor) -> torch.Tensor:
        hidden = F.relu(F.linear(v, self.fc1.weight.flatten(1)))
        return F.linear(hidden, self.fc2.weight.flatten(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_mode == KERNEL_POOL:
            o = self._mlp(torch.cat(avg_max_pool(x)))
            b = x.shape[0]
            o = o[:b] + o[b:]
        else:
            pools = {"Avg": lambda: x.mean((2, 3)),
                     "Max": lambda: x.amax((2, 3))}
            o = sum(self._mlp(pools[s]()) for s in self.stats)
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
    """SLAM: ``conv1`` holds the gate kernel, no bias, one input plane a
    statistic of ``pool_mode`` (plane 0 the channel mean, 1 the max).
    "Avg|Max" is the spatial-gate op (its kernels forward and backward); a
    single statistic runs the plain float32 stencil, as JAX's
    ``spatial_gate_apply`` does for it (``ops/spatial_gate.py:84-102``)."""

    def __init__(self, pool_mode: str = KERNEL_POOL):
        super().__init__()
        self.stats = pool_stats(pool_mode)
        self.pool_mode = pool_mode
        self.conv1 = nn.Conv2d(len(self.stats), 1, KERNEL_SIZE, padding=PAD,
                               bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_mode == KERNEL_POOL:
            return spatial_gate(x, self.conv1.weight)
        x32 = x.to(plain_dtype(x))
        with torch.autocast(x.device.type, enabled=False):
            stats = {"Avg": lambda: x32.mean(1, keepdim=True),
                     "Max": lambda: x32.amax(1, keepdim=True)}
            planes = torch.cat([stats[s]() for s in self.stats], dim=1)
            gate = torch.sigmoid(F.conv2d(planes,
                                          self.conv1.weight.to(x32.dtype),
                                          padding=PAD))
        return (x32 * gate).to(x.dtype)


RAB_TAILS = ("unfused", "fused")


def use_fused_rab_tail(mode: str, pool_mode: str, add_conv: bool) -> bool:
    """The tails the fused RAB-tail op implements, JAX's rule
    (``attention.py:170-175``): 'CA-SA' over both pools with the 1x1
    conv."""
    return mode == "CA-SA" and pool_mode == KERNEL_POOL and add_conv


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}; one of {MODES}")


def _has_conv(mode: str, add_conv: bool) -> bool:
    """'' is the conv alone and 'CA|SA' always fuses its concatenation;
    'CA' and 'SA' never take one, the sequential modes with ``add_conv``."""
    return mode in ("", "CA|SA") or ("-" in mode and add_conv)


def _compose(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The grammar over ``module.ca``, ``module.sa`` and ``module.conv``
    (``attention.py:349-428``)."""
    mode = module.mode
    if mode == "":
        return module.conv(x)
    if mode == "CA":
        return module.ca(x)
    if mode == "SA":
        return module.sa(x)
    if mode == "CA|SA":
        return module.conv(torch.cat([module.ca(x), module.sa(x)], dim=1))
    out = (module.sa(module.ca(x)) if mode == "CA-SA"
           else module.ca(module.sa(x)))
    return module.conv(out) if module.add_conv else out


class LocalAttention(nn.Module):
    """Local attention by the grammar: ``mode`` '' (a lone 1x1 conv), 'CA'
    or 'SA' (the gate alone, whatever ``add_conv`` says), 'CA-SA' or 'SA-CA'
    (the gates in that order, then the 1x1 conv if ``add_conv``), 'CA|SA'
    (both gates on the input, concatenated, a 2C -> C 1x1 conv always).
    ``ca``, ``sa`` and ``conv`` exist only where the mode uses them.

    RAB and ResGroup subclass it, so that ``ca``, ``sa`` and ``conv`` sit
    beside their own convs as in the reference's ``state_dict``.  They end
    in :meth:`tail`, which adds the residual; ``rab_tail="fused"`` sends a
    tail that :func:`use_fused_rab_tail` admits (``fused`` is then true)
    through the fused RAB-tail op (counterpart of the JAX package's
    ``FusedCASATail``) over the very same parameters, so a ``state_dict``
    loads into either formulation; any other tail runs its composition.
    """

    def __init__(self, channels: int, rab_tail: str = "unfused",
                 mode: str = "CA-SA", pool_mode: str = KERNEL_POOL,
                 add_conv: bool = True):
        super().__init__()
        if rab_tail not in RAB_TAILS:
            raise ValueError(f"rab_tail must be one of {RAB_TAILS}, got "
                             f"{rab_tail!r}")
        _check_mode(mode)
        self.mode, self.pool_mode, self.add_conv = mode, pool_mode, add_conv
        self.fused = (rab_tail == "fused"
                      and use_fused_rab_tail(mode, pool_mode, add_conv))
        if "CA" in mode:
            self.ca = ChannelGate(channels, pool_mode)
        if "SA" in mode:
            self.sa = SpatialGate(pool_mode)
        if _has_conv(mode, add_conv):
            width = 2 * channels if mode == "CA|SA" else channels
            self.conv = nn.Conv2d(width, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _compose(self, x)

    def tail(self, t: torch.Tensor, x_res: torch.Tensor) -> torch.Tensor:
        """The composition of t, plus x_res."""
        if not self.fused:
            return _compose(self, t) + x_res
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
    """SGAM: q, k project to C // 8, v to C; ``gamma * attn + x``.

    The attention runs the position-attention op, which on a CUDA tensor
    launches the kernel and raises at a width it is not built for.
    ``plain=True`` is the caller's choice of the plain composition instead:
    the patch D's global attention takes it, where JAX runs einsums (its
    trunk holds far fewer than the flash kernel's 2048 positions,
    ``attention.py:240-300``) and the WGAN-GP penalty differentiates the
    attention twice, which the op refuses."""

    def __init__(self, channels: int, plain: bool = False):
        super().__init__()
        inner = max(channels // 8, 1)
        self.query_conv = nn.Conv2d(channels, inner, 1)
        self.key_conv = nn.Conv2d(channels, inner, 1)
        self.value_conv = nn.Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.plain = plain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape

        def positions(t):  # (B, d, H, W) -> (B, H*W, d)
            return t.flatten(2).transpose(1, 2).contiguous()

        attend = (position_attention_plain if self.plain
                  else position_attention)
        out = attend(positions(self.query_conv(x)),
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
    """Global attention by the grammar of :class:`LocalAttention` over CGAM
    (``ca``) and SGAM (``sa``), default 'CA-SA' with its 1x1 conv.  The
    mode '' raises, as in JAX (``attention.py:404-426``)."""

    def __init__(self, channels: int, mode: str = "CA-SA",
                 add_conv: bool = True):
        super().__init__()
        _check_mode(mode)
        if mode == "":
            raise ValueError("unknown attention mode '' for global "
                             "attention")
        self.mode, self.add_conv = mode, add_conv
        if "CA" in mode:
            self.ca = ChannelSelfAttention()
        if "SA" in mode:
            self.sa = SpatialSelfAttention(channels)
        if _has_conv(mode, add_conv):
            width = 2 * channels if mode == "CA|SA" else channels
            self.conv = nn.Conv2d(width, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _compose(self, x)
