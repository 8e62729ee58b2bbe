"""Building blocks of the port's generators (NCHW).

Counterpart of ``sradsgan_tpu/nn/blocks.py``.  Convolutions use the SAME
padding of the JAX package (``dilation * (k - 1) // 2``, stride 1).
Submodule names follow the reference's torch ``state_dict`` layout: a
:class:`ConvBlock` is an ``nn.Sequential`` whose conv is ``0`` (``conv1.0``),
a :class:`ConvLayer` holds its conv as ``conv`` (``input_conv.conv``), as the
reference's ``base_networks.ConvBlock`` does.

:func:`materialize` gives a generator built on the meta device the JAX
package's init, drawn from a seed.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.norm import BatchNorm2d
from sradsgan_tpu_torch.ops.pixelshuffle import pixel_shuffle

KERNEL_INIT_STD = 0.02  # the JAX package's default_kernel_init


class PReLU(nn.Module):
    """Channel-shared PReLU: one learned slope ``weight`` (1,), init 0.25,
    as torch's ``nn.PReLU()``; the slope takes the input's dtype."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def make_act(name: Optional[str]) -> Optional[nn.Module]:
    """Activation by the JAX package's name: relu, lrelu (slope 0.2),
    lrelu01 (0.01, torch's default) or prelu (a learned slope)."""
    if not name:
        return None
    table = {"relu": nn.ReLU, "lrelu": lambda: nn.LeakyReLU(0.2),
             "lrelu01": lambda: nn.LeakyReLU(0.01), "prelu": PReLU}
    if name not in table:
        raise ValueError(f"unknown activation {name!r}")
    return table[name]()


def conv(in_features: int, features: int, kernel_size: int = 3,
         dilation: int = 1) -> nn.Conv2d:
    """A stride-1 conv with SAME padding and a bias."""
    return nn.Conv2d(in_features, features, kernel_size,
                     padding=dilation * (kernel_size - 1) // 2,
                     dilation=dilation)


class ConvBlock(nn.Sequential):
    """Conv ``0`` (SAME, stride 1), then BatchNorm ``1`` with
    ``norm="batch"``, then the activation."""

    def __init__(self, in_features: int, features: int,
                 activation: Optional[str] = None, kernel_size: int = 3,
                 dilation: int = 1, norm: Optional[str] = None):
        layers = [conv(in_features, features, kernel_size, dilation)]
        if norm == "batch":
            layers.append(BatchNorm2d(features))
        elif norm is not None:
            raise ValueError(f"unknown norm {norm!r}")
        act = make_act(activation)
        if act is not None:
            layers.append(act)
        super().__init__(*layers)


class ConvLayer(nn.Module):
    """A 3x3 conv named ``conv`` and an optional activation: the reference's
    ``base_networks.ConvBlock`` (EDSR's and SRAGAN's ``*.conv``)."""

    def __init__(self, in_features: int, features: int,
                 activation: Optional[str] = None):
        super().__init__()
        self.conv = conv(in_features, features)
        self.act = make_act(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return x if self.act is None else self.act(x)


class ResBlock(nn.Module):
    """``conv1``, activation, ``conv2``, times ``res_scale``, plus the input
    (EDSR's residual block)."""

    def __init__(self, features: int, activation: str = "relu",
                 res_scale: float = 1.0):
        super().__init__()
        self.conv1 = conv(features, features)
        self.act = make_act(activation)
        self.conv2 = conv(features, features)
        self.res_scale = res_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.act(self.conv1(x)))
        if self.res_scale != 1.0:
            y = y * self.res_scale
        return x + y


def scale_stages(scale: int) -> List[int]:
    """The shuffle factor of each upsample stage: 2^n -> n stages of 2,
    3^n -> n stages of 3."""
    if scale & (scale - 1) == 0:  # power of two
        return [2] * int(math.log2(scale))
    if scale % 3 == 0:
        return [3] * int(round(math.log(scale, 3)))
    raise ValueError(f"unsupported scale {scale}")


class UpsampleHead(nn.Module):
    """Sub-pixel upsample tail.  Per stage: a 3x3 conv to C*r*r, BatchNorm
    with ``norm="batch"``, a pixel shuffle by r, the activation.

    ``share_stages``: the reference appends one module list per stage, so
    one conv (``0``) and one BatchNorm (``1``) serve every stage and the
    BatchNorm's running statistics update once a stage.  DRCAN and AMSSRN
    build a conv per stage instead, as a Sequential of (conv, shuffle)
    pairs: the convs are ``0``, ``2``, ....
    """

    def __init__(self, features: int, scale: int,
                 activation: Optional[str] = "lrelu01",
                 share_stages: bool = True, norm: Optional[str] = None):
        super().__init__()
        self.scale_stages = scale_stages(scale)
        self.share_stages = share_stages
        if not share_stages and (norm or activation):
            raise ValueError("stages of their own take neither a norm nor "
                             "an activation")
        for i, r in enumerate(self.scale_stages[:1] if share_stages
                              else self.scale_stages):
            self.add_module(str(2 * i), conv(features, features * r * r))
        if norm == "batch" and self.scale_stages:
            r = self.scale_stages[0]
            self.add_module("1", BatchNorm2d(features * r * r))
        self.norm = norm
        self.act = make_act(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, r in enumerate(self.scale_stages):
            x = getattr(self, "0" if self.share_stages else str(2 * i))(x)
            if self.norm:
                x = getattr(self, "1")(x)
            x = pixel_shuffle(x, r)
            if self.act is not None:
                x = self.act(x)
        return x


class NearestConvUpsample(nn.Module):
    """NDSRGAN's head: per stage a nearest-neighbour upsample by r, then
    the 3x3 conv ``1`` and the activation; one conv serves every stage, as
    the reference appends one (upsample, conv, act) list repeatedly."""

    def __init__(self, features: int, scale: int,
                 activation: Optional[str] = "lrelu"):
        super().__init__()
        self.scale_stages = scale_stages(scale)
        self.add_module("1", conv(features, features))
        self.act = make_act(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.scale_stages:
            x = getattr(self, "1")(F.interpolate(x, scale_factor=r,
                                                 mode="nearest"))
            if self.act is not None:
                x = self.act(x)
        return x


def _trunc02(t: torch.Tensor, gen: torch.Generator) -> None:
    """Flax's ``truncated_normal(stddev=0.02)``: normal(0, 0.02) cut at two
    standard deviations."""
    s = KERNEL_INIT_STD
    nn.init.trunc_normal_(t, 0.0, s, -2 * s, 2 * s, generator=gen)


def materialize(model: nn.Module, seed: int) -> None:
    """Give a model built on the meta device CPU storage and the JAX
    package's init, drawn from ``torch.Generator().manual_seed(seed)`` in
    module order: conv kernels normal(0, 0.02) (all zero for a conv whose
    ``zero_init`` is set, truncated at two standard deviations for one
    whose ``trunc_init`` is set, a Dense layer in JAX), dense kernels and
    HAT's ``relative_position_bias_table``s normal(0, 0.02) truncated
    likewise, biases zero, BatchNorm and LayerNorm scale one and shift zero
    (BatchNorm with fresh running statistics), PReLU slopes 0.25, the
    attention gains ``gamma`` zero.  A parameter of any other kind
    raises."""
    model.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(seed)
    done = set()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                if getattr(m, "zero_init", False):
                    m.weight.zero_()
                elif (isinstance(m, nn.Linear)
                      or getattr(m, "trunc_init", False)):
                    _trunc02(m.weight, gen)
                else:
                    m.weight.normal_(0.0, KERNEL_INIT_STD, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, PReLU):
                m.weight.fill_(0.25)
            else:
                continue
            done.update(id(p) for p in m.parameters(recurse=False))
        for name, p in model.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf == "gamma":
                p.zero_()
            elif leaf == "relative_position_bias_table":
                _trunc02(p, gen)
            elif id(p) not in done:
                raise TypeError(f"materialize: no init for {name}")
