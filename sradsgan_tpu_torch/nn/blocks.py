"""Building blocks of the port's generators (NCHW).

Counterpart of ``sradsgan_tpu/nn/blocks.py``.  Convolutions use the SAME
padding of the JAX package (``dilation * (k - 1) // 2``, stride 1).
Submodule names follow the reference's torch ``state_dict`` layout: a
:class:`ConvBlock` is an ``nn.Sequential`` whose conv is ``0`` (``conv1.0``),
a :class:`ConvLayer` holds its conv as ``conv`` (``input_conv.conv``), as the
reference's ``base_networks.ConvBlock`` does.  :func:`same_pad` pads as
XLA's "SAME" does, (0, 1) for a stride-2 3x3 conv on an even size where
torch's symmetric padding would give (1, 1); :class:`DeconvBlock` and
:class:`Upsample2xBlock` are the block library's 2x upsamplers.

:func:`materialize` gives a generator built on the meta device the JAX
package's init, drawn from a seed.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

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


def same_padding(size: int, kernel_size: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" (low, high) padding of one spatial axis: the output has
    ceil(size / stride) positions, the padding split with the odd one
    high."""
    total = max((-(-size // stride) - 1) * stride + kernel_size - size, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """x (NCHW) zero-padded as an XLA "SAME" conv of that kernel and stride
    pads it."""
    top, bottom = same_padding(x.shape[2], kernel_size, stride)
    left, right = same_padding(x.shape[3], kernel_size, stride)
    return F.pad(x, (left, right, top, bottom))


class SameConv2d(nn.Conv2d):
    """A conv with XLA's "SAME" padding at any stride (JAX's
    ``nn.Conv(padding="SAME")``), padded by :func:`same_pad` per call."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, bias: bool = True):
        super().__init__(in_features, features, kernel_size, stride,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(same_pad(x, self.kernel_size[0],
                                        self.stride[0]))


class SameConvTranspose2d(nn.ConvTranspose2d):
    """Flax's ``nn.ConvTranspose(padding="SAME")``: the input dilated by
    the stride and padded as ``lax.conv_transpose`` pads it, then the
    kernel correlated unflipped.  torch's transposed conv correlates the
    flipped kernel, so a Flax kernel (kh, kw, in, out) is this module's
    weight (in, out, kh, kw) flipped in both spatial axes
    (``tools/from_jax.py``); with kernel 4 and stride 2 the module is
    ``nn.ConvTranspose2d(in, out, 4, 2, padding=1)``."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int):
        super().__init__(in_features, features, kernel_size, stride)
        pad_len = kernel_size + stride - 2
        lo = (kernel_size - 1 if stride > kernel_size - 1
              else -(-pad_len // 2))
        # the full transposed conv pads k - 1 each side; crop or extend
        self.trim = (lo - (kernel_size - 1), pad_len - lo - (kernel_size - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x, self.weight, None, self.stride)
        lo, hi = self.trim
        y = F.pad(y, (lo, hi, lo, hi))
        return y + self.bias[:, None, None]


def _batch_norm(norm: Optional[str], features: int) -> Optional[nn.Module]:
    if norm == "batch":
        return BatchNorm2d(features)
    if norm is not None:
        raise ValueError(f"unknown norm {norm!r}")
    return None


class DeconvBlock(nn.Module):
    """Transposed-conv upsampler (JAX ``nn/blocks.py:213``): ``deconv``
    (SAME, kernel 4, stride 2 by default), BatchNorm ``bn`` with
    ``norm="batch"``, the activation."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 4, stride: int = 2,
                 activation: Optional[str] = "relu",
                 norm: Optional[str] = "batch"):
        super().__init__()
        self.deconv = SameConvTranspose2d(in_features, features,
                                          kernel_size, stride)
        self.bn = _batch_norm(norm, features)
        self.act = make_act(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.deconv(x)
        if self.bn is not None:
            x = self.bn(x)
        return x if self.act is None else self.act(x)


UPSAMPLE_MODES = ("deconv", "ps", "rnc")


class Upsample2xBlock(nn.Module):
    """2x upsampler (JAX ``nn/blocks.py:241``): 'deconv' a
    :class:`DeconvBlock` ``upsample``; 'ps' a 3x3 ``conv`` to 4C and a pixel
    shuffle; 'rnc' a nearest 2x repeat and a 3x3 ``conv``; the latter two
    then BatchNorm ``bn`` with ``norm="batch"`` and the activation."""

    def __init__(self, in_features: int, features: int,
                 upsample: str = "deconv",
                 activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        if upsample not in UPSAMPLE_MODES:
            raise ValueError(f"unknown upsample mode {upsample!r}")
        self.mode = upsample
        if upsample == "deconv":
            self.upsample = DeconvBlock(in_features, features, 4, 2,
                                        activation, norm)
            return
        self.conv = conv(in_features,
                         features * 4 if upsample == "ps" else features)
        self.bn = _batch_norm(norm, features)
        self.act = make_act(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "deconv":
            return self.upsample(x)
        if self.mode == "ps":
            x = pixel_shuffle(self.conv(x), 2)
        else:
            x = self.conv(x.repeat_interleave(2, 2).repeat_interleave(2, 3))
        if self.bn is not None:
            x = self.bn(x)
        return x if self.act is None else self.act(x)


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
        if not share_stages and norm:
            raise ValueError("stages of their own take no norm")
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


def lecun_normal_(t: torch.Tensor, gen: torch.Generator) -> None:
    """Flax's default ``lecun_normal``: variance 1 / fan_in, a normal
    truncated at two standard deviations (its stddev divided by 0.8796...,
    the standard deviation of a unit normal so truncated)."""
    std = (1.0 / t[0].numel()) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def materialize(model: nn.Module, seed: int) -> None:
    """Give a model built on the meta device CPU storage and the JAX
    package's init, drawn from ``torch.Generator().manual_seed(seed)`` in
    module order: conv (transposed included) kernels normal(0, 0.02) (all
    zero for a conv whose ``zero_init`` is set, Flax's default LeCun normal
    for one whose ``lecun_init`` is set, as the feature extractors' convs),
    dense kernels and HAT's ``relative_position_bias_table``s normal(0,
    0.02) truncated at two standard deviations (so too a conv whose
    ``trunc_init`` is set; a dense layer whose ``trunc_init`` is false is
    not truncated), biases zero, BatchNorm and LayerNorm scale one and
    shift zero (BatchNorm with fresh running statistics), PReLU slopes
    0.25, the attention gains ``gamma`` zero, AA-conv's relative position
    tables ``key_rel_w`` and ``key_rel_h`` normal(0, 1); a module with an
    ``init_buffers(gen)`` method draws its buffers there.  A parameter of
    any other kind raises."""
    model.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(seed)
    done = set()
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "init_buffers"):
                m.init_buffers(gen)
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                if getattr(m, "zero_init", False):
                    m.weight.zero_()
                elif getattr(m, "lecun_init", False):
                    lecun_normal_(m.weight, gen)
                elif getattr(m, "trunc_init", isinstance(m, nn.Linear)):
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
            elif leaf in ("key_rel_w", "key_rel_h"):
                p.normal_(0.0, 1.0, generator=gen)
            elif id(p) not in done:
                raise TypeError(f"materialize: no init for {name}")
