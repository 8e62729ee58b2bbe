"""The plain reference networks: SRADSGAN and SRAGAN x4 generators, the
CBAM patch discriminator and VGG19 ``features[:12]``, in plain PyTorch.

Written from the published architectures (SRADSGAN, TGRS 2024, the
reference's ``model/sradsgan.py`` and ``main_sradsgan.py``; SRAGAN's
``model/sragan.py`` ``GeneratorResNet``), independent of the program: no
kernel, no fused path.  Every gate, softmax and normalisation is the
textbook formula.  Parameter
names follow the reference's ``state_dict`` layout, which the program
keeps as well, so that one set of weights made by the benchmark loads into
both.

Mixed precision is the configuration's statement, not the program's
code: under ``torch.autocast`` (bf16) the convolutions take bf16 operands,
while every gate, attention softmax and BatchNorm here computes in float32
from its input and returns the input's dtype.  ``Numerics`` decides how the
operands of every convolution and matrix product are rounded besides:
not at all (the reference), or through float8 e4m3 with one scale a tensor
(the control that ``correct`` must reject).

A configuration's own reference (``"reference"`` in its file, loaded by
path) builds its dense layers from ``Conv`` and ``Linear`` and takes its
other products, attention's among them, through ``Products.matmul`` and
``Products.einsum``, so that ``set_numerics`` reaches every product.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


class Numerics:
    """Rounding of the operands of products: none, or float8 e4m3 with a
    per-tensor scale and a straight-through gradient."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return t + (q - t).detach()


EXACT = Numerics()


class Conv(nn.Conv2d):
    """A convolution whose operands go through the model's numerics."""

    numerics: Numerics = EXACT

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.numerics
        return F.conv2d(n(x), n(self.weight), self.bias, self.stride,
                        self.padding)


class Linear(nn.Linear):
    """A dense layer whose operands go through the model's numerics."""

    numerics: Numerics = EXACT

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.numerics
        return F.linear(n(x), n(self.weight), self.bias)


class Products(nn.Module):
    """A module whose matrix products take their operands through the
    model's numerics."""

    numerics: Numerics = EXACT

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        n = self.numerics
        return n(a) @ n(b)

    def einsum(self, equation: str, *operands: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(equation, *map(self.numerics, operands))


def set_numerics(model: nn.Module, numerics: Numerics) -> nn.Module:
    for m in model.modules():
        if isinstance(m, (Conv, Linear, Products, SpatialSelfAttention,
                          ChannelSelfAttention, ChannelGate)):
            m.numerics = numerics
    return model


def autocast_off(x: torch.Tensor):
    """Autocast off for x's device (the meta device, where the FLOPs are
    counted, has none)."""
    if x.device.type == "meta":
        return contextlib.nullcontext()
    return torch.autocast(x.device.type, enabled=False)


def float32(fn):
    """Run a module's forward in float32, autocast off, and hand back the
    input's dtype."""
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with autocast_off(x):
            return fn(self, x.float()).to(x.dtype)
    return forward


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm in float32."""

    forward = float32(nn.BatchNorm2d.forward)


def conv3(c_in: int, c_out: int) -> Conv:
    return Conv(c_in, c_out, 3, padding=1)


def lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(x, slope)


class ChannelGate(nn.Module):
    """CLAM: sigmoid(MLP(avg pool) + MLP(max pool)) * x, a bias-free MLP
    of ratio 16."""

    numerics: Numerics = EXACT

    def __init__(self, c: int):
        super().__init__()
        self.fc1 = nn.Conv2d(c, max(c // 16, 1), 1, bias=False)
        self.fc2 = nn.Conv2d(max(c // 16, 1), c, 1, bias=False)

    def mlp(self, v: torch.Tensor) -> torch.Tensor:
        n = self.numerics
        h = F.relu(n(v) @ n(self.fc1.weight.flatten(1)).t())
        return n(h) @ n(self.fc2.weight.flatten(1)).t()

    @float32
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o = self.mlp(x.mean((2, 3))) + self.mlp(x.amax((2, 3)))
        return torch.sigmoid(o)[:, :, None, None] * x


class SpatialGate(nn.Module):
    """SLAM: sigmoid(7x7 conv of [channel mean, channel max]) * x."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(2, 1, 7, padding=3, bias=False)

    @float32
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        planes = torch.cat([x.mean(1, keepdim=True),
                            x.amax(1, keepdim=True)], 1)
        return torch.sigmoid(self.conv1(planes)) * x


class CASATail(nn.Module):
    """The CA-SA local attention with its 1x1 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.ca = ChannelGate(c)
        self.sa = SpatialGate()
        self.conv = Conv(c, c, 1)

    def attend(self, t: torch.Tensor) -> torch.Tensor:
        return self.conv(self.sa(self.ca(t)))


class ChannelSelfAttention(nn.Module):
    """CGAM: softmax over (row max - Gram energy), times the features."""

    numerics: Numerics = EXACT

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    @float32
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = self.numerics
        f = x.flatten(2)
        energy = n(f) @ n(f).transpose(1, 2)
        energy = energy.amax(-1, keepdim=True) - energy
        out = n(torch.softmax(energy, -1)) @ n(f)
        return self.gamma * out.reshape(b, c, h, w) + x


class SpatialSelfAttention(nn.Module):
    """SGAM: softmax(q k^T) v over the positions, unscaled, q and k of
    C // 8 channels."""

    numerics: Numerics = EXACT

    def __init__(self, c: int):
        super().__init__()
        self.query_conv = Conv(c, c // 8, 1)
        self.key_conv = Conv(c, c // 8, 1)
        self.value_conv = Conv(c, c, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q = self.query_conv(x).flatten(2).transpose(1, 2)
        k = self.key_conv(x).flatten(2)
        v = self.value_conv(x).flatten(2).transpose(1, 2)
        with autocast_off(x):
            out = self.attend(q.float(), k.float(), v.float())
            out = out.transpose(1, 2).reshape(b, c, h, w)
            return (self.gamma * out + x.float()).to(x.dtype)

    def attend(self, q, k, v) -> torch.Tensor:
        n = self.numerics
        # by blocks of queries: a 216^2 image's energy would be 8.7 GB
        rows = max(1, 2 ** 27 // (k.shape[-1] * q.shape[0]))
        return torch.cat([n(torch.softmax(n(q[:, i:i + rows]) @ n(k), -1))
                          @ n(v) for i in range(0, q.shape[1], rows)], 1)


def global_attention(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """CGAM, then SGAM, then the 1x1 conv (the 'CA-SA' global attention)."""
    return m.conv(m.sa(m.ca(x)))


def upsample_x4(conv: nn.Module, x: torch.Tensor,
                bn: Optional[nn.Module] = None) -> torch.Tensor:
    """Two x2 stages through one shared conv (and BatchNorm): conv, [BN],
    pixel shuffle, LeakyReLU 0.01."""
    for _ in range(2):
        x = conv(x)
        if bn is not None:
            x = bn(x)
        x = lrelu(F.pixel_shuffle(x, 2), 0.01)
    return x


class Head(nn.Sequential):
    """A 3x3 conv named ``0`` (and a BatchNorm ``1``)."""

    def __init__(self, c_in: int, c_out: int, batch_norm: bool = False):
        layers = [conv3(c_in, c_out)]
        if batch_norm:
            layers.append(BatchNorm(c_out))
        super().__init__(*layers)


# ---------------------------------------------------------------- SRADSGAN
class MSB(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = conv3(3, f)
        self.conv2 = nn.Sequential(Conv(3, f, 1), conv3(f, f))
        self.conv3 = Conv(3, f, 1)
        self.conv = Conv(3 * f, f, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.conv1(x), self.conv2(x), self.conv3(x)], 1)
        return lrelu(self.conv(out), 0.01)


class RAB(CASATail):
    def __init__(self, f: int):
        super().__init__(f)
        self.conv1 = conv3(f, 4 * f)
        self.conv2 = conv3(4 * f, f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attend(self.conv2(lrelu(self.conv1(x), 0.2))) + x


class ResGroup(CASATail):
    def __init__(self, f: int, n_blocks: int):
        super().__init__(f)
        self.RG = nn.ModuleList(RAB(f) for _ in range(n_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for rab in self.RG:
            out = rab(out)
        return self.attend(out) + x


class GABUp(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.ca = ChannelSelfAttention()
        self.sa = SpatialSelfAttention(f)
        self.conv = Conv(f, f, 1)
        self.upsampling = nn.Module()
        self.upsampling.add_module("0", conv3(f, 4 * f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_x4(getattr(self.upsampling, "0"),
                           global_attention(self, x))


class SRADSGAN(nn.Module):
    """MSB stem and conv head, ``n_groups`` ResGroups of ``n_blocks`` RABs
    whose outputs are summed with the stem's, GAB_UP, a 3x3 conv out."""

    def __init__(self, base_filters: int = 64, n_groups: int = 12,
                 n_blocks: int = 3):
        super().__init__()
        f = base_filters
        self.conv1 = Head(3, f)
        self.MSB = MSB(f)
        self.res_groups = nn.ModuleList(ResGroup(f, n_blocks)
                                        for _ in range(n_groups))
        self.GAB_UP = GABUp(f)
        self.conv3 = Head(f, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = lrelu(self.conv1(x), 0.01)
        out_all = self.MSB(x) + out
        for group in self.res_groups:
            out = group(out)
            out_all = out_all + out
        return self.conv3(self.GAB_UP(out_all))


# ------------------------------------------------------------------ SRAGAN
class ConvLayer(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv = conv3(f, f)


class BasicBlock(CASATail):
    """conv (LeakyReLU 0.2), conv, the tail plus the input, then LeakyReLU
    0.2, except the last block of a group."""

    def __init__(self, f: int, activated: bool):
        super().__init__(f)
        self.conv1 = ConvLayer(f)
        self.conv2 = ConvLayer(f)
        self.activated = activated

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1.conv(x)
        if self.activated:
            out = lrelu(out, 0.2)
        out = self.attend(self.conv2.conv(out)) + x
        return lrelu(out, 0.2) if self.activated else out


class SRAGANGroup(CASATail):
    def __init__(self, f: int, n_blocks: int):
        super().__init__(f)
        self.blocks = nn.Sequential(*(BasicBlock(f, True)
                                      for _ in range(n_blocks - 1)))
        self.last_conv = BasicBlock(f, False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attend(self.last_conv(self.blocks(x))) + x


class SRAGAN(nn.Module):
    """Conv head, ``n_groups`` groups of ``n_blocks`` blocks, conv + BN with
    the global skip, CGAM, SGAM and a 1x1 conv, the x4 BN'd sub-pixel
    upsample, a 3x3 conv and tanh."""

    def __init__(self, base_filters: int = 64, n_groups: int = 12,
                 n_blocks: int = 5):
        super().__init__()
        f = base_filters
        self.ca = ChannelSelfAttention()
        self.sa = SpatialSelfAttention(f)
        self.conv = Conv(f, f, 1)
        self.conv1 = Head(3, f)
        self.res_blocks = nn.ModuleList(SRAGANGroup(f, n_blocks)
                                        for _ in range(n_groups))
        self.conv2 = Head(f, f, batch_norm=True)
        self.upsampling = nn.Module()
        self.upsampling.add_module("0", conv3(f, 4 * f))
        self.upsampling.add_module("1", BatchNorm(4 * f))
        self.conv3 = Head(f, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = lrelu(self.conv1(x), 0.01)
        out = out1
        for group in self.res_blocks:
            out = group(out)
        out = global_attention(self, out1 + self.conv2(out))
        out = upsample_x4(getattr(self.upsampling, "0"), out,
                          getattr(self.upsampling, "1"))
        return torch.tanh(self.conv3(out))


GENERATORS = {"sradsgan": SRADSGAN, "sragan": SRAGAN}


# ------------------------------------------------- discriminator, VGG19
# (filters, stride, BatchNorm) of the eight blocks; CBAM after the sixth
D_BLOCKS = ((64, 1, False), (64, 2, True), (128, 1, True), (128, 2, True),
            (256, 1, True), (256, 2, True), (512, 1, True), (512, 2, True))


class PatchDiscriminator(nn.Module):
    """The CBAM patch D: 3x3 conv blocks (LeakyReLU 0.2, BatchNorm on all
    but the first), CLAM then SLAM after block 6, a 3x3 conv to one logit
    a patch.  ``model`` is one Sequential in the reference's order."""

    def __init__(self):
        super().__init__()
        layers, c_in = [], 3
        for i, (f, stride, bn) in enumerate(D_BLOCKS, 1):
            layers.append(Conv(c_in, f, 3, stride, 1))
            if bn:
                layers.append(BatchNorm(f))
            layers.append(nn.LeakyReLU(0.2))
            if i == 6:
                layers += [ChannelGate(f), SpatialGate()]
            c_in = f
        layers.append(conv3(c_in, 1))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class VGG19Features(nn.Module):
    """conv1_1 ... relu3_1 of VGG19 on raw [0, 1] images (torchvision's
    ``features[:12]`` indices), frozen."""

    def __init__(self):
        super().__init__()
        layers = []
        for c_in, c_out, pool in ((3, 64, False), (64, 64, True),
                                  (64, 128, False), (128, 128, True),
                                  (128, 256, False)):
            layers += [conv3(c_in, c_out), nn.ReLU()]
            if pool:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


def build(name: str, device, **widths) -> nn.Module:
    """A network of the reference with uninitialised storage on
    ``device``: ``name`` a generator of GENERATORS, or "discriminator",
    or "vgg"."""
    cls = {"discriminator": PatchDiscriminator,
           "vgg": VGG19Features}.get(name) or GENERATORS[name]
    with torch.device("meta"):
        model = cls(**widths)
    return model.to_empty(device=device)
