"""Feature extractors and the MINC texture net (NCHW).

Counterpart of ``sradsgan_tpu/nn/extractors.py``:

- :class:`VGGFeatureExtractor`: VGG19 (optionally with BatchNorm) up to
  torchvision's layer ``feature_layer`` (34: conv5_4 before its ReLU), the
  layers under torchvision's ``features.{index}`` names, ImageNet
  normalization of [0, 1] inputs;
- :class:`ResNet101FeatureExtractor`: the bottleneck trunk conv1 ..
  layer3 (``stage_blocks`` 3, 4, 23) as JAX builds it, in a ``features``
  Sequential laid out as torchvision's children (``0`` conv1, ``1`` bn1,
  ``4``.. the layers, each block ``conv1..3``, ``bn1..3``,
  ``downsample.{0,1}``).  Its 3x3 stride-2 convs pad as XLA's SAME, (0, 1)
  on an even size, where torchvision pads (1, 1): JAX's choice, followed
  here (``ROADMAP.md`` lists the gap);
- :class:`MINCNet`: the VGG-style texture net, ``conv11`` .. ``conv53``.

Convs take Flax's default init (LeCun normal, biases zero), as the JAX
modules do; BatchNorm scale one, shift zero.  Pretrained weights arrive as
JAX trees through ``tools/from_jax.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.blocks import SameConv2d, materialize
from sradsgan_tpu_torch.nn.norm import BatchNorm2d

# VGG19 conv plan: (channels, convs per stage)
VGG19_PLAN: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 4),
                                           (512, 4), (512, 4))
MINC_PLAN: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 3),
                                          (512, 3), (512, 3))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _lecun(m: nn.Conv2d) -> nn.Conv2d:
    m.lecun_init = True
    return m


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] NCHW RGB -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean[:, None, None]) / std[:, None, None]


class VGGFeatureExtractor(nn.Module):
    """VGG19 features ``features[:feature_layer + 1]`` in torchvision's
    indexing (with ``use_bn`` the VGG19-BN indexing: conv, BatchNorm, ReLU,
    and a conv at ``feature_layer`` keeps its BatchNorm, as JAX's loop
    applies the two together), on ImageNet-normalized input with
    ``use_input_norm``."""

    def __init__(self, feature_layer: int = 34, use_bn: bool = False,
                 use_input_norm: bool = True, num_channels: int = 3, *,
                 seed: int = 0, device: torch.device | str = "cpu"):
        super().__init__()
        self.use_input_norm = use_input_norm
        layers = []
        c_in = num_channels
        with torch.device("meta"):  # skip torch's default init
            for ch, n_convs in VGG19_PLAN:
                for _ in range(n_convs):
                    layers.append(_lecun(nn.Conv2d(c_in, ch, 3, padding=1)))
                    if use_bn:
                        layers.append(BatchNorm2d(ch))
                    layers.append(nn.ReLU())
                    c_in = ch
                layers.append(nn.MaxPool2d(2, 2))
            end = feature_layer + 1
            if use_bn and isinstance(layers[feature_layer], nn.Conv2d):
                end += 1  # JAX applies a conv's BatchNorm with it
            self.features = nn.Sequential(*layers[:end])
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_input_norm:
            x = imagenet_normalize(x)
        return self.features(x)


class Bottleneck(nn.Module):
    """ResNet bottleneck: 1x1, 3x3 (the stride, SAME), 1x1 to 4x, each conv
    bias-free with a BatchNorm, ReLU between; the input through
    ``downsample`` (1x1 at the stride, BatchNorm) where the shape changes;
    ReLU of the sum."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        out = 4 * features
        self.conv1 = _lecun(nn.Conv2d(in_features, features, 1, bias=False))
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _lecun(SameConv2d(features, features, 3, stride,
                                       bias=False))
        self.bn2 = BatchNorm2d(features)
        self.conv3 = _lecun(nn.Conv2d(features, out, 1, bias=False))
        self.bn3 = BatchNorm2d(out)
        self.relu = nn.ReLU()
        self.downsample = None
        if in_features != out or stride != 1:
            self.downsample = nn.Sequential(
                _lecun(SameConv2d(in_features, out, 1, stride, bias=False)),
                BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet101FeatureExtractor(nn.Module):
    """The ResNet-101 trunk through layer3 (``stage_blocks`` bottlenecks a
    stage, widths 64, 128, 256 x 4; stride 2 at the first block of every
    stage but the first), after a 7x7 stride-2 conv, BatchNorm, ReLU and a
    3x3 stride-2 max pool; ImageNet-normalized input with
    ``use_input_norm``."""

    def __init__(self, use_input_norm: bool = True,
                 stage_blocks: Sequence[int] = (3, 4, 23),
                 num_channels: int = 3, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        self.use_input_norm = use_input_norm
        with torch.device("meta"):  # skip torch's default init
            layers = [_lecun(nn.Conv2d(num_channels, 64, 7, 2, 3,
                                       bias=False)),
                      BatchNorm2d(64), nn.ReLU(), nn.MaxPool2d(3, 2, 1)]
            c_in = 64
            for stage, blocks in enumerate(stage_blocks):
                feats = 64 * 2 ** stage
                layer = []
                for b in range(blocks):
                    stride = 2 if b == 0 and stage > 0 else 1
                    layer.append(Bottleneck(c_in, feats, stride))
                    c_in = 4 * feats
                layers.append(nn.Sequential(*layer))
            self.features = nn.Sequential(*layers)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_input_norm:
            x = imagenet_normalize(x)
        return self.features(x)


class MINCNet(nn.Module):
    """The MINC texture net: VGG-style 3x3 convs ``conv{stage}{i}`` with
    ReLU (none after the last, conv53), a 2x2 max pool between stages."""

    def __init__(self, num_channels: int = 3, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        c_in = num_channels
        with torch.device("meta"):  # skip torch's default init
            for stage, (ch, n_convs) in enumerate(MINC_PLAN, 1):
                for c in range(1, n_convs + 1):
                    self.add_module(f"conv{stage}{c}", _lecun(
                        nn.Conv2d(c_in, ch, 3, padding=1)))
                    c_in = ch
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = (len(MINC_PLAN), MINC_PLAN[-1][1])
        for stage, (_, n_convs) in enumerate(MINC_PLAN, 1):
            if stage > 1:
                x = F.max_pool2d(x, 2, 2)
            for c in range(1, n_convs + 1):
                x = getattr(self, f"conv{stage}{c}")(x)
                if (stage, c) != last:
                    x = torch.relu(x)
        return x
