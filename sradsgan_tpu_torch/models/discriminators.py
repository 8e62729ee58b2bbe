"""The discriminators of the GAN models, in PyTorch (NCHW).

Counterpart of ``sradsgan_tpu/models/discriminators.py``.  Its
``PatchDiscriminator``: conv blocks (3x3,
stride 1 and 2 alternating by default; symmetric padding ``(k - 1) // 2`` on
every conv as torch pads, where XLA's SAME pads a stride-2 conv (0, 1);
BatchNorm on all but the first; LeakyReLU 0.2), with ``use_attention`` the
CBAM (the CLAM channel gate, ratio 16, then the SLAM spatial gate) after
block 6 (on by default: the flagship's D; the JAX class defaults to off),
and a 3x3 conv to one logit channel.  SRADSGAN and SRAGAN train
against the CBAM D, SRGAN and DRCAN against the plain one
(``use_attention=False``), NDSRGAN against four 4x4 blocks
(``NDSRGAN_D_BLOCKS``, ``kernel_size=4``).  ``use_global_attention`` adds the
variant the reference intends but never builds: CGAM then SGAM after block
8, its SGAM built plain (``plain=True``: JAX runs einsums at the D's few
positions, and the gradient penalty differentiates the attention twice).
Its convs are :class:`~sradsgan_tpu_torch.nn.conv.DoubleGradConv2d`, whose
penalty term of second order runs on cuDNN's weight-gradient engines.

The layers sit in one ``nn.Sequential`` named ``model``, in the order of the
reference's flat Sequential, so its ``state_dict`` is what
``sradsgan_tpu/tools/import_reference.py:import_patch_discriminator`` reads.

Beside it the block library's other two: :class:`VGGStyleDiscriminator`
(a dense head over (3x3, 4x4 stride 2) BatchNorm stages) and
:class:`SNPatchDiscriminator` (spectrally normalized conv blocks).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from sradsgan_tpu_torch.nn.attention import (ChannelGate,
                                             ChannelSelfAttention,
                                             SpatialGate,
                                             SpatialSelfAttention)
from sradsgan_tpu_torch.nn.blocks import SameConv2d, materialize
from sradsgan_tpu_torch.nn.conv import DoubleGradConv2d
from sradsgan_tpu_torch.nn.norm import BatchNorm2d
from sradsgan_tpu_torch.nn.spectral_norm import SNConv

# (out_filters, stride, normalize), as the JAX package's _DEFAULT_BLOCKS.
DEFAULT_BLOCKS: Tuple[Tuple[int, int, bool], ...] = (
    (64, 1, False), (64, 2, True), (128, 1, True), (128, 2, True),
    (256, 1, True), (256, 2, True), (512, 1, True), (512, 2, True),
)
ATTENTION_AFTER = 6  # CBAM follows this (1-based) block
GLOBAL_ATTENTION_AFTER = 8  # CGAM + SGAM follow this one


class PatchDiscriminator(nn.Module):
    """(B, num_channels, H, W) -> (B, 1, H', W') patch logits (H / 2^s for
    3x3 blocks with s stride-2 ones).

    Conv and gate kernels are drawn normal(0.02) from
    ``torch.Generator().manual_seed(seed)``, biases zero, BatchNorm scale
    one and shift zero, as the JAX package inits them; then the module moves
    to ``device``.
    """

    def __init__(self,
                 blocks: Sequence[Tuple[int, int, bool]] = DEFAULT_BLOCKS,
                 num_channels: int = 3, kernel_size: int = 3,
                 use_attention: bool = True,
                 use_global_attention: bool = False, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        layers = []
        c_in = num_channels
        k = kernel_size
        with torch.device("meta"):  # skip torch's default init
            for i, (filters, stride, normalize) in enumerate(blocks, 1):
                layers.append(DoubleGradConv2d(c_in, filters, k, stride,
                                               (k - 1) // 2))
                if normalize:
                    layers.append(BatchNorm2d(filters))
                layers.append(nn.LeakyReLU(0.2))
                if use_attention and i == ATTENTION_AFTER:
                    layers += [ChannelGate(filters), SpatialGate()]
                if use_global_attention and i == GLOBAL_ATTENTION_AFTER:
                    layers += [ChannelSelfAttention(),
                               SpatialSelfAttention(filters, plain=True)]
                c_in = filters
            layers.append(DoubleGradConv2d(c_in, 1, 3, padding=1))
            self.model = nn.Sequential(*layers)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class VGGStyleDiscriminator(nn.Module):
    """(B, num_channels, S, S) -> (B, 1) logits, S = ``input_size``.

    JAX ``discriminators.py:36``: log2(S / 4) stages, each a 3x3 conv (a
    bias in the first stage only), BatchNorm (not in the first), LeakyReLU
    0.2, a 4x4 stride-2 SAME conv without bias, BatchNorm, LeakyReLU 0.2,
    the widths 64, 128, 256, 512, 512, ... (``base_nf`` doubling up to
    512); then ``classifier``: a dense layer to 100, LeakyReLU 0.2, a dense
    layer to 1.  The features are flattened in JAX's NHWC order, so a JAX
    dense kernel maps row for row.  Kernels normal(0.02), untruncated, as
    JAX's ``default_kernel_init``."""

    def __init__(self, input_size: int = 128, base_nf: int = 64,
                 num_channels: int = 3, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        n_stages = int(math.log2(input_size // 4))
        layers = []
        c_in, side = num_channels, input_size
        with torch.device("meta"):  # skip torch's default init
            for i in range(n_stages):
                out_nf = min(base_nf * 2 ** min(i, 3), 512)
                layers.append(nn.Conv2d(c_in, out_nf, 3, padding=1,
                                        bias=i == 0))
                if i > 0:
                    layers.append(BatchNorm2d(out_nf))
                layers += [nn.LeakyReLU(0.2),
                           SameConv2d(out_nf, out_nf, 4, 2, bias=False),
                           BatchNorm2d(out_nf), nn.LeakyReLU(0.2)]
                c_in, side = out_nf, -(-side // 2)
            self.features = nn.Sequential(*layers)
            self.classifier = nn.Sequential(
                nn.Linear(c_in * side * side, 100), nn.LeakyReLU(0.2),
                nn.Linear(100, 1))
            for m in self.classifier[::2]:  # the dense layers
                m.trunc_init = False
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.features(x).permute(0, 2, 3, 1).flatten(1)
        return self.classifier(feats)


class SNPatchDiscriminator(nn.Module):
    """(B, num_channels, H, W) -> (B, 1, H', W') patch logits.

    JAX ``discriminators.py:79``: per block a spectrally normalized 3x3
    conv (SAME, the block's stride; its ``u`` moves in train mode only) and
    LeakyReLU 0.2, then a 3x3 SAME conv to one channel.  The blocks' third
    field (normalize) is ignored, as in JAX."""

    def __init__(self,
                 blocks: Sequence[Tuple[int, int, bool]] = DEFAULT_BLOCKS,
                 num_channels: int = 3, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        layers = []
        c_in = num_channels
        with torch.device("meta"):  # skip torch's default init
            for filters, stride, _ in blocks:
                layers += [SNConv(c_in, filters, 3, stride),
                           nn.LeakyReLU(0.2)]
                c_in = filters
            layers.append(nn.Conv2d(c_in, 1, 3, padding=1))
            self.model = nn.Sequential(*layers)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
