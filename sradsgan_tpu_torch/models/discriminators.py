"""The patch discriminators of the GAN models, in PyTorch (NCHW).

Counterpart of ``sradsgan_tpu/models/discriminators.py:PatchDiscriminator``
with ``use_global_attention`` off, as in the reference: conv blocks (3x3,
stride 1 and 2 alternating by default; symmetric padding ``(k - 1) // 2`` on
every conv as torch pads, where XLA's SAME pads a stride-2 conv (0, 1);
BatchNorm on all but the first; LeakyReLU 0.2), with ``use_attention`` the
CBAM (the CLAM channel gate, ratio 16, then the SLAM spatial gate) after
block 6 (on by default: the flagship's D; the JAX class defaults to off),
and a 3x3 conv to one logit channel.  SRADSGAN and SRAGAN train
against the CBAM D, SRGAN and DRCAN against the plain one
(``use_attention=False``), NDSRGAN against four 4x4 blocks
(``NDSRGAN_D_BLOCKS``, ``kernel_size=4``).

The layers sit in one ``nn.Sequential`` named ``model``, in the order of the
reference's flat Sequential, so its ``state_dict`` is what
``sradsgan_tpu/tools/import_reference.py:import_patch_discriminator`` reads.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from sradsgan_tpu_torch.nn.attention import ChannelGate, SpatialGate
from sradsgan_tpu_torch.nn.blocks import materialize
from sradsgan_tpu_torch.nn.norm import BatchNorm2d

# (out_filters, stride, normalize), as the JAX package's _DEFAULT_BLOCKS.
DEFAULT_BLOCKS: Tuple[Tuple[int, int, bool], ...] = (
    (64, 1, False), (64, 2, True), (128, 1, True), (128, 2, True),
    (256, 1, True), (256, 2, True), (512, 1, True), (512, 2, True),
)
ATTENTION_AFTER = 6  # CBAM follows this (1-based) block


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
                 use_attention: bool = True, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        layers = []
        c_in = num_channels
        k = kernel_size
        with torch.device("meta"):  # skip torch's default init
            for i, (filters, stride, normalize) in enumerate(blocks, 1):
                layers.append(nn.Conv2d(c_in, filters, k, stride,
                                        (k - 1) // 2))
                if normalize:
                    layers.append(BatchNorm2d(filters))
                layers.append(nn.LeakyReLU(0.2))
                if use_attention and i == ATTENTION_AFTER:
                    layers += [ChannelGate(filters), SpatialGate()]
                c_in = filters
            layers.append(nn.Conv2d(c_in, 1, 3, padding=1))
            self.model = nn.Sequential(*layers)
        materialize(self, seed)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
