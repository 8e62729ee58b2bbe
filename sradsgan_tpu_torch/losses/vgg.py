"""VGG19 perceptual features for the content loss.

Counterpart of ``sradsgan_tpu/losses/vgg.py``: torchvision's
``vgg19.features[:12]`` (conv1_1 ... relu3_1) applied to raw [0, 1] images,
with no ImageNet normalization, as the reference feeds it.  The layers keep
torchvision's indices (``features.0``, ``features.2``, ...), so a
torchvision state dict loads as it is.

Weights come from the ``.npz`` that ``SRADSGAN_TPU_VGG19_NPZ`` names (the
JAX package's layout, ``{conv1_1,...}/{kernel,bias}`` with HWIO kernels,
written by ``sradsgan_tpu/tools/convert_torch.py``).  Without it the
features are drawn from a seeded LeCun-normal init, as the JAX trainer
falls back to a fixed-seed init: the loss then still regularizes structure
but its values are not the reference's.  The extractor is fixed: its
parameters take no gradient.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

DEFAULT_WEIGHTS_ENV = "SRADSGAN_TPU_VGG19_NPZ"
# (name, torchvision features index, in, out, followed by a 2x2 max pool)
LAYERS = (
    ("conv1_1", 0, 3, 64, False),
    ("conv1_2", 2, 64, 64, True),
    ("conv2_1", 5, 64, 128, False),
    ("conv2_2", 7, 128, 128, True),
    ("conv3_1", 10, 128, 256, False),
)


class VGG19Features(nn.Module):
    """conv1_1 ... relu3_1 of VGG19: (B, 3, H, W) -> (B, 256, H/4, W/4)."""

    def __init__(self, *, seed: int = 0, device: torch.device | str = "cpu"):
        super().__init__()
        layers = []
        for _, _, c_in, c_out, pool in LAYERS:
            layers += [nn.Conv2d(c_in, c_out, 3, padding=1), nn.ReLU()]
            if pool:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.features:
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
                    m.bias.zero_()
        self.requires_grad_(False)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


def load_vgg19(path: Optional[str] = None, *, seed: int = 0,
               device: torch.device | str = "cpu") -> VGG19Features:
    """The extractor, with the weights of ``path`` (default: the file
    ``SRADSGAN_TPU_VGG19_NPZ`` names) when there is one, else seeded."""
    from sradsgan_tpu_torch.tools.from_jax import load_npz, vgg19_state_dict

    model = VGG19Features(seed=seed)
    path = path or os.environ.get(DEFAULT_WEIGHTS_ENV)
    if path and os.path.exists(path):
        model.load_state_dict(vgg19_state_dict(load_npz(path)))
    return model.to(device)
