"""Typed training configuration of the port.

The fields the port's trainer reads, with the defaults of the JAX package's
``TrainConfig`` (``sradsgan_tpu/core/config.py``); a test holds the two
sets of defaults equal.  Data, epoch-loop and plateau fields join when the
port gains the data feed and the epoch loop (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict


@dataclasses.dataclass
class OptimConfig:
    lr: float = 2e-4
    b1: float = 0.9
    b2: float = 0.999


@dataclasses.dataclass
class GanConfig:
    gan_type: str = "wgan-gp"     # 'vanilla' | 'lsgan' | 'wgan-gp'
    relativistic: bool = False
    lambda_gp: float = 10.0
    # The reference backprops the penalty inside its gradient_penalty() and
    # again with loss_D, so the applied gradients carry (1 + lambda_gp).
    gp_inner_backward: bool = True
    clip_value: float = 0.01      # D weight clip after each D step
    weight_pixel: float = 1.0
    weight_content: float = 1e-2  # VGG19 perceptual
    weight_gan: float = 1e-3


@dataclasses.dataclass
class TrainConfig:
    model: str = "sradsgan"
    scale: int = 4
    num_channels: int = 3
    seed: int = 0
    save_dir: str = "Result"
    bf16: bool = True             # bf16 generator (and VGG) convs
    d_bf16: bool = True           # bf16 discriminator convs, with bf16 on
    # Extra generator constructor kwargs (e.g. smaller test networks).
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    gan: GanConfig = dataclasses.field(default_factory=GanConfig)

    @property
    def model_dir(self) -> str:
        return os.path.join(self.save_dir,
                            f"{self.model.upper()}_x{self.scale}")
