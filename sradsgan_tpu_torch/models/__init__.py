"""Model registry of the port: name -> generator, discriminator, loss recipe.

Counterpart of ``sradsgan_tpu/models/__init__.py``, whose recipes (from the
reference's ``main_*.py``) it copies:

=========  ===========  ===============================================
model      adversarial  G loss
=========  ===========  ===============================================
edsr       no           L1
srgan      lsgan        MSE + 6e-3 * VGG + 1e-3 * adv (plain D)
drcan      wgan-gp      MSE + 1e-2 * VGG + 1e-3 * adv (plain D)
dssr       no           L1
sragan     wgan-gp      L1 + 1e-2 * VGG + 1e-3 * adv (CBAM D)
ndsrgan    lsgan        1e-2 * MSE + VGG + 2.5e-3 * adv (4x4 D)
amssrn     no           L1
sradsgan   wgan-gp      L1 + 1e-2 * VGG + 1e-3 * adv (CBAM D)
hat        no           L1
=========  ===========  ===============================================

:func:`config_for_model` fills
the port's ``TrainConfig`` (``sradsgan_tpu_torch/config.py``) from the
registry and the JAX ``config_for_model``'s per-model cases.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

from torch import nn

from sradsgan_tpu_torch.config import TrainConfig
from sradsgan_tpu_torch.models.amssrn import AMSSRN
from sradsgan_tpu_torch.models.discriminators import PatchDiscriminator
from sradsgan_tpu_torch.models.drcan import DRCAN
from sradsgan_tpu_torch.models.dssr import DSSR
from sradsgan_tpu_torch.models.edsr import EDSR
from sradsgan_tpu_torch.models.hat import HAT
from sradsgan_tpu_torch.models.ndsrgan import (NDSRGAN_D_BLOCKS,
                                               NDSRGANGenerator)
from sradsgan_tpu_torch.models.sradsgan import SRADSGANGenerator
from sradsgan_tpu_torch.models.sragan import SRAGANGenerator
from sradsgan_tpu_torch.models.srgan import SRGANGenerator


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static recipe for one model family (the JAX ``ModelSpec``'s
    fields)."""

    name: str
    generator: Callable[..., nn.Module]
    adversarial: bool = False
    gan_type: str = "wgan-gp"            # 'vanilla' | 'lsgan' | 'wgan-gp'
    discriminator: Optional[Callable[..., nn.Module]] = None
    pixel_loss: str = "l1"               # 'l1' | 'l2'
    weight_pixel: float = 1.0
    weight_content: float = 0.0          # VGG19 perceptual
    weight_gan: float = 0.0
    default_lr: float = 2e-4
    num_epochs: Optional[int] = None         # None: TrainConfig's default
    step_decay_epochs: Optional[int] = None  # None: TrainConfig's default


def _cbam_d(**kw) -> nn.Module:
    return PatchDiscriminator(use_attention=True, **kw)


def _plain_d(**kw) -> nn.Module:
    return PatchDiscriminator(use_attention=False, **kw)


def _ndsrgan_d(**kw) -> nn.Module:
    return PatchDiscriminator(blocks=NDSRGAN_D_BLOCKS, kernel_size=4,
                              use_attention=False, **kw)


_REGISTRY = {
    "edsr": ModelSpec("edsr", EDSR, pixel_loss="l1", default_lr=1e-4,
                      num_epochs=3),
    "srgan": ModelSpec("srgan", SRGANGenerator, adversarial=True,
                       gan_type="lsgan", discriminator=_plain_d,
                       pixel_loss="l2", weight_content=6e-3,
                       weight_gan=1e-3, default_lr=1e-4),
    "drcan": ModelSpec("drcan", DRCAN, adversarial=True, gan_type="wgan-gp",
                       discriminator=_plain_d, pixel_loss="l2",
                       weight_content=1e-2, weight_gan=1e-3),
    "dssr": ModelSpec("dssr", DSSR, pixel_loss="l1", default_lr=1e-4),
    "sragan": ModelSpec("sragan", SRAGANGenerator, adversarial=True,
                        gan_type="wgan-gp", discriminator=_cbam_d,
                        pixel_loss="l1", weight_content=1e-2,
                        weight_gan=1e-3),
    "ndsrgan": ModelSpec("ndsrgan", NDSRGANGenerator, adversarial=True,
                         gan_type="lsgan", discriminator=_ndsrgan_d,
                         pixel_loss="l2", weight_pixel=1e-2,
                         weight_content=1.0, weight_gan=2.5e-3,
                         num_epochs=47, step_decay_epochs=12),
    "amssrn": ModelSpec("amssrn", AMSSRN, pixel_loss="l1", default_lr=1e-4),
    "sradsgan": ModelSpec("sradsgan", SRADSGANGenerator, adversarial=True,
                          gan_type="wgan-gp", discriminator=_cbam_d,
                          pixel_loss="l1", weight_content=1e-2,
                          weight_gan=1e-3),
    "hat": ModelSpec("hat", HAT, pixel_loss="l1"),
}


def register(spec: ModelSpec) -> None:
    _REGISTRY[spec.name] = spec


def available_models() -> List[str]:
    return sorted(_REGISTRY)


def get_spec(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; have "
                       f"{available_models()}") from None


def create_generator(name: str, scale: int, **kwargs) -> nn.Module:
    return get_spec(name).generator(scale=scale, **kwargs)


def create_discriminator(name: str, **kwargs) -> nn.Module:
    spec = get_spec(name)
    if spec.discriminator is None:
        raise ValueError(f"model {name!r} has no discriminator")
    return spec.discriminator(**kwargs)


def config_for_model(model: str, scale: int, **overrides: Any) -> TrainConfig:
    """Per-model training defaults; ``overrides`` take dotted field names
    (``"gan.lambda_gp"``), as the JAX ``config_for_model``."""
    spec = get_spec(model)
    cfg = TrainConfig(model=model, scale=scale)
    cfg.optim.lr = spec.default_lr
    cfg.gan.gan_type = spec.gan_type
    cfg.gan.weight_pixel = spec.weight_pixel
    cfg.gan.weight_content = spec.weight_content
    cfg.gan.weight_gan = spec.weight_gan
    if spec.num_epochs is not None:
        cfg.num_epochs = spec.num_epochs
    if spec.step_decay_epochs is not None:  # NDSRGAN's (its ndsrgan.py)
        cfg.optim.step_decay_epochs = spec.step_decay_epochs
    for key, val in overrides.items():
        *parents, leaf = key.split(".")
        obj = cfg
        for part in parents:
            obj = getattr(obj, part)
        if not hasattr(obj, leaf):
            raise AttributeError(f"unknown config field {key!r}")
        setattr(obj, leaf, val)
    return cfg
