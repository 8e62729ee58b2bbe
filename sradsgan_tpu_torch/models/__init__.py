"""Model registry of the port: name -> generator, discriminator, loss recipe.

Counterpart of ``sradsgan_tpu/models/__init__.py``.  Only the flagship
SRADSGAN is ported so far; the other models of ``sradsgan_tpu.models`` are
queued in ROADMAP.md.  :func:`config_for_model` fills the port's
``TrainConfig`` (``sradsgan_tpu_torch/config.py``) from the registry, as
the JAX ``config_for_model`` does from its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

from torch import nn

from sradsgan_tpu_torch.config import TrainConfig
from sradsgan_tpu_torch.models.discriminators import PatchDiscriminator
from sradsgan_tpu_torch.models.sradsgan import SRADSGANGenerator


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


_REGISTRY = {
    "sradsgan": ModelSpec("sradsgan", SRADSGANGenerator, adversarial=True,
                          gan_type="wgan-gp",
                          discriminator=PatchDiscriminator,
                          pixel_loss="l1", weight_content=1e-2,
                          weight_gan=1e-3),
}


def register(spec: ModelSpec) -> None:
    _REGISTRY[spec.name] = spec


def available_models() -> List[str]:
    return sorted(_REGISTRY)


def get_spec(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet; the port has "
            f"{available_models()} and ROADMAP.md (Queue 1) lists the rest in "
            "order") from None


def create_generator(name: str, scale: int, **kwargs) -> nn.Module:
    return get_spec(name).generator(scale=scale, **kwargs)


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
    for key, val in overrides.items():
        *parents, leaf = key.split(".")
        obj = cfg
        for part in parents:
            obj = getattr(obj, part)
        if not hasattr(obj, leaf):
            raise AttributeError(f"unknown config field {key!r}")
        setattr(obj, leaf, val)
    return cfg
