"""GAN losses and the WGAN gradient penalty, counterpart of
``sradsgan_tpu/losses/gan.py``:

- vanilla: BCE-with-logits against 1 / 0 targets; lsgan: MSE against them;
  wgan-gp: ``-mean(D(x))`` for real targets, ``mean(D(x))`` for fake;
- the relativistic-average option;
- the gradient penalty on random interpolates, its norm taken over the
  CHANNEL axis at each pixel (the reference's ``.norm(p, 1)`` on NCHW), with
  1e-12 inside the square root, then ``(norm - 1)^2`` ('ls') or
  ``relu(norm - 1)`` ('hinge'), averaged.  The gradient keeps its graph
  (``create_graph=True``), so the penalty is differentiated once more.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from sradsgan_tpu_torch.ops import plain_dtype


def _gan_loss(logits: torch.Tensor, target_is_real: bool,
              gan_type: str) -> torch.Tensor:
    logits = logits.to(plain_dtype(logits))
    if gan_type == "vanilla":
        target = torch.full_like(logits, 1.0 if target_is_real else 0.0)
        return F.binary_cross_entropy_with_logits(logits, target)
    if gan_type == "lsgan":
        t = 1.0 if target_is_real else 0.0
        return ((logits - t) ** 2).mean()
    if gan_type == "wgan-gp":
        m = logits.mean()
        return -m if target_is_real else m
    raise ValueError(f"unknown gan type {gan_type!r}")


def adversarial_loss_g(fake_logits: torch.Tensor, gan_type: str,
                       real_logits: Optional[torch.Tensor] = None,
                       relativistic: bool = False) -> torch.Tensor:
    """Generator adversarial loss."""
    if relativistic:
        if real_logits is None:
            raise ValueError("the relativistic loss needs real_logits")
        real = real_logits.detach()
        return 0.5 * (_gan_loss(real - fake_logits.mean(), False, gan_type)
                      + _gan_loss(fake_logits - real.mean(), True, gan_type))
    return _gan_loss(fake_logits, True, gan_type)


def adversarial_loss_d(real_logits: torch.Tensor, fake_logits: torch.Tensor,
                       gan_type: str,
                       relativistic: bool = False) -> torch.Tensor:
    """Discriminator loss; lsgan averages the two terms, the others sum."""
    if relativistic:
        return 0.5 * (
            _gan_loss(real_logits - fake_logits.mean(), True, gan_type)
            + _gan_loss(fake_logits - real_logits.mean(), False, gan_type))
    loss = (_gan_loss(real_logits, True, gan_type)
            + _gan_loss(fake_logits, False, gan_type))
    return 0.5 * loss if gan_type == "lsgan" else loss


def interpolation_weights(batch: int, generator: torch.Generator,
                          device: torch.device) -> torch.Tensor:
    """The penalty's per-image alpha, uniform in [0, 1), (batch, 1, 1, 1).
    Drawn on the CPU from ``generator`` and moved to ``device``, so a seed
    gives the same alphas on every device."""
    return torch.rand((batch, 1, 1, 1), generator=generator).to(device)


def gradient_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     alpha: torch.Tensor, lp_norm: str = "l2",
                     penalty_type: str = "ls") -> torch.Tensor:
    """WGAN gradient penalty of ``d_fn`` on ``alpha * real + (1 - alpha) *
    fake`` (NCHW; real and fake carry no gradient)."""
    interp = (alpha * real.detach() + (1.0 - alpha) * fake.detach())
    interp.requires_grad_(True)
    logits = d_fn(interp)
    (grads,) = torch.autograd.grad(logits.to(plain_dtype(logits)).sum(),
                                   interp, create_graph=True)
    grads = grads.to(plain_dtype(grads))
    if lp_norm == "linf":
        norm = grads.abs().amax(1)
    elif lp_norm == "l1":
        norm = grads.abs().sum(1)
    elif lp_norm == "l2":
        norm = torch.sqrt((grads * grads).sum(1) + 1e-12)
    else:
        raise ValueError(f"unknown norm {lp_norm!r}")
    if penalty_type == "hinge":
        return F.relu(norm - 1.0).mean()
    if penalty_type == "ls":
        return ((norm - 1.0) ** 2).mean()
    raise ValueError(f"unknown penalty {penalty_type!r}")
