"""The generator + discriminator WGAN-GP train step in PyTorch.

Counterpart of ``sradsgan_tpu/train/trainer.py:Trainer._train_step``, for
the models of the port's registry (``models/__init__.py``).  One step:

- **G step.** ``sr = G(lr)``; loss = ``w_pixel * pixel(sr, hr)`` + ``w_content
  * pixel(VGG(sr), VGG(hr))`` (the HR features carry no gradient) +
  ``w_gan * adversarial_g(D(sr))``; one Adam step on G.
- **D step.** ``adversarial_d(D(hr), D(sr.detach()))`` plus, for WGAN-GP,
  the gradient penalty on interpolates with gradient weight ``lambda + 1``
  (the reference backprops the penalty twice), while the logged ``loss_D``
  carries ``lambda``; one Adam step on D, then every D parameter clipped to
  ``+-clip_value``.

The discriminator runs the reference's four train-mode forwards (sr in the
G step, then hr, sr.detach() and the interpolates), each updating the
BatchNorm running statistics.  The JAX step shares the first two and
replays the second BatchNorm update in closed form (``trainer.py:313-322``),
so the running statistics agree to a tolerance, not bit for bit.

Precision: float32 (``cfg.bf16`` off, the parity mode), or the JAX
default's mixed precision: bf16 generator and VGG convs under autocast
(``cfg.bf16``), bf16 discriminator convs (``cfg.d_bf16`` as well), over
float32 parameters, float32 BatchNorm and float32 gate and softmax math
inside the kernels' ops.  A CPU trainer whose networks are cast with
``.double()`` takes the whole step in float64, the reference that
``chip_smoke.py`` holds the card's float32 step to.

Batches are dicts of NHWC float32 numpy arrays in [0, 1], ``lr`` and
``hr``, as ``bench.py`` feeds the JAX trainer.  The data feed, validation,
the epoch loop with plateau backtracking and chain initialization are not
ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from sradsgan_tpu_torch.config import TrainConfig
from sradsgan_tpu_torch.losses import gan as gan_losses
from sradsgan_tpu_torch.losses.pixel import pixel_loss
from sradsgan_tpu_torch.losses.vgg import load_vgg19
from sradsgan_tpu_torch.models import create_generator, get_spec
from sradsgan_tpu_torch.ops import plain_dtype
from sradsgan_tpu_torch.train.state import make_optimizer


class Trainer:
    """Models, optimizers and the step of one GAN (or pixel-only) model.

    Weights are drawn from seeds derived from ``cfg.seed``: the generator
    from ``seed``, the discriminator from ``seed + 1``, the VGG features
    (without ``SRADSGAN_TPU_VGG19_NPZ``) from ``seed + 2``; the penalty's
    interpolation weights from a CPU ``torch.Generator`` seeded with
    ``seed + 1`` unless a step is given its own.
    """

    def __init__(self, cfg: TrainConfig, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Trainer(device={str(device)!r}) needs a CUDA device and "
                "this torch sees none; pass device='cpu' to train on the CPU")
        self.cfg = cfg
        self.spec = get_spec(cfg.model)
        self.g_bf16 = cfg.bf16
        self.d_bf16 = cfg.bf16 and cfg.d_bf16

        self.generator = create_generator(
            cfg.model, cfg.scale, num_channels=cfg.num_channels,
            seed=cfg.seed, device=self.device, **cfg.model_kwargs).train()
        self.discriminator: Optional[nn.Module] = None
        self.vgg: Optional[nn.Module] = None
        self.d_opt: Optional[torch.optim.Optimizer] = None
        if self.spec.adversarial:
            self.discriminator = self.spec.discriminator(
                num_channels=cfg.num_channels, seed=cfg.seed + 1,
                device=self.device).train()
            if cfg.gan.weight_content > 0:
                self.vgg = load_vgg19(seed=cfg.seed + 2, device=self.device)
        o = cfg.optim
        self.g_opt = make_optimizer(self.generator.parameters(), o.lr, o.b1,
                                    o.b2)
        if self.discriminator is not None:
            self.d_opt = make_optimizer(self.discriminator.parameters(),
                                        o.lr, o.b1, o.b2)
        self.alpha_generator = torch.Generator().manual_seed(cfg.seed + 1)
        self.step = 0

    # ------------------------------------------------------------------
    def _autocast(self, bf16: bool):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=bf16)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """NHWC numpy -> NCHW on the device, in the generator's parameter
        dtype (float32; float64 for a reference trainer)."""
        dtype = next(self.generator.parameters()).dtype
        t = torch.from_numpy(np.asarray(x, np.float32)).to(self.device, dtype)
        return t.permute(0, 3, 1, 2).contiguous()

    def _d(self, x: torch.Tensor) -> torch.Tensor:
        """A train-mode D forward in the D's precision."""
        with self._autocast(self.d_bf16):
            return self.discriminator(x.to(plain_dtype(x)))

    @staticmethod
    def _update(opt: torch.optim.Optimizer, model: nn.Module,
                loss: torch.Tensor) -> None:
        """Gradients of ``loss`` for ``model``'s parameters alone, left in
        their ``.grad``, then one optimizer step."""
        params = [p for p in model.parameters() if p.requires_grad]
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        opt.step()

    # ------------------------------------------------------------------
    def train_step(self, batch: Mapping[str, np.ndarray],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One G and one D update.  ``generator`` draws the penalty's
        interpolation weights (default: the trainer's own).  Returns the
        step's losses as 0-dim tensors on the device (reading them waits
        for the device); each parameter's ``.grad`` holds the gradient the
        step applied."""
        lr_img = self._to_device(batch["lr"])
        hr_img = self._to_device(batch["hr"])
        metrics: Dict[str, torch.Tensor] = {}
        sr = self._g_step(lr_img, hr_img, metrics)
        if self.discriminator is not None:
            self._d_step(hr_img, sr.detach(),
                         generator or self.alpha_generator, metrics)
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def _g_step(self, lr_img: torch.Tensor, hr_img: torch.Tensor,
                metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
        gan = self.cfg.gan
        with self._autocast(self.g_bf16):
            sr = self.generator(lr_img)
            p_loss = pixel_loss(sr, hr_img, self.spec.pixel_loss)
            loss = gan.weight_pixel * p_loss
            metrics["pixel"] = p_loss
            if self.vgg is not None:
                feats = self.vgg(torch.cat([sr, hr_img]))
                feat_sr, feat_hr = feats.chunk(2)
                c_loss = pixel_loss(feat_sr, feat_hr.detach(),
                                    self.spec.pixel_loss)
                loss = loss + gan.weight_content * c_loss
                metrics["content"] = c_loss
            if self.discriminator is not None:
                fake = self._d(sr)
                real = self._d(hr_img) if gan.relativistic else None
                adv = gan_losses.adversarial_loss_g(
                    fake, gan.gan_type, real_logits=real,
                    relativistic=gan.relativistic)
                loss = loss + gan.weight_gan * adv
                metrics["adv_g"] = adv
        self._update(self.g_opt, self.generator, loss)
        metrics["loss_G"] = loss
        return sr

    def _d_step(self, hr_img: torch.Tensor, sr: torch.Tensor,
                generator: torch.Generator,
                metrics: Dict[str, torch.Tensor]) -> None:
        gan = self.cfg.gan
        loss = gan_losses.adversarial_loss_d(
            self._d(hr_img), self._d(sr), gan.gan_type,
            relativistic=gan.relativistic)
        objective = loss
        if gan.gan_type == "wgan-gp":
            alpha = gan_losses.interpolation_weights(hr_img.shape[0],
                                                     generator, self.device)
            gp = gan_losses.gradient_penalty(self._d, hr_img, sr, alpha)
            gp_weight = gan.lambda_gp + (1.0 if gan.gp_inner_backward
                                         else 0.0)
            objective = loss + gp_weight * gp
            loss = loss + gan.lambda_gp * gp
        self._update(self.d_opt, self.discriminator, objective)
        if gan.gan_type == "wgan-gp":  # weight clip, every D parameter
            with torch.no_grad():
                for p in self.discriminator.parameters():
                    p.clamp_(-gan.clip_value, gan.clip_value)
        metrics["loss_D"] = loss

    def train(self, batches: Iterable[Mapping[str, np.ndarray]],
              num_steps: int) -> Dict[str, float]:
        """Up to ``num_steps`` steps over ``batches``; the last step's
        losses as floats."""
        metrics: Dict[str, torch.Tensor] = {}
        for _, batch in zip(range(num_steps), batches):
            metrics = self.train_step(batch)
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    def save_checkpoint(self, epoch: int,
                        include_optimizer: bool = False) -> str:
        """G and D weights (D's running statistics included) and the step
        count into ``cfg.model_dir``; optimizer states on request."""
        os.makedirs(self.cfg.model_dir, exist_ok=True)
        path = os.path.join(self.cfg.model_dir, f"ckpt_epoch_{epoch}.pt")
        state = {"generator": self.generator.state_dict(), "step": self.step}
        if self.discriminator is not None:
            state["discriminator"] = self.discriminator.state_dict()
        if include_optimizer:
            state["g_opt"] = self.g_opt.state_dict()
            if self.d_opt is not None:
                state["d_opt"] = self.d_opt.state_dict()
        torch.save(state, path)
        return path

    def load_checkpoint(self, path: str) -> None:
        """Restore what :meth:`save_checkpoint` wrote."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.generator.load_state_dict(state["generator"])
        if self.discriminator is not None and "discriminator" in state:
            self.discriminator.load_state_dict(state["discriminator"])
        if "g_opt" in state:
            self.g_opt.load_state_dict(state["g_opt"])
        if self.d_opt is not None and "d_opt" in state:
            self.d_opt.load_state_dict(state["d_opt"])
        self.step = state["step"]

