"""x0-prediction Gaussian diffusion for conditional SR, on NCHW tensors.

Counterpart of ``sradsgan_tpu/diffusion/gaussian.py`` (the reference's
GDP_x0 ``diffusion.py:21-299``).  The denoiser's output is x̂₀ itself,
clipped to [-1, 1] in the reverse chain; training minimizes the sum of
squared errors of x̂₀ over the element count, in float32; sampling is the
DDPM ancestral chain over ``t = n-1 ... 0``, conditioned by the bicubic
re-upsample concatenated on the channel axis.

The beta schedules and the ``Schedule`` constants are computed in float64
numpy and stored as float32, as the JAX package stores them.

Randomness comes from an explicit ``torch.Generator``.  Its draws are made
on the generator's device and moved to the data's, so one CPU generator
feeds the card and the CPU the same noise.  The public functions draw ``t``
and the noise and call the plain functions :func:`p_losses_given` and
:func:`p_sample_step`, which take them as arguments: JAX's PRNG cannot be
reproduced in torch, so a comparison with JAX hands both sides the same
``t`` and noise through those.

``model`` is any callable ``(x, t) -> x̂₀`` on NCHW tensors, ``x`` the
noisy image and the conditioner concatenated, ``t`` (B,) integers: the
``UNet`` itself, or a wrapper that runs it under autocast.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

Denoiser = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4,
                       linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedules, float64 (reference diffusion.py:21-51)."""
    if schedule == "quad":
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5,
                           n_timestep, dtype=np.float64) ** 2
    if schedule == "linear":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64)
    if schedule in ("warmup10", "warmup50"):
        frac = 0.1 if schedule == "warmup10" else 0.5
        betas = linear_end * np.ones(n_timestep, dtype=np.float64)
        warm = int(n_timestep * frac)
        betas[:warm] = np.linspace(linear_start, linear_end, warm,
                                   dtype=np.float64)
        return betas
    if schedule == "const":
        return linear_end * np.ones(n_timestep, dtype=np.float64)
    if schedule == "jsd":
        return 1.0 / np.linspace(n_timestep, 1, n_timestep, dtype=np.float64)
    if schedule == "cosine":
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
        alphas = np.cos((steps + cosine_s) / (1 + cosine_s)
                        * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        return np.clip(betas, None, 0.999)
    raise NotImplementedError(schedule)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The diffusion constants, float32 numpy (reference buffers,
    :108-151)."""

    betas: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    # each constant as a tensor, by (name, device): copied to a device once
    _tables: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    def table(self, name: str, device: torch.device) -> torch.Tensor:
        """The constant ``name`` as a float32 tensor on ``device``."""
        key = (name, str(device))
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(
                getattr(self, name)).to(device)
        return self._tables[key]

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    @classmethod
    def create(cls, schedule: str = "linear", n_timestep: int = 1000,
               linear_start: float = 1e-4,
               linear_end: float = 2e-2) -> "Schedule":
        betas = make_beta_schedule(schedule, n_timestep, linear_start,
                                   linear_end)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        return cls(
            betas=betas.astype(np.float32),
            sqrt_alphas_cumprod=np.sqrt(ac).astype(np.float32),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1 - ac).astype(np.float32),
            posterior_mean_coef1=(betas * np.sqrt(ac_prev)
                                  / (1 - ac)).astype(np.float32),
            posterior_mean_coef2=((1 - ac_prev) * np.sqrt(alphas)
                                  / (1 - ac)).astype(np.float32),
            posterior_log_variance_clipped=np.log(
                np.maximum(post_var, 1e-20)).astype(np.float32),
        )


def _gather(sched: Schedule, name: str, t: torch.Tensor,
            like: torch.Tensor) -> torch.Tensor:
    """The constant ``name`` at ``t`` as (B, 1, 1, 1) in ``like``'s dtype
    and device."""
    table = sched.table(name, like.device)
    return table[t.to(like.device)].to(like.dtype)[:, None, None, None]


def _randn(shape, generator: Optional[torch.Generator],
           like: torch.Tensor) -> torch.Tensor:
    """Standard normal draws of ``generator`` (on its device), moved to
    ``like``'s device and dtype."""
    device = generator.device if generator is not None else like.device
    out = torch.randn(shape, generator=generator, device=device,
                      dtype=torch.float32)
    return out.to(like.device, like.dtype)


def q_sample(sched: Schedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward noising q(x_t | x_0) (reference diffusion.py:265-274)."""
    return (_gather(sched, "sqrt_alphas_cumprod", t, x_start) * x_start
            + _gather(sched, "sqrt_one_minus_alphas_cumprod", t, x_start)
            * noise)


def p_losses_given(model: Denoiser, sched: Schedule, x0: torch.Tensor,
                   cond: torch.Tensor, t: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
    """The x0-prediction loss at the given timesteps and noise: the sum of
    squared errors of x̂₀ in float32 (float64 for a float64 reference) over
    the element count (the reference's normalization,
    GDP_x0/model/model.py:48-58)."""
    x_t = q_sample(sched, x0, t, noise)
    x_recon = model(torch.cat([x_t, cond], dim=1), t)
    dtype = torch.promote_types(x0.dtype, torch.float32)  # float64 kept
    diff = (x_recon.to(dtype) - x0.to(dtype)) ** 2
    return diff.sum() / float(x0.numel())


def draw_timesteps_and_noise(sched: Schedule, x0: torch.Tensor,
                             generator: Optional[torch.Generator] = None):
    """``t`` uniform in [0, n) for each image and standard normal noise of
    x0's shape, drawn in that order."""
    device = generator.device if generator is not None else x0.device
    t = torch.randint(0, sched.num_timesteps, (x0.shape[0],),
                      generator=generator, device=device)
    return t.to(x0.device), _randn(x0.shape, generator, x0)


def p_losses(model: Denoiser, sched: Schedule, x0: torch.Tensor,
             cond: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x0-prediction training loss (reference diffusion.py:276-296):
    ``x0`` the HR batch and ``cond`` the bicubic conditioner, both in
    [-1, 1]; ``t`` and the noise drawn from ``generator``."""
    t, noise = draw_timesteps_and_noise(sched, x0, generator)
    return p_losses_given(model, sched, x0, cond, t, noise)


def p_sample_step(model: Denoiser, sched: Schedule, img: torch.Tensor,
                  cond: torch.Tensor, t: int,
                  noise: Optional[torch.Tensor],
                  clip_denoised: bool = True) -> torch.Tensor:
    """One ancestral step from x_t to x_{t-1}: x̂₀ (clipped to [-1, 1]),
    the posterior mean ``c1[t]·x̂₀ + c2[t]·img`` and, for ``t > 0``, the
    posterior standard deviation times ``noise`` (which may be None at
    ``t == 0``)."""
    tb = torch.full((img.shape[0],), t, dtype=torch.long, device=img.device)
    x_recon = model(torch.cat([img, cond], dim=1), tb).to(img.dtype)
    if clip_denoised:
        x_recon = x_recon.clamp(-1.0, 1.0)
    mean = (float(sched.posterior_mean_coef1[t]) * x_recon
            + float(sched.posterior_mean_coef2[t]) * img)
    if t == 0:
        return mean
    std = float(np.exp(np.float32(0.5)
                       * sched.posterior_log_variance_clipped[t]))
    return mean + std * noise


def _run_chain(model: Denoiser, sched: Schedule, img: torch.Tensor,
               cond: torch.Tensor, hi: int, lo: int,
               generator: Optional[torch.Generator],
               clip_denoised: bool) -> torch.Tensor:
    """Steps t = hi-1 ... lo, the noise of each step with t > 0 drawn in
    that order."""
    for t in range(hi - 1, lo - 1, -1):
        noise = _randn(img.shape, generator, img) if t > 0 else None
        img = p_sample_step(model, sched, img, cond, t, noise, clip_denoised)
    return img


@torch.no_grad()
def p_sample_loop(model: Denoiser, sched: Schedule, cond: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  clip_denoised: bool = True) -> torch.Tensor:
    """The DDPM ancestral reverse chain (reference diffusion.py:207-237):
    ``cond`` the bicubic re-upsample in [-1, 1], NCHW; the initial noise,
    then each step's noise, drawn from ``generator``.  Returns x̂₀ in
    [-1, 1], float32 (float64 for a float64 ``cond``)."""
    cond = cond.to(torch.promote_types(cond.dtype, torch.float32))
    img = _randn(cond.shape, generator, cond)
    return _run_chain(model, sched, img, cond, sched.num_timesteps, 0,
                      generator, clip_denoised)


def snapshot_bounds(n: int, n_snapshots: int) -> np.ndarray:
    """The chain's snapshot boundaries, ``n`` down to 0 (JAX
    ``gaussian.py:198``)."""
    return np.linspace(n, 0, n_snapshots + 1).astype(int)


@torch.no_grad()
def p_sample_chain(model: Denoiser, sched: Schedule, cond: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   n_snapshots: int = 10,
                   clip_denoised: bool = True) -> torch.Tensor:
    """Like :func:`p_sample_loop` (the same draws in the same order) but
    returns the reverse chain's snapshots, the reference's continuous
    sampling (diffusion.py:210, sr_mfe.py:275-403): (n_snapshots + 1, B,
    C, H, W), the initial noise, then the image at each boundary of
    :func:`snapshot_bounds`; the last is x̂₀."""
    cond = cond.to(torch.promote_types(cond.dtype, torch.float32))
    img = _randn(cond.shape, generator, cond)
    snapshots = [img]
    bounds = snapshot_bounds(sched.num_timesteps, n_snapshots)
    for hi, lo in zip(bounds[:-1], bounds[1:]):
        img = _run_chain(model, sched, img, cond, int(hi), int(lo),
                         generator, clip_denoised)
        snapshots.append(img)
    return torch.stack(snapshots)
