"""Batched degradation: Gaussian blur kernels, noise and SRMD-style
preprocessing of NHWC float batches on their own device.

Counterpart of ``sradsgan_tpu/ops/degrade.py`` (the reference's
``BatchSRKernel``, ``BatchBlur`` and ``SRMDPreprocessing`` of model/util.py
and the image noise of data/dataset.py).  Randomness comes from an explicit
``torch.Generator``; its draws are made on the generator's device and moved
to the data's.  Each random function is a draw followed by a deterministic
core that takes the draws as arguments (``*_from``), so that the math can
be held against the JAX package's given the same draws.

The blur is one grouped convolution over the batch (a group per image and
channel) after a reflect pad, as JAX computes it with
``lax.conv_general_dilated`` outside any Pallas call; the downsample is
``ops/resize.py:bicubic_resize``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sradsgan_tpu_torch.ops.resize import bicubic_resize


def _generator_device(generator: torch.Generator) -> torch.device:
    """The device the draws are made on: the generator's own, which the
    caller must hand in as JAX's counterparts require their key."""
    if not isinstance(generator, torch.Generator):
        raise TypeError("degrade: the draws need a torch.Generator, got "
                        f"{type(generator).__name__}")
    return generator.device


def _uniform(generator, shape, low: float, high: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator,
                   device=_generator_device(generator))
    return low + (high - low) * u


def gaussian_kernels_from(sigma_x: torch.Tensor, sigma_y: torch.Tensor,
                          theta: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size, size) Gaussian kernels of unit sum with the (B,) widths
    ``sigma_x``, ``sigma_y`` along axes rotated by ``theta``."""
    ax = (torch.arange(size, dtype=torch.float32, device=sigma_x.device)
          - (size - 1) / 2.0)
    xx, yy = torch.meshgrid(ax, ax, indexing="xy")
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    xr = cos_t * xx + sin_t * yy
    yr = -sin_t * xx + cos_t * yy
    k = torch.exp(-0.5 * ((xr / sigma_x[:, None, None]) ** 2
                          + (yr / sigma_y[:, None, None]) ** 2))
    return k / k.sum(dim=(1, 2), keepdim=True)


def gaussian_kernels(generator: torch.Generator, batch: int,
                     size: int = 21, sigma_min: float = 0.2,
                     sigma_max: float = 4.0,
                     isotropic: bool = True) -> torch.Tensor:
    """(B, size, size) kernels on the generator's device with widths drawn
    uniformly in [sigma_min, sigma_max); anisotropic kernels draw a second
    width and an angle in [0, pi)."""
    sigma_x = _uniform(generator, (batch,), sigma_min, sigma_max)
    if isotropic:
        sigma_y, theta = sigma_x, torch.zeros_like(sigma_x)
    else:
        sigma_y = _uniform(generator, (batch,), sigma_min, sigma_max)
        theta = _uniform(generator, (batch,), 0.0, math.pi)
    return gaussian_kernels_from(sigma_x, sigma_y, theta, size)


def batch_blur(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Blur each image of an NHWC batch with its own (size, size) kernel,
    reflect-padded by ``size // 2`` so that the size is kept."""
    b, h, w, c = x.shape
    size = kernels.shape[-1]
    pad = size // 2
    planes = x.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    planes = F.pad(planes, (pad, pad, pad, pad), mode="reflect")
    weight = kernels.to(x).repeat_interleave(c, dim=0)[:, None]
    out = F.conv2d(planes, weight, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def add_gaussian_noise_from(x: torch.Tensor, noise: torch.Tensor,
                            sigma: float) -> torch.Tensor:
    """clip(x + sigma * noise, 0, 1) for standard normal ``noise``."""
    return torch.clamp(x + sigma * noise.to(x), 0.0, 1.0)


def add_gaussian_noise(generator: torch.Generator, x: torch.Tensor,
                       sigma: float = 0.01) -> torch.Tensor:
    noise = torch.randn(x.shape, generator=generator,
                        device=_generator_device(generator))
    return add_gaussian_noise_from(x, noise, sigma)


def add_poisson_noise_from(x: torch.Tensor, counts: torch.Tensor,
                           vals: float = 256.0) -> torch.Tensor:
    """clip(counts / vals, 0, 1) in ``x``'s dtype, for ``counts`` drawn
    from Poisson(max(x, 0) * vals)."""
    noisy = counts.to(x.device, torch.float32) / vals
    return torch.clamp(noisy, 0.0, 1.0).to(x.dtype)


def add_poisson_noise(generator: torch.Generator, x: torch.Tensor,
                      vals: float = 256.0) -> torch.Tensor:
    """Shot noise at a static ``vals`` levels (the reference's
    ``2**ceil(log2(#levels))`` for a fully populated 8-bit image)."""
    lam = torch.clamp(x.float() * vals, min=0.0).to(
        _generator_device(generator))
    counts = torch.poisson(lam, generator=generator)
    return add_poisson_noise_from(x, counts, vals)


def add_salt_pepper_noise_from(x: torch.Tensor, u: torch.Tensor,
                               amount: float = 0.01) -> torch.Tensor:
    """White where the (B, H, W, 1) uniform ``u`` < amount / 2, black
    where it is > 1 - amount / 2, ``x`` elsewhere."""
    u = u.to(x.device)
    salt = (u < amount / 2).to(x.dtype)
    pepper = (u > 1 - amount / 2).to(x.dtype)
    return torch.clamp(x * (1 - salt - pepper) + salt, 0.0, 1.0)


def add_salt_pepper_noise(generator: torch.Generator,
                          x: torch.Tensor,
                          amount: float = 0.01) -> torch.Tensor:
    u = torch.rand(x.shape[:3] + (1,), generator=generator,
                   device=_generator_device(generator))
    return add_salt_pepper_noise_from(x, u, amount)


def srmd_preprocess_from(hr: torch.Tensor, kernels: torch.Tensor, scale: int,
                         noise: Optional[torch.Tensor] = None,
                         noise_sigma: float = 0.0) -> torch.Tensor:
    """Blur by ``kernels``, bicubic down by ``scale``, add ``noise_sigma`` *
    ``noise`` (shaped as the LR) where ``noise_sigma`` > 0, clip to
    [0, 1]."""
    blurred = batch_blur(hr, kernels)
    lr = bicubic_resize(blurred, hr.shape[1] // scale, hr.shape[2] // scale)
    if noise_sigma > 0:
        lr = add_gaussian_noise_from(lr, noise, noise_sigma)
    return torch.clamp(lr, 0.0, 1.0)


def srmd_preprocess(generator: torch.Generator, hr: torch.Tensor,
                    scale: int, kernel_size: int = 21,
                    sigma_max: float = 4.0, noise_sigma: float = 0.0,
                    isotropic: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blur -> bicubic down -> noise on an NHWC HR batch; returns (lr,
    kernels), the kernels on ``hr``'s device."""
    kernels = gaussian_kernels(generator, hr.shape[0], kernel_size,
                               sigma_max=sigma_max,
                               isotropic=isotropic).to(hr.device)
    noise = None
    if noise_sigma > 0:
        noise = torch.randn(
            (hr.shape[0], hr.shape[1] // scale, hr.shape[2] // scale,
             hr.shape[3]), generator=generator,
            device=_generator_device(generator))
    return srmd_preprocess_from(hr, kernels, scale, noise,
                                noise_sigma), kernels
