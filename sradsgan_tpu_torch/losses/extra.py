"""Auxiliary losses of the reference's loss library.

Counterpart of ``sradsgan_tpu/losses/extra.py``: the downscale consistency
loss (the SR image bicubic-downscaled back should match the LR input),
KernelGAN-style regularizers of a blur kernel (centred, small on its
border, sparse, summing to one), and the L1-ratio contrastive loss.  Images
are NCHW, as everywhere in the port; a kernel's last two axes are its
rows and columns.  The results are float32 scalars (float64 for
float64 images).
"""

from __future__ import annotations

import torch

from sradsgan_tpu_torch.ops import plain_dtype
from sradsgan_tpu_torch.ops.resize import bicubic_resize


def downscale_loss(sr: torch.Tensor, lr: torch.Tensor,
                   scale: int) -> torch.Tensor:
    """MSE between sr (B, C, sH, sW) resized by PIL's bicubic to lr's size
    and lr (B, C, H, W); ``scale`` is implied by the shapes, kept for
    JAX's signature."""
    h, w = lr.shape[2], lr.shape[3]
    dtype = plain_dtype(sr)
    down = bicubic_resize(sr.to(dtype).permute(0, 2, 3, 1), h, w)
    return ((down.permute(0, 3, 1, 2) - lr.to(dtype)) ** 2).mean()


def centralized_loss(kernel: torch.Tensor) -> torch.Tensor:
    """Squared offset of the kernel's centre of mass from its centre."""
    k = kernel / (kernel.sum((-2, -1), keepdim=True) + 1e-12)
    size = kernel.shape[-1]
    ax = torch.arange(size, dtype=torch.float32, device=kernel.device)
    center = (size - 1) / 2.0
    cy = (k * ax[None, :, None]).sum((-2, -1))
    cx = (k * ax[None, None, :]).sum((-2, -1))
    return ((cy - center) ** 2 + (cx - center) ** 2).mean()


def boundaries_loss(kernel: torch.Tensor, border: int = 2) -> torch.Tensor:
    """Mean |kernel| on a frame ``border`` wide (zero inside)."""
    size = kernel.shape[-1]
    mask = torch.ones((size, size), dtype=torch.float32,
                      device=kernel.device)
    mask[border:size - border, border:size - border] = 0.0
    return (kernel.abs() * mask).mean()


def sparsity_loss(kernel: torch.Tensor, power: float = 0.2) -> torch.Tensor:
    """Mean |kernel|^power."""
    return (kernel.abs() ** power).mean()


def sum_to_one_loss(kernel: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of the kernel's sum from one."""
    return ((kernel.sum((-2, -1)) - 1.0) ** 2).mean()


def contrastive_loss(anchor_feats: torch.Tensor, pos_feats: torch.Tensor,
                     neg_feats: torch.Tensor,
                     eps: float = 1e-7) -> torch.Tensor:
    """Mean over the batch of L1(anchor, positive) / (L1(anchor, negative)
    + eps), each L1 a mean over a sample's features."""
    dims = tuple(range(1, anchor_feats.dim()))
    d_pos = (anchor_feats - pos_feats).abs().mean(dims)
    d_neg = (anchor_feats - neg_feats).abs().mean(dims)
    return (d_pos / (d_neg + eps)).mean()
