"""Fused global average + max pool (the CLAM's two statistics in one pass).

Counterpart of ``sradsgan_tpu/ops/pallas/pooling.py``.  On a CUDA tensor
:func:`avg_max_pool` launches the hand-written kernel in
``csrc/pooling.cu``; on a CPU tensor it runs :func:`avg_max_pool_plain`, the
same math in plain PyTorch ops.  Both accumulate in float32 and return the
input's dtype.  The backward is plain PyTorch, as the JAX op's is jnp: a
broadcast, and the max's cotangent split evenly over tied maxima.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sradsgan_tpu_torch.ops import _build, define, plain_dtype


def avg_max_pool_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) -> (mean, max) over H, W, each (B, C)."""
    x32 = x.to(plain_dtype(x))
    return x32.mean((2, 3)).to(x.dtype), x32.amax((2, 3)).to(x.dtype)


def avg_max_pool_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: one read of x, both statistics."""
    _build.check_input("avg_max_pool", x, 4)
    b, c, h, w = x.shape
    avg = torch.empty((b, c), device=x.device, dtype=x.dtype)
    mx = torch.empty_like(avg)
    _build.launch("sg_avg_max_pool", x.device, x.data_ptr(), avg.data_ptr(),
                  mx.data_ptr(), b * c, h * w, _build.DTYPE_CODES[x.dtype])
    avg_max_pool_cuda.launches += 1
    return avg, mx


avg_max_pool_cuda.launches = 0


def _pool_cuda(x):
    # the wrapper by its module attribute, looked up at each call
    return avg_max_pool_cuda(x)


def _pool_fake(x):
    return x.new_empty(x.shape[:2]), x.new_empty(x.shape[:2])


_pool = define("avg_max_pool(Tensor x) -> (Tensor, Tensor)",
               avg_max_pool_plain, _pool_cuda, _pool_fake)


def avg_max_pool_bwd_plain(x: torch.Tensor, davg: torch.Tensor,
                           dmax: torch.Tensor) -> torch.Tensor:
    """Cotangent of x from those of the two pools (``pooling.py:105-118``).

    The max is recomputed from x, never taken from the forward, and the tie
    count is at least one, so the mask can never divide by zero.  Plain
    differentiable ops: the WGAN-GP differentiates this once more.
    """
    n = x.shape[2] * x.shape[3]
    g_avg = (davg / n)[:, :, None, None]
    is_max = (x == x.amax((2, 3), keepdim=True)).to(plain_dtype(x))
    ties = is_max.sum((2, 3), keepdim=True).clamp_min(1.0)
    g_max = (is_max / ties).to(x.dtype) * dmax[:, :, None, None]
    return g_avg.expand_as(x) + g_max


class AvgMaxPool(torch.autograd.Function):
    """Forward: the kernel on CUDA, the plain version on the CPU.  Backward:
    :func:`avg_max_pool_bwd_plain`, itself differentiable."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _pool(x)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, davg, dmax):
        (x,) = ctx.saved_tensors
        return avg_max_pool_bwd_plain(x, davg, dmax)


def avg_max_pool(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) -> (avg (B, C), max (B, C)); differentiable twice."""
    return AvgMaxPool.apply(x) if _build.needs_grad(x) else _pool(x)
