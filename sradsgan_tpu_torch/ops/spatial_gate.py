"""SLAM spatial gate: ``x * sigmoid(conv7x7([mean_c x; max_c x], w))``.

Counterpart of ``sradsgan_tpu/ops/spatial_gate.py`` and the Pallas kernels
in ``sradsgan_tpu/ops/pallas/slam.py``.  On a CUDA tensor the forward
launches the hand-written kernel in ``csrc/spatial_gate.cu`` and the
backward the one in ``csrc/spatial_gate_bwd.cu``; on a CPU tensor they run
:func:`spatial_gate_plain` and :func:`spatial_gate_bwd_plain`.  The gate
math runs in float32 whatever x's dtype, as in the JAX package; the stat
planes are zero-padded outside the image (SAME conv).

Gradients mirror the JAX custom-VJP stack (``slam.py:438-460, 517-565``):
:class:`SpatialGateFn`'s backward is itself an op, :class:`SpatialGateBwdFn`,
whose forward is the backward kernel and whose own backward differentiates
:func:`spatial_gate_bwd_plain`.  So a first-order backward runs the kernel
everywhere, inside the WGAN-GP's gradient too, and only the grad-of-grad
runs plain ops.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from sradsgan_tpu_torch.ops import _build, plain_dtype

KERNEL_SIZE = 7
PAD = KERNEL_SIZE // 2


def spatial_gate_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, C, H, W); w: (1, 2, k, k) OIHW, plane 0 = mean, 1 = max."""
    x32 = x.to(plain_dtype(x))
    with torch.autocast(x.device.type, enabled=False):
        planes = torch.cat([x32.mean(1, keepdim=True),
                            x32.amax(1, keepdim=True)], dim=1)
        gate = torch.sigmoid(F.conv2d(planes, w.to(x32.dtype), padding=PAD))
    return (x32 * gate).to(x.dtype)


def dw_contraction(ds: torch.Tensor, planes: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """dw from the (B, H, W) ds plane and the (B, 2, H, W) stat planes: the
    conv's weight gradient (``slam.py:_dw_contraction``), plain PyTorch."""
    with torch.autocast(ds.device.type, enabled=False):
        dw = torch.nn.grad.conv2d_weight(planes, w.shape, ds[:, None],
                                         padding=PAD)
    return dw.to(w.dtype)


def spatial_gate_bwd_plain(x: torch.Tensor, w: torch.Tensor,
                           g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of the gate for output cotangent g, in differentiable plain
    ops (``slam.py:_bwd_jnp``): the recomputed max, its ties counted with a
    floor of one, the transposed stencil for the planes' cotangents."""
    with torch.autocast(x.device.type, enabled=False):
        x32, g32, w32 = (t.to(plain_dtype(x)) for t in (x, g, w))
        mx = x32.amax(1)
        planes = torch.stack([x32.mean(1), mx], dim=1)
        gate = torch.sigmoid(F.conv2d(planes, w32, padding=PAD))[:, 0]
        ds = (g32 * x32).sum(1) * gate * (1.0 - gate)
        dplanes = F.conv_transpose2d(ds[:, None], w32, padding=PAD)
        is_max = (x32 == mx[:, None]).to(x32.dtype)
        ties = is_max.sum(1).clamp_min(1.0)
        dx = (g32 * gate[:, None] + dplanes[:, :1] / x.shape[1]
              + (dplanes[:, 1] / ties)[:, None] * is_max)
        dw = dw_contraction(ds, planes, w)
    return dx.to(x.dtype), dw


def _check_weight(op: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if (w.shape != (1, 2, KERNEL_SIZE, KERNEL_SIZE)
            or w.dtype != torch.float32 or w.device != x.device
            or not w.is_contiguous()):
        raise ValueError(
            f"{op}: w must be a contiguous float32 (1, 2, 7, 7) tensor "
            f"on {x.device}, got {w.dtype} {tuple(w.shape)} on {w.device}")


def spatial_gate_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel: stats, 7x7 stencil, sigmoid and multiply in one launch."""
    _build.check_input("spatial_gate", x, 4)
    _check_weight("spatial_gate", x, w)
    b, c, h, wd = x.shape
    out = torch.empty_like(x)
    _build.launch("sg_spatial_gate", x.device, x.data_ptr(), w.data_ptr(),
                  out.data_ptr(), b, c, h, wd, _build.DTYPE_CODES[x.dtype])
    spatial_gate_cuda.launches += 1
    return out


spatial_gate_cuda.launches = 0


def spatial_gate_bwd_cuda(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor
                          ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel: (dx, ds, mean, max), the last three (B, H, W)
    float32 planes for :func:`dw_contraction`."""
    _build.check_input("spatial_gate_bwd", x, 4)
    _build.check_like("spatial_gate_bwd", g, x, "g")
    _check_weight("spatial_gate_bwd", x, w)
    b, c, h, wd = x.shape
    dx = torch.empty_like(x)
    ds, gate, mean, mx = torch.empty((4, b, h, wd), device=x.device,
                                     dtype=torch.float32)
    _build.launch("sg_spatial_gate_bwd", x.device, x.data_ptr(),
                  g.data_ptr(), w.data_ptr(), ds.data_ptr(), gate.data_ptr(),
                  mean.data_ptr(), mx.data_ptr(), dx.data_ptr(), b, c, h, wd,
                  _build.DTYPE_CODES[x.dtype])
    spatial_gate_bwd_cuda.launches += 1
    return dx, ds, mean, mx


spatial_gate_bwd_cuda.launches = 0


def _gate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return spatial_gate_plain(x, w)
    return spatial_gate_cuda(x, w)


class SpatialGateBwdFn(torch.autograd.Function):
    """(x, w, g) -> (dx, dw).  Forward: the backward kernel and the dw
    contraction (plain on the CPU).  Backward: autograd of
    :func:`spatial_gate_bwd_plain` (``slam.py:_gate_bwd_bwd``)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, w, g):
        ctx.save_for_backward(x, w, g)
        if x.device.type == "cpu":
            return spatial_gate_bwd_plain(x, w, g)
        dx, ds, mean, mx = spatial_gate_bwd_cuda(x, w, g)
        return dx, dw_contraction(ds, torch.stack([mean, mx], dim=1), w)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    @once_differentiable
    def backward(ctx, gdx, gdw):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = spatial_gate_bwd_plain(*inputs)
            return torch.autograd.grad(outs, inputs, (gdx, gdw),
                                       allow_unused=True)


class SpatialGateFn(torch.autograd.Function):
    """Forward: the gate kernel (plain on the CPU).  Backward:
    :class:`SpatialGateBwdFn`, so the gradient is differentiable again."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _gate(x, w)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return SpatialGateBwdFn.apply(x, w, g.contiguous())


def spatial_gate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) gated by its own 7x7 channel-statistics conv;
    differentiable twice."""
    if _build.needs_grad(x, w):
        return SpatialGateFn.apply(x, w)
    return _gate(x, w)
