"""SLAM spatial gate: ``x * sigmoid(conv7x7([mean_c x; max_c x], w))``.

Counterpart of ``sradsgan_tpu/ops/spatial_gate.py`` and the Pallas kernels
in ``sradsgan_tpu/ops/pallas/slam.py``.  On a CUDA tensor the forward
launches the hand-written kernels in ``csrc/spatial_gate.cu`` and the
backward the one in ``csrc/spatial_gate_bwd.cu`` (dx and dw in one call);
on a CPU tensor they run :func:`spatial_gate_plain` and
:func:`spatial_gate_bwd_plain`.  The dispatch is the registered ops
``torch.ops.sradsgan_tpu_torch.spatial_gate`` and ``::spatial_gate_bwd``.
The gate math runs in float32 whatever x's dtype, as in the JAX package;
the stat planes are zero-padded outside the image (SAME conv).

Gradients mirror the JAX custom-VJP stack (``slam.py:438-460, 517-565``):
:class:`SpatialGateFn`'s backward is itself an op, :class:`SpatialGateBwdFn`,
whose forward is the backward kernel and whose own backward differentiates
:func:`spatial_gate_bwd_plain`.  So a first-order backward runs the kernel
everywhere, inside the WGAN-GP's gradient too, and only the grad-of-grad
runs plain ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from sradsgan_tpu_torch.ops import _build, define, plain_dtype

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


def strip_planes(planes: torch.Tensor, e0: int, lo: int, hi: int
                 ) -> torch.Tensor:
    """Rows [lo, hi) of the image from ``planes`` (B, P, E, W), which holds
    the image's rows from ``e0`` on; rows outside the image are zero (the
    SAME convolution's padding)."""
    b, p, e, w = planes.shape
    out = planes.new_zeros((b, p, hi - lo, w))
    a, z = max(lo, e0), min(hi, e0 + e)
    if a < z:
        out[:, :, a - lo:z - lo] = planes[:, :, a - e0:z - e0]
    return out


def spatial_gate_plain_strips(x: torch.Tensor, w: torch.Tensor,
                              rows: int) -> torch.Tensor:
    """:func:`spatial_gate_plain` computed the way the kernel in
    ``csrc/spatial_gate.cu`` cuts the work: by strips of ``rows`` whole
    rows, each strip's gate from the statistics on its rows and ``PAD``
    rows beside them (zeros outside the image).  A second reference for the
    kernel's halo arithmetic; nothing on the main path calls it."""
    with torch.autocast(x.device.type, enabled=False):
        x32, w32 = x.to(plain_dtype(x)), w.to(plain_dtype(x))
        h = x32.shape[2]
        out = torch.empty_like(x32)
        for r0 in range(0, h, rows):
            r1 = min(h, r0 + rows)
            e0, e1 = max(0, r0 - PAD), min(h, r1 + PAD)
            xe = x32[:, :, e0:e1]
            stats = torch.stack([xe.mean(1), xe.amax(1)], dim=1)
            gate = torch.sigmoid(F.conv2d(
                strip_planes(stats, e0, r0 - PAD, r1 + PAD), w32,
                padding=(0, PAD)))
            out[:, :, r0:r1] = x32[:, :, r0:r1] * gate
    return out.to(x.dtype)


def spatial_gate_bwd_plain_strips(x: torch.Tensor, w: torch.Tensor,
                                  g: torch.Tensor, rows: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) as :func:`spatial_gate_bwd_plain`, computed the way the
    kernel in ``csrc/spatial_gate_bwd.cu`` cuts the work: by strips of
    ``rows`` whole rows, each with its halos (statistics 6 rows beyond the
    strip, the gate and ds 3, zeros outside the image) and its own partial
    of dw, the partials summed in strip order.  A second reference for the
    kernel's halo arithmetic; nothing on the main path calls it."""
    k = KERNEL_SIZE
    with torch.autocast(x.device.type, enabled=False):
        x32, g32, w32 = (t.to(plain_dtype(x)) for t in (x, g, w))
        b, c, h, wd = x32.shape
        flipped = w32[0][:, None].flip(-1, -2)       # (2, 1, k, k)
        dx = torch.empty_like(x32)
        dw = torch.zeros_like(w32)
        for r0 in range(0, h, rows):
            r1 = min(h, r0 + rows)
            e0, e1 = max(0, r0 - 2 * PAD), min(h, r1 + 2 * PAD)
            xe = x32[:, :, e0:e1]
            mx = xe.amax(1)
            stats = torch.stack([xe.mean(1), mx], dim=1)
            dgate = (g32[:, :, e0:e1] * xe).sum(1, keepdim=True)
            # the gate and ds where they exist, 3 rows beyond the strip
            g0, g1 = max(0, r0 - PAD), min(h, r1 + PAD)
            gate = torch.sigmoid(F.conv2d(
                strip_planes(stats, e0, g0 - PAD, g1 + PAD), w32,
                padding=(0, PAD)))
            ds = dgate[:, :, g0 - e0:g1 - e0] * gate * (1.0 - gate)
            ds_halo = strip_planes(ds, g0, r0 - PAD, r1 + PAD)
            dplanes = F.conv2d(ds_halo, flipped, padding=(0, PAD))
            xs = x32[:, :, r0:r1]
            is_max = (xs == mx[:, None, r0 - e0:r1 - e0]).to(x32.dtype)
            ties = is_max.sum(1).clamp_min(1.0)
            dx[:, :, r0:r1] = (
                g32[:, :, r0:r1] * gate[:, :, r0 - g0:r1 - g0]
                + dplanes[:, :1] / c + (dplanes[:, 1] / ties)[:, None] * is_max)
            # this strip's part of dw: its ds against the shifted planes
            halo = F.pad(strip_planes(stats, e0, r0 - PAD, r1 + PAD),
                         (PAD, PAD))
            own = ds[:, :, r0 - g0:r1 - g0]
            part = torch.stack([
                (own * halo[:, :, dy:dy + r1 - r0, dxx:dxx + wd]).sum((0, 2, 3))
                for dy in range(k) for dxx in range(k)], dim=1)
            dw = dw + part.reshape(1, 2, k, k)
    return dx.to(x.dtype), dw.to(w.dtype)


def _check_weight(op: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if (w.shape != (1, 2, KERNEL_SIZE, KERNEL_SIZE)
            or w.dtype != torch.float32 or w.device != x.device
            or not w.is_contiguous()):
        raise ValueError(
            f"{op}: w must be a contiguous float32 (1, 2, 7, 7) tensor "
            f"on {x.device}, got {w.dtype} {tuple(w.shape)} on {w.device}")


def spatial_gate_cuda(x: torch.Tensor, w: torch.Tensor,
                      rows: Optional[int] = None) -> torch.Tensor:
    """The kernel: the channel statistics of each strip of rows, then the
    7x7 stencil, sigmoid and multiply of each strip, two launches with the
    two stat planes between them in scratch.  ``rows``: the strip height,
    by default the plan's (``_build.plan``); any height whose strip fits a
    block's shared memory is taken (the probe and the tests force some)."""
    _build.check_input("spatial_gate", x, 4)
    _check_weight("spatial_gate", x, w)
    b, c, h, wd = x.shape
    if rows is None:
        rows = _build.plan("sg_spatial_gate", x.device, (b, c, h, wd),
                           x.dtype)["rows"]
    out = torch.empty_like(x)
    planes = torch.empty((2, b, h, wd), device=x.device, dtype=torch.float32)
    _build.launch("sg_spatial_gate", x.device, x.data_ptr(), w.data_ptr(),
                  out.data_ptr(), planes.data_ptr(), b, c, h, wd,
                  _build.DTYPE_CODES[x.dtype], rows)
    spatial_gate_cuda.launches += 1
    return out


spatial_gate_cuda.launches = 0


def spatial_gate_bwd_cuda(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                          with_dw: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: (dx, dw), dw float32 like w, summed in a fixed
    order (two calls give the same bits).  ``with_dw=False`` leaves the
    kernel's dw stage out and returns dw unwritten: for timing that stage
    apart, nothing else."""
    _build.check_input("spatial_gate_bwd", x, 4)
    _build.check_like("spatial_gate_bwd", g, x, "g")
    _check_weight("spatial_gate_bwd", x, w)
    b, c, h, wd = x.shape
    plan = _build.plan("sg_spatial_gate_bwd", x.device, (b, c, h, wd),
                       x.dtype)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    # scratch: a row of dw partials for each block of the stencils' launch,
    # and the seven per-pixel planes that pass between the launches
    partials = torch.empty(
        (plan["partial_rows"], 2 * KERNEL_SIZE * KERNEL_SIZE),
        device=x.device, dtype=torch.float32)
    planes = torch.empty((7, b, h, wd), device=x.device, dtype=torch.float32)
    _build.launch("sg_spatial_gate_bwd", x.device, x.data_ptr(),
                  g.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                  partials.data_ptr(), planes.data_ptr(), b, c, h, wd,
                  _build.DTYPE_CODES[x.dtype], *_build.plan_args(plan),
                  int(with_dw))
    spatial_gate_bwd_cuda.launches += 1
    return dx, dw


spatial_gate_bwd_cuda.launches = 0


# The wrappers by their module attributes, looked up at each call.
def _gate_cuda(x, w, rows=None):
    return spatial_gate_cuda(x, w, rows)


def _gate_bwd_cuda(x, w, g, with_dw=True):
    return spatial_gate_bwd_cuda(x, w, g, with_dw)


_gate = define("spatial_gate(Tensor x, Tensor w, int? rows=None) -> Tensor",
               lambda x, w, rows=None: spatial_gate_plain(x, w), _gate_cuda,
               lambda x, w, rows=None: torch.empty_like(x))
_gate_bwd = define(
    "spatial_gate_bwd(Tensor x, Tensor w, Tensor g, bool with_dw=True) "
    "-> (Tensor, Tensor)",
    lambda x, w, g, with_dw=True: spatial_gate_bwd_plain(x, w, g),
    _gate_bwd_cuda,
    lambda x, w, g, with_dw=True: (torch.empty_like(x), torch.empty_like(w)))


class SpatialGateBwdFn(torch.autograd.Function):
    """(x, w, g) -> (dx, dw).  Forward: the backward kernel, dw included
    (plain on the CPU).  Backward: autograd of
    :func:`spatial_gate_bwd_plain` (``slam.py:_gate_bwd_bwd``)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, w, g):
        ctx.save_for_backward(x, w, g)
        return _gate_bwd(x, w, g)

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
