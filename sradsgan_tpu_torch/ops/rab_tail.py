"""The fused RAB tail: CLAM + SLAM + 1x1 fuse conv + residual in one op.

    u   = t * sigmoid(mlp(avg_hw t) + mlp(max_hw t))      mlp = relu(. W1) W2
    w   = u * sigmoid(conv7x7([mean_c u; max_c u]))        zero padding
    out = w . W_fuse + b_fuse + x_res

Counterpart of ``sradsgan_tpu/ops/pallas/rab_tail.py``, on NCHW.  On a CUDA
tensor the forward launches the hand-written kernel in ``csrc/rab_tail.cu``
(:func:`rab_tail_cuda`); on a CPU tensor it runs :func:`rab_tail_plain`, the
same math in plain PyTorch ops.  Both return the output and the six float32
byproducts the backward consumes: ``gate_c``, ``avg_t``, ``max_t`` (B, C)
and ``gate_s``, ``mean_u``, ``max_u`` (B, H, W).  All gate math runs in
float32 whatever t's dtype; bias and residual are added in float32 and the
result is cast once, as the TPU kernel does.

The backward is hand-written on the saved byproducts, as the JAX package's
is jnp outside its kernel (``_bwd_jnp``): plain PyTorch, except that on a
CUDA tensor its SLAM part, which is exactly the spatial gate's backward of
(u, slam_w, d(u * gate_s)), launches that op's backward kernel
(``csrc/spatial_gate_bwd.cu``, through the registered op
``torch.ops.sradsgan_tpu_torch.spatial_gate_bwd``), which gives du and
dslam_w.  The forward's dispatch is the registered op ``::rab_tail``.
First order only, as in JAX: generators use it, the discriminator (whose
gradient penalty needs a second order) never does, and a second order
raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from sradsgan_tpu_torch.ops import _build, define, plain_dtype
from sradsgan_tpu_torch.ops.spatial_gate import (KERNEL_SIZE, PAD, _gate_bwd,
                                                 dw_contraction,
                                                 strip_planes)

MAX_CHANNELS = 256   # csrc/rab_tail.cu: W_fuse's slab in shared memory


def _mlp(v: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    return F.relu(v @ w1) @ w2


def rab_tail_plain(t: torch.Tensor, x_res: torch.Tensor, w1: torch.Tensor,
                   w2: torch.Tensor, slam_w: torch.Tensor,
                   fuse_w: torch.Tensor, fuse_b: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """(out, gate_c, gate_s, mean_u, max_u, avg_t, max_t).

    t, x_res: (B, C, H, W); w1: (C, hidden); w2: (hidden, C); slam_w:
    (1, 2, 7, 7) OIHW, plane 0 = mean, 1 = max; fuse_w: (C_in, C_out);
    fuse_b: (C,).
    """
    dt = plain_dtype(t)
    with torch.autocast(t.device.type, enabled=False):
        t32 = t.to(dt)
        w1, w2, slam_w, fuse_w, fuse_b = (
            p.to(dt) for p in (w1, w2, slam_w, fuse_w, fuse_b))
        avg_t = t32.mean((2, 3))
        max_t = t32.amax((2, 3))
        gate_c = torch.sigmoid(_mlp(avg_t, w1, w2) + _mlp(max_t, w1, w2))
        u = t32 * gate_c[:, :, None, None]
        mean_u = u.mean(1)
        max_u = u.amax(1)
        gate_s = torch.sigmoid(F.conv2d(torch.stack([mean_u, max_u], dim=1),
                                        slam_w, padding=PAD))[:, 0]
        y = F.conv2d(u * gate_s[:, None], fuse_w.t()[:, :, None, None],
                     fuse_b)
        out = (y + x_res.to(dt)).to(t.dtype)
    return out, gate_c, gate_s, mean_u, max_u, avg_t, max_t


def rab_tail_plain_strips(t: torch.Tensor, x_res: torch.Tensor,
                          w1: torch.Tensor, w2: torch.Tensor,
                          slam_w: torch.Tensor, fuse_w: torch.Tensor,
                          fuse_b: torch.Tensor, rows: int
                          ) -> Tuple[torch.Tensor, ...]:
    """The seven outputs of :func:`rab_tail_plain`, computed the way the
    kernel in ``csrc/rab_tail.cu`` cuts the work: by strips of ``rows``
    whole rows, the pools combined from per-strip sums and maxima in strip
    order, the statistics of u on a 3-row halo with zeros outside the
    image.  A second reference for the kernel's halo arithmetic; nothing
    on the main path calls it."""
    dt = plain_dtype(t)
    with torch.autocast(t.device.type, enabled=False):
        t32 = t.to(dt)
        w1, w2, slam_w, fuse_w, fuse_b = (
            p.to(dt) for p in (w1, w2, slam_w, fuse_w, fuse_b))
        b, c, h, w = t32.shape
        starts = range(0, h, rows)
        total = t32.new_zeros((b, c))
        max_t = t32.new_full((b, c), float("-inf"))
        for r0 in starts:
            strip = t32[:, :, r0:r0 + rows]
            total = total + strip.sum((2, 3))
            max_t = torch.maximum(max_t, strip.amax((2, 3)))
        avg_t = total / (h * w)
        gate_c = torch.sigmoid(_mlp(avg_t, w1, w2) + _mlp(max_t, w1, w2))
        out = torch.empty_like(t32)
        gate_s, mean_u, max_u = (t32.new_empty((b, h, w)) for _ in range(3))
        for r0 in starts:
            r1 = min(h, r0 + rows)
            e0, e1 = max(0, r0 - PAD), min(h, r1 + PAD)
            u = t32[:, :, e0:e1] * gate_c[:, :, None, None]
            stats = torch.stack([u.mean(1), u.amax(1)], dim=1)
            mean_u[:, r0:r1] = stats[:, 0, r0 - e0:r1 - e0]
            max_u[:, r0:r1] = stats[:, 1, r0 - e0:r1 - e0]
            gate = torch.sigmoid(F.conv2d(
                strip_planes(stats, e0, r0 - PAD, r1 + PAD), slam_w,
                padding=(0, PAD)))
            gate_s[:, r0:r1] = gate[:, 0]
            y = F.conv2d(u[:, :, r0 - e0:r1 - e0] * gate,
                         fuse_w.t()[:, :, None, None], fuse_b)
            out[:, :, r0:r1] = y + x_res[:, :, r0:r1].to(dt)
    return out.to(t.dtype), gate_c, gate_s, mean_u, max_u, avg_t, max_t


def _check_param(name: str, p: torch.Tensor, shape: tuple,
                 t: torch.Tensor) -> None:
    if (tuple(p.shape) != shape or p.dtype != torch.float32
            or p.device != t.device or not p.is_contiguous()):
        raise ValueError(
            f"rab_tail: {name} must be a contiguous float32 {shape} tensor "
            f"on {t.device}, got {p.dtype} {tuple(p.shape)} on {p.device}")


def rab_tail_cuda(t: torch.Tensor, x_res: torch.Tensor, w1: torch.Tensor,
                  w2: torch.Tensor, slam_w: torch.Tensor,
                  fuse_w: torch.Tensor, fuse_b: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """The kernel: the seven outputs of :func:`rab_tail_plain`; t and x_res
    float32 or bfloat16, the parameters float32."""
    _build.check_input("rab_tail", t, 4)
    _build.check_like("rab_tail", x_res, t, "x_res")
    b, c, h, w = t.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"rab_tail: the kernel takes at most {MAX_CHANNELS} "
                         f"channels, got {tuple(t.shape)}")
    hidden = w1.shape[1] if w1.dim() == 2 else 0
    if not 1 <= hidden <= c:
        raise ValueError(f"rab_tail: w1 must be (C, hidden) with 1 <= hidden "
                         f"<= C, got {tuple(w1.shape)}")
    for name, p, shape in (("w1", w1, (c, hidden)), ("w2", w2, (hidden, c)),
                           ("slam_w", slam_w,
                            (1, 2, KERNEL_SIZE, KERNEL_SIZE)),
                           ("fuse_w", fuse_w, (c, c)),
                           ("fuse_b", fuse_b, (c,))):
        _check_param(name, p, shape, t)
    plan = _build.plan("sg_rab_tail", t.device, (b, c, hidden, h, w),
                       t.dtype)
    out = torch.empty_like(t)
    # seven tensors of their own: the outputs of a registered op may not
    # share storage
    gate_c, avg_t, max_t = (torch.empty((b, c), device=t.device,
                                        dtype=torch.float32)
                            for _ in range(3))
    gate_s, mean_u, max_u = (torch.empty((b, h, w), device=t.device,
                                         dtype=torch.float32)
                             for _ in range(3))
    _build.launch("sg_rab_tail", t.device, t.data_ptr(), x_res.data_ptr(),
                  w1.data_ptr(), w2.data_ptr(), slam_w.data_ptr(),
                  fuse_w.data_ptr(), fuse_b.data_ptr(), out.data_ptr(),
                  gate_c.data_ptr(), gate_s.data_ptr(), mean_u.data_ptr(),
                  max_u.data_ptr(), avg_t.data_ptr(), max_t.data_ptr(), b, c,
                  hidden, h, w, _build.DTYPE_CODES[t.dtype],
                  *_build.plan_args(plan))
    rab_tail_cuda.launches += 1
    return out, gate_c, gate_s, mean_u, max_u, avg_t, max_t


rab_tail_cuda.launches = 0


def _forward_cuda(*args):
    # the wrapper by its module attribute, looked up at each call
    return rab_tail_cuda(*args)


def _forward_fake(t, x_res, w1, w2, slam_w, fuse_w, fuse_b):
    b, c, h, w = t.shape
    dt = plain_dtype(t)
    gate_c, avg_t, max_t = (t.new_empty((b, c), dtype=dt) for _ in range(3))
    gate_s, mean_u, max_u = (t.new_empty((b, h, w), dtype=dt)
                             for _ in range(3))
    return torch.empty_like(t), gate_c, gate_s, mean_u, max_u, avg_t, max_t


_forward = define(
    "rab_tail(Tensor t, Tensor x_res, Tensor w1, Tensor w2, Tensor slam_w, "
    "Tensor fuse_w, Tensor fuse_b) -> (Tensor, Tensor, Tensor, Tensor, "
    "Tensor, Tensor, Tensor)", rab_tail_plain, _forward_cuda, _forward_fake)


def rab_tail_bwd(t: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                 slam_w: torch.Tensor, fuse_w: torch.Tensor,
                 byproducts: Tuple[torch.Tensor, ...], g: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """(dt, dx_res, dw1, dw2, dslam_w, dfuse_w, dfuse_b) for the output
    cotangent g, from the forward's byproducts (``rab_tail.py:_bwd_jnp``).
    Tied maxima share their cotangent evenly; the tie counts are recomputed
    from u and t with a floor of one."""
    gate_c, gate_s, mean_u, max_u, avg_t, max_t = byproducts
    dt_ = plain_dtype(t)
    b, c, h, w = t.shape
    hw = h * w
    with torch.autocast(t.device.type, enabled=False):
        t32, g32 = t.to(dt_), g.to(dt_)
        w1f, w2f, fwf = w1.to(dt_), w2.to(dt_), fuse_w.to(dt_)
        u = t32 * gate_c[:, :, None, None]

        # fuse conv backward
        dfuse_w = torch.einsum("bihw,bohw->io", u * gate_s[:, None], g32)
        dfuse_b = g32.sum((0, 2, 3))
        dwgated = F.conv2d(g32, fwf[:, :, None, None])      # d(u * gate_s)

        # SLAM backward: the spatial gate's backward of (u, slam_w, dwgated)
        if t.device.type == "cuda":
            du, dslam_w = _gate_bwd(u, slam_w, dwgated)
        else:
            ds = (dwgated * u).sum(1) * gate_s * (1.0 - gate_s)
            dplanes = F.conv_transpose2d(ds[:, None], slam_w.to(dt_),
                                         padding=PAD)
            is_max_u = (u == max_u[:, None]).to(dt_)
            ties_u = is_max_u.sum(1).clamp_min(1.0)
            du = (dwgated * gate_s[:, None] + dplanes[:, :1] / c
                  + (dplanes[:, 1] / ties_u)[:, None] * is_max_u)
            dslam_w = dw_contraction(
                ds, torch.stack([mean_u, max_u], dim=1), slam_w)

        # CLAM backward; z = mlp(avg) + mlp(max), one shared MLP
        dgate_c = (du * t32).sum((2, 3))                    # (B, C)
        dz = dgate_c * gate_c * (1.0 - gate_c)
        h_avg = F.relu(avg_t @ w1f)                         # (B, hidden)
        h_max = F.relu(max_t @ w1f)
        dw2 = h_avg.t() @ dz + h_max.t() @ dz
        dh_avg = (dz @ w2f.t()) * (h_avg > 0)
        dh_max = (dz @ w2f.t()) * (h_max > 0)
        dw1 = avg_t.t() @ dh_avg + max_t.t() @ dh_max
        davg = dh_avg @ w1f.t()                             # (B, C)
        dmaxt = dh_max @ w1f.t()
        is_max_t = (t32 == max_t[:, :, None, None]).to(dt_)
        ties_t = is_max_t.sum((2, 3)).clamp_min(1.0)
        dt = (du * gate_c[:, :, None, None] + (davg / hw)[:, :, None, None]
              + (dmaxt / ties_t)[:, :, None, None] * is_max_t)
    return (dt.to(t.dtype), g, dw1.to(w1.dtype), dw2.to(w2.dtype),
            dslam_w.to(slam_w.dtype), dfuse_w.to(fuse_w.dtype),
            dfuse_b.to(fuse_w.dtype))


class FusedRabTailFn(torch.autograd.Function):
    """Forward: the kernel on CUDA, the plain version on the CPU; saves t,
    the parameters and the six byproducts (x_res only passes its cotangent
    through).  Backward: :func:`rab_tail_bwd`, once."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, t, x_res, w1, w2, slam_w, fuse_w, fuse_b):
        out, *byproducts = _forward(t, x_res, w1, w2, slam_w, fuse_w, fuse_b)
        ctx.save_for_backward(t, w1, w2, slam_w, fuse_w, *byproducts)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    @once_differentiable
    def backward(ctx, g):
        t, w1, w2, slam_w, fuse_w, *byproducts = ctx.saved_tensors
        return rab_tail_bwd(t, w1, w2, slam_w, fuse_w, tuple(byproducts),
                            g.contiguous())


def fused_rab_tail(t: torch.Tensor, x_res: torch.Tensor, w1: torch.Tensor,
                   w2: torch.Tensor, slam_w: torch.Tensor,
                   fuse_w: torch.Tensor, fuse_b: torch.Tensor
                   ) -> torch.Tensor:
    """out = (CLAM -> SLAM -> 1x1 fuse)(t) + x_res; differentiable once.
    Shapes as :func:`rab_tail_plain`."""
    args = (t, x_res, w1, w2, slam_w, fuse_w, fuse_b)
    if _build.needs_grad(*args):
        return FusedRabTailFn.apply(*args)
    return _forward(*args)[0]
