"""SGAM position attention: ``softmax(q k^T) v`` with no 1/sqrt(d) scale.

Counterpart of ``sradsgan_tpu/ops/sgam_flash.py``.  On CUDA tensors
:func:`position_attention` launches the hand-written flash kernel in
``csrc/sgam_flash.cu``, which keeps float32 running softmax statistics and
never writes the (N, N) energy, and its backward the kernels in
``csrc/sgam_flash_bwd.cu``, which recompute the probabilities from the row
log-sum-exp the forward saved.  Both run their products on the tensor cores:
bfloat16 inputs directly, float32 inputs as error-compensated TF32 products
that keep float32 accuracy (``csrc/sgam_mma.cuh``).  On CPU tensors it runs
:func:`position_attention_plain`, the exact float32 softmax of the JAX
package's f32 path (``sradsgan_tpu/nn/attention.py``), and its gradient
written out.  The dispatch is the registered ops
``torch.ops.sradsgan_tpu_torch.position_attention`` (the output and, with
``with_lse``, the row log-sum-exp, else an empty tensor in its place) and
``::position_attention_bwd``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from sradsgan_tpu_torch.ops import _build, define, plain_dtype

# (d_qk, d_v) pairs the kernels are instantiated for: SGAM at C = 16, 32, 64.
KERNEL_WIDTHS = ((2, 16), (4, 32), (8, 64))


def position_attention_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """q, k: (B, N, d_qk); v: (B, N, d_v) -> (B, N, d_v) in v.dtype."""
    dtype = plain_dtype(q)
    with torch.autocast(q.device.type, enabled=False):
        energy = torch.bmm(q.to(dtype), k.to(dtype).transpose(1, 2))
        out = torch.bmm(torch.softmax(energy, dim=-1), v.to(dtype))
    return out.to(v.dtype)


def position_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, dout: torch.Tensor
                                 ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) for output cotangent dout: the gradient of
    :func:`position_attention_plain` written out in the ops its autograd
    runs (the softmax's backward as P * (dP - rowsum(dP * P))), so that it
    needs no autograd of its own inside the registered op."""
    dtype = plain_dtype(q)
    with torch.autocast(q.device.type, enabled=False):
        q_, k_, v_, do_ = (t.to(dtype) for t in (q, k, v, dout))
        p = torch.softmax(torch.bmm(q_, k_.transpose(1, 2)), dim=-1)
        dp = torch.bmm(do_, v_.transpose(1, 2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        return (torch.bmm(ds, k_).to(q.dtype),
                torch.bmm(ds.transpose(1, 2), q_).to(k.dtype),
                torch.bmm(p.transpose(1, 2), do_).to(v.dtype))


def position_attention_plain_chunked(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor,
                                     chunk: int = 2048) -> torch.Tensor:
    """:func:`position_attention_plain` by blocks of ``chunk`` queries: a
    query's softmax needs its own row of energies only, so a long sequence
    never holds the (N, N) energy at once."""
    return torch.cat([position_attention_plain(q[:, i:i + chunk], k, v)
                      for i in range(0, q.shape[1], chunk)], dim=1)


def attention_delta_plain(out: torch.Tensor,
                          dout: torch.Tensor) -> torch.Tensor:
    """delta_i = dO_i . O_i in float32, (B, N): the term that turns dP into
    dS = P * (dP - delta) without the softmax's Jacobian.  The backward
    kernel's prologue computes the same."""
    return (dout.float() * out.float()).sum(-1)


def position_attention_bwd_from_delta(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, out: torch.Tensor,
                                      dout: torch.Tensor
                                      ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) by the formulas the backward kernels evaluate tile by
    tile, written out in plain PyTorch in the plain version's dtype."""
    dtype = plain_dtype(q)
    q_, k_, v_, do_ = (t.to(dtype) for t in (q, k, v, dout))
    p = torch.softmax(torch.bmm(q_, k_.transpose(1, 2)), dim=-1)
    delta = attention_delta_plain(out, dout).to(dtype)
    ds = p * (torch.bmm(do_, v_.transpose(1, 2)) - delta[..., None])
    return (torch.bmm(ds, k_).to(q.dtype),
            torch.bmm(ds.transpose(1, 2), q_).to(k.dtype),
            torch.bmm(p.transpose(1, 2), do_).to(v.dtype))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels copy rows in 16-byte pieces; a view that starts off that
    grid (fresh allocations never do) is copied onto it."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_qkv(op: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> None:
    for t in (q, k, v):
        _build.check_input(op, t, 3)
    b, n, d_qk = q.shape
    d_v = v.shape[-1]
    if (k.shape != q.shape or v.shape[:2] != (b, n)
            or len({q.dtype, k.dtype, v.dtype}) != 1
            or len({q.device, k.device, v.device}) != 1):
        raise ValueError(
            f"{op}: q, k (B, N, d_qk) and v (B, N, d_v) must share batch, "
            f"length, dtype and device; got {tuple(q.shape)} "
            f"{tuple(k.shape)} {tuple(v.shape)}")
    if (d_qk, d_v) not in KERNEL_WIDTHS:
        raise ValueError(f"{op}: no kernel for d_qk={d_qk}, d_v={d_v}; "
                         f"built for {KERNEL_WIDTHS}")


def position_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, with_lse: bool = False):
    """The kernel: streamed keys, float32 online softmax.  Returns the
    output, or with ``with_lse`` (output, (B, N) float32 row log-sum-exp)
    for the backward."""
    _check_qkv("position_attention", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, n, d_qk = q.shape
    out = torch.empty_like(v)
    lse: Optional[torch.Tensor] = None
    if with_lse:
        lse = torch.empty((b, n), device=q.device, dtype=torch.float32)
    _build.launch("sg_position_attention", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  0 if lse is None else lse.data_ptr(), b, n, d_qk,
                  v.shape[-1], _build.DTYPE_CODES[q.dtype])
    position_attention_cuda.launches += 1
    return (out, lse) if with_lse else out


position_attention_cuda.launches = 0


def position_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, out: torch.Tensor,
                                dout: torch.Tensor, lse: torch.Tensor
                                ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels: (dq, dk, dv).  delta_i = dO_i . O_i is formed
    in float32 by the launch's prologue kernel, into scratch given here."""
    op = "position_attention_bwd"
    _check_qkv(op, q, k, v)
    _build.check_like(op, out, v, "out")
    _build.check_like(op, dout, v, "dout")
    b, n, d_qk = q.shape
    if (lse.shape != (b, n) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"{op}: lse must be a contiguous float32 ({b}, {n}) "
                         f"tensor on {q.device}")
    q, k, v, out, dout = map(_aligned, (q, k, v, out, dout))
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.launch("sg_position_attention_bwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, n, d_qk, v.shape[-1],
                  _build.DTYPE_CODES[q.dtype])
    position_attention_bwd_cuda.launches += 1
    return dq, dk, dv


position_attention_bwd_cuda.launches = 0


def _no_lse(q: torch.Tensor) -> torch.Tensor:
    return q.new_empty((0,), dtype=torch.float32)


def _attention_plain(q, k, v, with_lse=False):
    out = position_attention_plain(q, k, v)
    if not with_lse:
        return out, _no_lse(q)
    with torch.autocast(q.device.type, enabled=False):
        energy = torch.bmm(q.float(), k.float().transpose(1, 2))
    return out, torch.logsumexp(energy, dim=-1)


# The wrappers by their module attributes, looked up at each call.
def _attention_cuda(q, k, v, with_lse=False):
    if with_lse:
        return position_attention_cuda(q, k, v, with_lse=True)
    return position_attention_cuda(q, k, v), _no_lse(q)


def _attention_bwd_cuda(q, k, v, out, dout, lse):
    return position_attention_bwd_cuda(q, k, v, out, dout, lse)


def _attention_fake(q, k, v, with_lse=False):
    lse = (q.new_empty(q.shape[:2], dtype=torch.float32) if with_lse
           else _no_lse(q))
    return torch.empty_like(v), lse


_attention = define(
    "position_attention(Tensor q, Tensor k, Tensor v, bool with_lse=False) "
    "-> (Tensor, Tensor)", _attention_plain, _attention_cuda,
    _attention_fake)
_attention_bwd = define(
    "position_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
    "Tensor dout, Tensor lse) -> (Tensor, Tensor, Tensor)",
    lambda q, k, v, out, dout, lse: position_attention_bwd_plain(q, k, v,
                                                                 dout),
    _attention_bwd_cuda,
    lambda q, k, v, out, dout, lse: (torch.empty_like(q), torch.empty_like(k),
                                     torch.empty_like(v)))


class PositionAttentionFn(torch.autograd.Function):
    """Forward: the flash kernel, saving q, k, v, the output and the row
    log-sum-exp (the plain version on the CPU).  Backward: the flash
    backward kernels, or :func:`position_attention_bwd_plain` on the CPU.
    First order only: nothing differentiates SGAM twice."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v):
        out, lse = _attention(q, k, v, True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return _attention_bwd(q, k, v, out, dout.contiguous(), lse)


def position_attention(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Unscaled softmax(q k^T) v over key positions; differentiable once."""
    if _build.needs_grad(q, k, v):
        return PositionAttentionFn.apply(q, k, v)
    return _attention(q, k, v)[0]
