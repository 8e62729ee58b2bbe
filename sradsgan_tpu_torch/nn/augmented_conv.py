"""Attention-augmented convolution (AA-conv), NCHW.

Counterpart of ``sradsgan_tpu/nn/augmented_conv.py``: a conv whose output
channels are ``out_channels - dv`` of a plain conv (``conv_out``) and ``dv``
of multi-head 2D self-attention over all positions (``qkv_conv`` gives q,
k and v; ``attn_out`` a 1x1 conv over the heads), optionally with
relative position logits (``key_rel_w``, ``key_rel_h``, turned absolute by
:func:`rel_to_abs`).  Both convs pad symmetrically by (k - 1) // 2 at the
given stride.  The attention is matmuls in float32 logits outside any
kernel, as JAX computes it with einsums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.blocks import materialize


def rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """(B, L, 2L - 1) relative logits -> (B, L, L) absolute: JAX's pad and
    reshape sequence (``augmented_conv.py:_rel_to_abs``)."""
    b, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, l + 1, 2 * l - 1)
    return x[:, :l, l - 1:]


class AugmentedConv(nn.Module):
    """(B, in_channels, H, W) -> (B, out_channels, H', W'), H' = H at
    stride 1.  With ``relative``, ``shape`` is (H', W'): the tables
    ``key_rel_w`` (2W' - 1, dk / heads) and ``key_rel_h`` (2H' - 1,
    dk / heads) are sized for it, as JAX sizes them at its first call."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dk: int = 40, dv: int = 4,
                 num_heads: int = 4, relative: bool = False,
                 stride: int = 1, shape: Optional[Tuple[int, int]] = None,
                 *, seed: int = 0, device: torch.device | str = "cpu"):
        super().__init__()
        if relative and shape is None:
            raise ValueError("relative logits need the attention map's "
                             "shape (H', W')")
        self.dk, self.dv, self.num_heads = dk, dv, num_heads
        self.relative = relative
        pad = (kernel_size - 1) // 2
        dkh = dk // num_heads
        with torch.device("meta"):  # skip torch's default init
            self.conv_out = nn.Conv2d(in_channels, out_channels - dv,
                                      kernel_size, stride, pad)
            self.qkv_conv = nn.Conv2d(in_channels, 2 * dk + dv, kernel_size,
                                      stride, pad)
            self.attn_out = nn.Conv2d(dv, dv, 1)
            if relative:
                h, w = shape
                self.key_rel_w = nn.Parameter(torch.empty(2 * w - 1, dkh))
                self.key_rel_h = nn.Parameter(torch.empty(2 * h - 1, dkh))
        materialize(self, seed)
        self.to(device)

    def _relative_logits(self, q: torch.Tensor) -> torch.Tensor:
        """(B, Nh, H, W, d) queries -> (B, Nh, HW, HW) float32 logits: the
        width-relative ones, constant over the key's row, plus the
        height-relative ones, constant over its column."""
        b, nh, h, w, d = q.shape
        q = q.float()
        rw = torch.einsum("bnhwd,md->bnhwm", q, self.key_rel_w.float())
        rw = rel_to_abs(rw.reshape(b * nh * h, w, 2 * w - 1))
        rw = rw.reshape(b, nh, h, 1, w, w).expand(b, nh, h, h, w, w)
        rw = rw.permute(0, 1, 2, 4, 3, 5).reshape(b, nh, h * w, h * w)
        rh = torch.einsum("bnwhd,md->bnwhm", q.transpose(2, 3),
                          self.key_rel_h.float())
        rh = rel_to_abs(rh.reshape(b * nh * w, h, 2 * h - 1))
        rh = rh.reshape(b, nh, w, 1, h, h).expand(b, nh, w, w, h, h)
        rh = rh.permute(0, 1, 4, 2, 5, 3).reshape(b, nh, h * w, h * w)
        return rw + rh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nh, dk, dv = self.num_heads, self.dk, self.dv
        dkh, dvh = dk // nh, dv // nh
        conv_out = self.conv_out(x)
        qkv = self.qkv_conv(x)
        b, _, h, w = qkv.shape
        q, k, v = torch.split(qkv, [dk, dk, dv], dim=1)

        def heads(t, d):  # (B, Nh * d, H, W) -> (B, Nh, HW, d)
            return t.reshape(b, nh, d, h * w).transpose(2, 3)

        q = heads(q, dkh) * dkh ** -0.5
        k, v = heads(k, dkh), heads(v, dvh)
        with torch.autocast(x.device.type, enabled=False):
            logits = torch.matmul(q.float(), k.float().transpose(2, 3))
            if self.relative:
                logits = logits + self._relative_logits(
                    q.reshape(b, nh, h, w, dkh))
            weights = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(weights, v)                       # (B, Nh, HW, dvh)
        attn = attn.transpose(2, 3).reshape(b, dv, h, w)
        return torch.cat([conv_out, self.attn_out(attn)], dim=1)
