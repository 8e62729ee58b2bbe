"""Bicubic and bilinear resize with PIL's coefficients, as dense matmuls.

Counterpart of ``sradsgan_tpu/ops/resize.py``.  The reference's metric
protocol hangs off PIL's antialiased resize: LR inputs are PIL downsamples
of the HR crop and the "bicubic" twin is the LR re-upsampled.  PIL's
resample is separable and its weights depend only on (in_size, out_size),
so a resize is two matrix products,

    out[b, oh, ow, c] = Wh[oh, ih] * img[b, ih, iw, c] * Ww[ow, iw],

with the weight matrices built in float64 numpy and cached per (in, out,
method).  :func:`bicubic_resize` is that in float; :func:`resize_uint8`
adds what PIL's 8-bit path does around each pass (round half up, clip to
[0, 255]), which the port's synthetic dataset uses where the JAX package
calls PIL itself.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """PIL's bicubic kernel (Catmull-Rom family, a = -0.5)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    outer = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax < 1.0, inner, np.where(ax < 2.0, outer, 0.0))


def _linear(x: np.ndarray) -> np.ndarray:
    """PIL's bilinear (triangle) kernel, support 1."""
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0)


_FILTERS = {"bicubic": (_cubic, 2.0), "bilinear": (_linear, 1.0)}


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int,
                  method: str = "bicubic") -> np.ndarray:
    """Dense (out_size, in_size) PIL resampling matrix, float32 (shared by
    every caller: do not write to it).

    As PIL's ``precompute_coeffs``: output pixel centers at
    (i + 0.5) * in/out, the support widened by the scale factor when
    downsampling, each row normalized to sum to one."""
    kernel, base_support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax, dtype=np.float64)
        weights = kernel((xs - center + 0.5) / filterscale)
        total = weights.sum()
        if total != 0.0:
            weights = weights / total
        w[i, xmin:xmax] = weights
    out = w.astype(np.float32)
    out.setflags(write=False)
    return out


def _matrix(in_size: int, out_size: int, method: str,
            like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(resize_matrix(in_size, out_size,
                                                   method))).to(like)


def _unbatched(fn):
    """Let an NHWC function take an HWC image as well."""
    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        if x.dim() == 3:
            return fn(x[None], *args, **kwargs)[0]
        return fn(x, *args, **kwargs)
    return wrapper


@_unbatched
def bicubic_resize(x: torch.Tensor, out_h: int, out_w: int,
                   method: str = "bicubic") -> torch.Tensor:
    """Resize an NHWC (or HWC) float batch with PIL's resize semantics;
    the horizontal pass first, as PIL."""
    ww = _matrix(x.shape[2], out_w, method, x)
    wh = _matrix(x.shape[1], out_h, method, x)
    x = torch.einsum("ow,bhwc->bhoc", ww, x)
    return torch.einsum("oh,bhwc->bowc", wh, x)


def _to_uint8_values(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x + 0.5).clamp_(0.0, 255.0)


@_unbatched
def resize_uint8(x: torch.Tensor, out_h: int, out_w: int,
                 method: str = "bicubic") -> torch.Tensor:
    """PIL's 8-bit resize of an NHWC (or HWC) float batch holding integer
    values in [0, 255]: after each pass the values are rounded half up and
    clipped, as PIL stores a uint8 image between its two passes."""
    ww = _matrix(x.shape[2], out_w, method, x)
    wh = _matrix(x.shape[1], out_h, method, x)
    x = _to_uint8_values(torch.einsum("ow,bhwc->bhoc", ww, x))
    return _to_uint8_values(torch.einsum("oh,bhwc->bowc", wh, x))


def degrade_pair(hr: torch.Tensor, scale: int, lr_method: str = "bicubic"):
    """HR batch -> (LR, bicubic-upsampled LR), the reference's data triplet
    in float: LR clipped to [0, 1] before the re-upsample, as the uint8
    intermediate would be."""
    h, w = hr.shape[-3], hr.shape[-2]
    lr = bicubic_resize(hr, h // scale, w // scale, lr_method).clamp(0.0, 1.0)
    return lr, bicubic_resize(lr, h, w, "bicubic")
