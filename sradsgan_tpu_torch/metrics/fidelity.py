"""Image-fidelity metrics by the reference's evaluation protocol.

Counterpart of ``sradsgan_tpu/metrics/fidelity.py``.  The reference scores
SR outputs with old-skimage ``compare_mse`` / ``compare_psnr`` /
``compare_ssim(multichannel=True)`` on uint8 arrays from a ``ToPILImage()``
round trip (truncation), and a local ERGAS variant.  Two tiers:

* numpy tier (``compare_*``): protocol-exact, float64, uint8 HWC inputs,
  for evaluation that must match published tables;
* torch tier (``batched_*``): per-image values over an NCHW float batch on
  any device, for the validation sweep during training; the same formulas
  after an emulated uint8 truncation, so the numbers line up with the
  numpy tier.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def tensor_to_uint8(x) -> np.ndarray:
    """Float image in [0, 1] -> uint8 by truncation (torchvision's
    ``ToPILImage``: ``pic.mul(255).byte()``), clipped to [0, 1] first.
    Takes an HWC or CHW array or tensor; returns HWC uint8."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    x = np.asarray(x)
    if x.ndim == 3 and x.shape[0] in (1, 3) and x.shape[-1] not in (1, 3):
        x = np.transpose(x, (1, 2, 0))  # CHW -> HWC
    x = np.clip(x.astype(np.float32), 0.0, 1.0)
    return (x * 255.0).astype(np.uint8)


# ---------------------------------------------------------------------------
# numpy tier: protocol-exact
# ---------------------------------------------------------------------------

def compare_mse(im1: np.ndarray, im2: np.ndarray) -> float:
    """Mean squared error in float64 (skimage ``compare_mse``)."""
    im1 = np.asarray(im1, dtype=np.float64)
    im2 = np.asarray(im2, dtype=np.float64)
    return float(np.mean((im1 - im2) ** 2))


def compare_psnr(im_true: np.ndarray, im_test: np.ndarray,
                 data_range: float | None = None) -> float:
    """PSNR in dB (skimage ``compare_psnr``); ``data_range`` defaults to
    255 for uint8 inputs and 1.0 for floats."""
    if data_range is None:
        data_range = 255.0 if np.asarray(im_true).dtype == np.uint8 else 1.0
    err = compare_mse(im_true, im_test)
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / err))


def _ssim_single_channel(x: np.ndarray, y: np.ndarray, data_range: float,
                         win_size: int = 7, k1: float = 0.01,
                         k2: float = 0.03) -> float:
    """Single-channel SSIM with skimage's defaults: uniform window, sample
    covariance NP / (NP - 1), a (win - 1) // 2 border crop."""
    from scipy.ndimage import uniform_filter

    x = x.astype(np.float64)
    y = y.astype(np.float64)
    npix = win_size ** 2
    cov_norm = npix / (npix - 1.0)

    def filt(a):
        return uniform_filter(a, size=win_size)

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1, a2 = 2.0 * ux * uy + c1, 2.0 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win_size - 1) // 2
    return float(s[pad:s.shape[0] - pad, pad:s.shape[1] - pad].mean())


def compare_ssim(im1: np.ndarray, im2: np.ndarray,
                 data_range: float | None = None,
                 multichannel: bool = True, win_size: int = 7) -> float:
    """Mean structural similarity (skimage ``compare_ssim``)."""
    im1 = np.asarray(im1)
    im2 = np.asarray(im2)
    if data_range is None:
        data_range = 255.0 if im1.dtype == np.uint8 else 1.0
    if multichannel and im1.ndim == 3:
        vals = [_ssim_single_channel(im1[..., c], im2[..., c], data_range,
                                     win_size=win_size)
                for c in range(im1.shape[-1])]
        return float(np.mean(vals))
    return _ssim_single_channel(im1, im2, data_range, win_size=win_size)


def compare_ergas(img_true: np.ndarray, img_test: np.ndarray,
                  scale: int = 4) -> float:
    """ERGAS, the reference's variant 2:
    ``100 * sqrt(mse / mean(img_true)^2 / channels) / scale``, the MSE over
    all channels jointly and the mean over the ground truth."""
    img_true = np.asarray(img_true, dtype=np.float64)
    img_test = np.asarray(img_test, dtype=np.float64)
    channels = img_true.shape[2]
    mse = np.mean((img_true - img_test) ** 2)
    mean2 = np.mean(img_true) ** 2
    return float(100.0 * np.sqrt(mse / mean2 / channels) / scale)


# ---------------------------------------------------------------------------
# torch tier: batched, NCHW, on the tensors' device
# ---------------------------------------------------------------------------

def _quantize01(x: torch.Tensor) -> torch.Tensor:
    """Emulate the uint8 round trip: clip, scale, truncate."""
    return torch.floor(x.float().clamp(0.0, 1.0) * 255.0)


def batched_psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR over an NCHW batch, after the emulated uint8
    truncation."""
    p, t = _quantize01(pred), _quantize01(target)
    mse = ((p - t) ** 2).mean((1, 2, 3))
    return 10.0 * torch.log10((255.0 ** 2) / mse.clamp_min(1e-12))


def batched_ergas(pred: torch.Tensor, target: torch.Tensor,
                  scale: int = 4) -> torch.Tensor:
    """Per-image ERGAS variant 2 over an NCHW batch (uint8-emulated)."""
    p, t = _quantize01(pred), _quantize01(target)
    c = t.shape[1]
    mse = ((p - t) ** 2).mean((1, 2, 3))
    mean2 = t.mean((1, 2, 3)) ** 2
    return 100.0 * torch.sqrt(mse / mean2.clamp_min(1e-12) / c) / scale


def batched_ssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image SSIM over an NCHW batch by the reference's protocol:
    uniform 7x7 window without padding (the filter-then-crop of the numpy
    tier sees the same pixels), sample covariance, data range 255 after the
    emulated uint8 truncation, averaged over channels.

    Float32-safe: the moment filters run on globally mean-centred data in
    [0, 1] (variances are shift-invariant; the luminance term adds the
    mean back), which removes the ``E[x^2] - E[x]^2`` cancellation of raw
    0..255 values."""
    win = 7
    x = _quantize01(pred) / 255.0
    y = _quantize01(target) / 255.0
    npix = win * win
    cov_norm = npix / (npix - 1.0)

    m = 0.5 * (x.mean((1, 2, 3), keepdim=True)
               + y.mean((1, 2, 3), keepdim=True))
    xc, yc = x - m, y - m

    def filt(a):
        return F.avg_pool2d(a, win, stride=1)

    uxc, uyc = filt(xc), filt(yc)
    uxx, uyy, uxy = filt(xc * xc), filt(yc * yc), filt(xc * yc)
    vx = cov_norm * (uxx - uxc * uxc)
    vy = cov_norm * (uyy - uyc * uyc)
    vxy = cov_norm * (uxy - uxc * uyc)
    ux, uy = uxc + m, uyc + m

    c1 = 0.01 ** 2  # data range folded out: SSIM(sx, sy, sL) = SSIM(x, y, L)
    c2 = 0.03 ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s.mean((1, 2, 3))
