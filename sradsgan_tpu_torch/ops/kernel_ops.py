"""KernelGAN-style post-processing of an estimated blur kernel, in float64
numpy on the host.

Counterpart of ``sradsgan_tpu/ops/kernel_ops.py``: centralize an estimated
degradation kernel on its center of mass, zero its negligible taps,
normalize it to unit sum and shave or pad it to a target size, as blind-SR
training with estimated kernels does.  scipy is imported inside the one
call that needs it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def zeroize_negligible(kernel: np.ndarray, n_keep: int = 40) -> np.ndarray:
    """Keep the ``n_keep`` largest taps (and any tied with the smallest of
    them), zero the rest and renormalize to unit sum."""
    k = np.asarray(kernel, np.float64).copy()
    flat = np.sort(k.ravel())[::-1]
    cutoff = flat[min(n_keep, flat.size - 1)]
    k[k < cutoff] = 0.0
    s = k.sum()
    return (k / s) if s > 0 else k


def centralize_kernel(kernel: np.ndarray) -> np.ndarray:
    """Shift the kernel (linear interpolation, zeros outside) so that its
    center of mass is the geometric center."""
    from scipy import ndimage

    k = np.asarray(kernel, np.float64)
    cy, cx = ndimage.center_of_mass(k)
    center = (k.shape[0] - 1) / 2.0
    return ndimage.shift(k, (center - cy, center - cx), order=1,
                         mode="constant")


def post_process_kernel(kernel: np.ndarray, n_keep: int = 40,
                        target_size: Optional[int] = None) -> np.ndarray:
    """Centralize, zero the negligible taps, crop or zero-pad to
    ``target_size`` about the center, and normalize to unit sum."""
    k = centralize_kernel(kernel)
    k = zeroize_negligible(k, n_keep)
    if target_size is not None and target_size != k.shape[0]:
        size = k.shape[0]
        if target_size < size:
            off = (size - target_size) // 2
            k = k[off:off + target_size, off:off + target_size]
        else:
            pad = (target_size - size) // 2
            k = np.pad(k, ((pad, target_size - size - pad),) * 2)
    s = k.sum()
    return k / s if s > 0 else k
