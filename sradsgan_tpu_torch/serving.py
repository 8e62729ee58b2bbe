"""Production inference: a shape-bucketed predictor on one device.

Counterpart of ``sradsgan_tpu/serving.py:Predictor``, with the same contract:
numpy NHWC float [0, 1] in and out, inputs that fit a bucket reflect-padded
up to it (so only a fixed set of shapes ever reaches the device) and cropped
back, larger inputs sent through halo-tiled inference.  The model runs under
``torch.inference_mode()``, in float32 or, with ``dtype=torch.bfloat16``, in
bf16 with the gate math and softmax statistics kept in float32 as in the
JAX package.
"""

from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch
from torch import nn

from sradsgan_tpu_torch.evaluation.tiled import (forward_numpy,
                                                 tiled_super_resolve)
from sradsgan_tpu_torch.nn.attention import SpatialGate

DTYPES = (torch.float32, torch.bfloat16)


def _compute_copy(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``model`` in ``dtype``, except the SLAM 7x7 kernels, which
    the gate reads in float32, and the BatchNorms (SRGAN, SRAGAN), which
    normalize in float32 (the JAX params and statistics stay float32
    too)."""
    model = copy.deepcopy(model).to(dtype)
    for m in model.modules():
        if isinstance(m, (SpatialGate, nn.BatchNorm2d)):
            m.float()
    return model


class Predictor:
    """Batched SR inference with a fixed input-shape bucket set.

    ``model`` is moved to ``device`` (in place); a bf16 predictor runs a
    bf16 copy of it.  It serves the model as it was built: a generator
    made with ``create_generator(..., rab_tail="fused")`` runs its fused
    RAB tails.
    """

    def __init__(self, model: nn.Module, scale: int,
                 buckets: Sequence[int] = (54, 72, 108, 216),
                 tile: int = 54, halo: int = 8, *,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Predictor(device={str(device)!r}) needs a CUDA device and "
                "this torch sees none; pass device='cpu' to serve on the CPU")
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype}")
        self.dtype = dtype
        model = model.to(self.device)
        if dtype != torch.float32:
            model = _compute_copy(model, dtype)
        self.model = model.eval()
        self.scale = scale
        self.buckets = sorted(buckets)
        self.tile = tile
        self.halo = halo

    def __call__(self, lr01: np.ndarray) -> np.ndarray:
        """(B, H, W, C) or (H, W, C) float [0, 1] -> SR, any input size.

        Inputs that fit a bucket are padded up to it (reflect) and cropped
        back; larger inputs go through halo-tiled inference.
        """
        squeeze = lr01.ndim == 3
        if squeeze:
            lr01 = lr01[None]
        b, h, w, _ = lr01.shape
        bucket = next((s for s in self.buckets if s >= max(h, w)), None)
        if bucket is None:
            out = np.stack([
                tiled_super_resolve(self.model, lr01[i], self.scale,
                                    self.tile, self.halo,
                                    device=self.device, dtype=self.dtype)
                for i in range(b)])
        else:
            padded = np.pad(lr01, ((0, 0), (0, bucket - h), (0, bucket - w),
                                   (0, 0)), mode="reflect")
            out = forward_numpy(self.model, padded, self.device, self.dtype)
            out = out[:, :h * self.scale, :w * self.scale]
        return out[0] if squeeze else out
