"""Pixel reconstruction losses, counterpart of
``sradsgan_tpu/losses/pixel.py``: mean absolute or squared error in
float32 (float64 for float64 inputs)."""

from __future__ import annotations

import torch

from sradsgan_tpu_torch.ops import plain_dtype


def pixel_loss(pred: torch.Tensor, target: torch.Tensor,
               kind: str = "l1") -> torch.Tensor:
    diff = pred.to(plain_dtype(pred)) - target.to(plain_dtype(target))
    if kind == "l1":
        return diff.abs().mean()
    if kind == "l2":
        return (diff * diff).mean()
    raise ValueError(f"unknown pixel loss {kind!r}")
