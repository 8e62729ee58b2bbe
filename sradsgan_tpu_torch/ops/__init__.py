"""Tensor ops of the port; each hand-written kernel sits beside its plain
PyTorch version (pooling, spatial_gate, sgam_flash, rab_tail)."""

import torch


def plain_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' compute type: float32 for float32 and narrower
    inputs, float64 kept, so a float64 reference step stays float64."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32
