"""Production inference: a shape-bucketed predictor on one device, and
the exported model.

Counterpart of ``sradsgan_tpu/serving.py``.  :class:`Predictor` has the
JAX one's contract:
numpy NHWC float [0, 1] in and out, inputs that fit a bucket reflect-padded
up to it (so only a fixed set of shapes ever reaches the device) and cropped
back, larger inputs sent through halo-tiled inference, which shares the
tiles of a scene over the ranks of a data mesh (``parallel/mesh.py``): under
``torchrun`` every rank builds its ``Predictor`` on its own card and calls it
with the same scene.  The model runs under
``torch.inference_mode()``, in float32 or, with ``dtype=torch.bfloat16``, in
bf16 with the gate math and softmax statistics kept in float32 as in the
JAX package.

:func:`export_model` / :func:`load_exported` write and read the generator as
a ``torch.export`` program (the JAX package writes StableHLO): the weights
inside, the port's kernels as the registered ops
``torch.ops.sradsgan_tpu_torch.*``, so that a loaded program launches them on
the card.  Reading an artifact needs this package importable (the ops'
definitions), not the model's code.
"""

from __future__ import annotations

import copy
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from sradsgan_tpu_torch.evaluation.tiled import (forward_numpy,
                                                 tiled_super_resolve)
from sradsgan_tpu_torch.nn.attention import SpatialGate
from sradsgan_tpu_torch.parallel.mesh import Mesh

DTYPES = (torch.float32, torch.bfloat16)
# What a bf16 copy keeps in float32, as the JAX package keeps its params
# and statistics: the SLAM 7x7 kernels, which the gate reads in float32,
# the BatchNorms (SRGAN, SRAGAN), which normalize in float32, and HAT's
# relative position bias tables, which the float32 softmax adds.
FLOAT32_MODULES = (SpatialGate, nn.BatchNorm2d)
FLOAT32_PARAMS = ("relative_position_bias_table",)


def _float32_names(model: nn.Module) -> set:
    names = {n for n, _ in model.named_parameters()
             if n.rpartition(".")[2] in FLOAT32_PARAMS}
    for prefix, m in model.named_modules():
        if isinstance(m, FLOAT32_MODULES):
            names.update(f"{prefix}.{k}" for k in m.state_dict())
    return names


def _compute_copy(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``model`` in ``dtype``, but for the tensors
    ``FLOAT32_MODULES`` and ``FLOAT32_PARAMS`` name, which keep the
    original's float32 values."""
    keep = _float32_names(model)
    source = model.state_dict()
    out = copy.deepcopy(model).to(dtype)
    for name, t in [*out.named_parameters(), *out.named_buffers()]:
        if name in keep:
            t.data = source[name].to(torch.float32, copy=True)
    return out


class Predictor:
    """Batched SR inference with a fixed input-shape bucket set.

    ``model`` is moved to ``device`` (in place); a bf16 predictor runs a
    bf16 copy of it.  It serves the model as it was built: a generator
    made with ``create_generator(..., rab_tail="fused")`` runs its fused
    RAB tails.  ``mesh`` (default: the active mesh, if any) is the data
    mesh the tiled fallback shares its tiles over; each rank gets the
    whole scene.
    """

    def __init__(self, model: nn.Module, scale: int,
                 buckets: Sequence[int] = (54, 72, 108, 216),
                 tile: int = 54, halo: int = 8, *,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32,
                 mesh: Optional[Mesh] = None):
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
        self.mesh = mesh

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
                                    device=self.device, dtype=self.dtype,
                                    mesh=self.mesh)
                for i in range(b)])
        else:
            padded = np.pad(lr01, ((0, 0), (0, bucket - h), (0, bucket - w),
                                   (0, 0)), mode="reflect")
            out = forward_numpy(self.model, padded, self.device, self.dtype)
            out = out[:, :h * self.scale, :w * self.scale]
        return out[0] if squeeze else out


class _NHWC(nn.Module):
    """A generator with the JAX package's layout: (B, H, W, C) in and
    out."""

    def __init__(self, generator: nn.Module):
        super().__init__()
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.generator(x.permute(0, 3, 1, 2).contiguous())
        return out.permute(0, 2, 3, 1)


def export_model(generator: nn.Module, lr_size: int, out_path: str,
                 batch: int = 1, channels: int = 3, *,
                 device: torch.device | str = "cuda") -> str:
    """Write the eval generator as a ``torch.export`` program to
    ``out_path`` (``torch.export.save``), traced for a (batch, lr_size,
    lr_size, channels) NHWC float32 batch.

    The artifact holds a float32 copy of the weights on ``device`` (the
    generator itself is left as it is); :func:`load_exported` runs it
    there unless told another device.  The port's kernels are nodes of
    the registered ops, not their plain expansion, so an artifact traced
    on the CPU launches the kernels when loaded onto the card.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"export_model(device={str(device)!r}) needs a CUDA device and "
            "this torch sees none; pass device='cpu' to export on the CPU")
    model = _NHWC(copy.deepcopy(generator)).float().to(device).eval()
    model.requires_grad_(False)
    x = torch.zeros((batch, lr_size, lr_size, channels), device=device)
    with torch.no_grad():
        program = torch.export.export(model, (x,))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.export.save(program, out_path)
    return out_path


def load_exported(path: str, device: Optional[torch.device | str] = None):
    """Read an artifact of :func:`export_model`; returns a callable from an
    NHWC float [0, 1] batch (numpy or tensor) to the NHWC SR batch as
    numpy.  It runs on the device the weights were exported on, or on
    ``device`` (the program moved there)."""
    from sradsgan_tpu_torch.ops import register_all

    register_all()
    program = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, torch.device(device))
    module = program.module()
    weights = next(iter(program.state_dict.values()))

    def run(lr01) -> np.ndarray:
        x = torch.as_tensor(np.asarray(lr01, np.float32)).to(weights.device)
        with torch.no_grad():
            return module(x).cpu().numpy()

    return run
