"""Halo-tiled super-resolution of scenes larger than any serving bucket,
data-parallel over the ranks of the mesh.

Counterpart of ``sradsgan_tpu/evaluation/tiled.py``: the image is
reflect-padded, cut into overlapping tiles (a halo of ``halo`` LR pixels on
every side absorbs the convs' edge effects), the tiles go through the
generator in chunks, and the upscaled tile cores are stitched back.  On a
mesh of W ranks (``parallel/mesh.py``) each chunk holds the largest multiple
of W up to ``batch_tiles`` (W at least), its tail is padded to a multiple of
W by repeating its last tile, each rank forwards its rows (``rank::W``) on
its own device, and the SR tiles are gathered back in order, so that every
rank stitches and returns the whole scene, as the JAX function returns it to
its host.  One process runs every chunk itself.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from sradsgan_tpu_torch.parallel.mesh import (Mesh, active_mesh, gather_rows,
                                              pad_batch_to_devices,
                                              shard_batch)


def _forward(model: nn.Module, lr01: np.ndarray, device: torch.device | str,
             dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, C) float [0, 1] numpy -> (B, sH, sW, C) float32 tensor on
    ``device``; call under ``torch.inference_mode()``."""
    x = torch.from_numpy(np.ascontiguousarray(lr01.transpose(0, 3, 1, 2)))
    y = model(x.to(device=device, dtype=dtype))
    return y.float().permute(0, 2, 3, 1)


def forward_numpy(model: nn.Module, lr01: np.ndarray,
                  device: torch.device | str,
                  dtype: torch.dtype = torch.float32) -> np.ndarray:
    """(B, H, W, C) float [0, 1] -> (B, sH, sW, C) float32, NHWC numpy on
    both sides, the model run in ``dtype`` on ``device``."""
    with torch.inference_mode():
        return _forward(model, lr01, device, dtype).cpu().numpy()


def _forward_chunk(model: nn.Module, tiles: np.ndarray, mesh: Mesh,
                   device: torch.device | str,
                   dtype: torch.dtype) -> np.ndarray:
    """One chunk over the mesh: padded to a multiple of the world size,
    each rank's rows forwarded, the SR rows gathered in the chunk's order
    and the padding dropped."""
    padded = pad_batch_to_devices(tiles, mesh)
    with torch.inference_mode():
        sr = _forward(model, shard_batch(padded, mesh), device, dtype)
        return gather_rows(sr, mesh)[:len(tiles)].cpu().numpy()


def tiled_super_resolve(model: nn.Module, image01: np.ndarray, scale: int,
                        tile: int = 54, halo: int = 8, batch_tiles: int = 64,
                        *, device: torch.device | str,
                        dtype: torch.dtype = torch.float32,
                        mesh: Optional[Mesh] = None) -> np.ndarray:
    """SR a (H, W, C) float [0, 1] image of any size; tile and halo are in
    LR pixels, each chunk holds up to ``batch_tiles`` tiles of (tile + 2 *
    halo)^2.  ``mesh`` None is the active mesh, or one process where there
    is none (or it has no process group); on more than one rank every rank
    must call this with the same image and its own ``mesh.device``, and
    each gets the whole scene."""
    mesh = mesh or active_mesh()
    if mesh is None or mesh.group is None:
        mesh = Mesh(0, 1, torch.device(device))
    h, w, c = image01.shape
    ny = math.ceil(h / tile)
    nx = math.ceil(w / tile)
    padded = np.pad(image01, ((halo, halo + ny * tile - h),
                              (halo, halo + nx * tile - w), (0, 0)),
                    mode="reflect")
    tiles = np.stack([padded[y0:y0 + tile + 2 * halo, x0:x0 + tile + 2 * halo]
                      for y0 in range(0, ny * tile, tile)
                      for x0 in range(0, nx * tile, tile)]).astype(np.float32)
    chunk = max(batch_tiles - batch_tiles % mesh.world, mesh.world)
    sr_tiles = np.concatenate([
        _forward_chunk(model, tiles[i:i + chunk], mesh, device, dtype)
        for i in range(0, len(tiles), chunk)])

    hs = halo * scale
    ts = tile * scale
    result = np.zeros((ny * ts, nx * ts, c), np.float32)
    for k, core in enumerate(sr_tiles[:, hs:hs + ts, hs:hs + ts]):
        iy, ix = divmod(k, nx)
        result[iy * ts:(iy + 1) * ts, ix * ts:(ix + 1) * ts] = core
    return result[:h * scale, :w * scale]
