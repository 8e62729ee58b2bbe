"""BatchNorm with torch semantics, computed in float32, over the global batch.

Counterpart of ``sradsgan_tpu/nn/norm.py``, which reproduces torch's
``BatchNorm2d``: train mode normalizes by the biased batch variance and
updates ``running_var`` with the unbiased one, with torch momentum 0.1 (Flax
momentum 0.9).  Here that is ``nn.BatchNorm2d`` itself, with two additions:

- statistics and normalization run in float32 whatever the input's dtype
  (autocast included), and the output returns to the input's dtype, as the
  JAX discriminator's f32 BatchNorm chain does under bf16 convs;
- in train mode on a data mesh of more than one rank
  (``parallel/mesh.py:active_mesh``) the statistics are the global
  batch's, as under the JAX package's sharded ``jit``
  (:func:`global_batch_norm`).  ``nn.SyncBatchNorm`` cannot serve: it takes
  no CPU tensor, and its backward sums over ranks outside autograd, so the
  gradient penalty's second derivative would miss the other ranks' terms.
"""

from __future__ import annotations

import torch
from torch import nn

from sradsgan_tpu_torch.ops import plain_dtype
from sradsgan_tpu_torch.parallel.mesh import Mesh, active_mesh, all_reduce_sum


def global_batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d,
                      mesh: Mesh) -> torch.Tensor:
    """``bn``'s train-mode forward on ``x`` (NCHW, this rank's rows) with the
    statistics of the rows of every rank: the mean from the sums over
    ranks, then the biased variance from the sums of squared deviations
    from it (two passes, not E[x^2] - E[x]^2, which loses a small variance
    of a large mean), both through differentiable all-reduces.
    ``running_var`` takes the unbiased variance over the global count."""
    dims = (0, 2, 3)
    n = x.numel() // x.shape[1] * mesh.world  # every rank holds as many rows
    mean = all_reduce_sum(x.sum(dims), mesh) / n
    centred = x - mean[:, None, None]
    var = all_reduce_sum(centred.square().sum(dims), mesh) / n
    out = centred * torch.rsqrt(var + bn.eps)[:, None, None]
    if bn.affine:
        out = out * bn.weight[:, None, None] + bn.bias[:, None, None]
    if bn.track_running_stats:
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
            m = (bn.momentum if bn.momentum is not None
                 else 1.0 / float(bn.num_batches_tracked))
            bn.running_mean.mul_(1 - m).add_(m * mean)
            bn.running_var.mul_(1 - m).add_(m * var * n / (n - 1))
    return out


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (its defaults are the reference's: momentum 0.1,
    eps 1e-5) computed in float32 (float64 for a float64 input); in train
    mode over the global batch where the active mesh has more than one
    rank."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = active_mesh()
        with torch.autocast(x.device.type, enabled=False):
            x32 = x.to(plain_dtype(x))
            if self.training and mesh is not None and mesh.world > 1:
                return global_batch_norm(x32, self, mesh).to(x.dtype)
            return super().forward(x32).to(x.dtype)
