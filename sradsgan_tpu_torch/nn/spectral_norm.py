"""Spectrally normalized convolution (NCHW).

Counterpart of ``sradsgan_tpu/nn/spectral_norm.py:SNConv``, with the JAX
package's own power iteration rather than
``torch.nn.utils.parametrizations.spectral_norm``, from which it differs in
three ways:

- sigma carries no gradient at all: the kernel is divided by a constant, so
  W's gradient is the plain conv's over sigma (torch's keeps the path
  through sigma to W);
- ``u`` moves only in train mode (JAX's ``update_stats``), never at init;
- ``u`` is a buffer here, where JAX keeps it in its ``spectral``
  collection; ``tools/from_jax.py`` carries it across.

The conv pads as XLA's "SAME" does (:func:`~sradsgan_tpu_torch.nn.blocks.same_pad`),
(0, 1) at stride 2 on an even size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.blocks import same_pad
from sradsgan_tpu_torch.ops import plain_dtype

EPS = 1e-12


def _normalized(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + EPS)


class SNConv(nn.Conv2d):
    """A conv whose kernel is divided by its largest singular value, as
    ``n_iter`` power iterations from ``u`` estimate it; the kernel read as
    the (k * k * in, out) matrix of JAX's HWIO kernel (the order of its
    rows changes neither sigma nor ``u``)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, stride: int = 1, n_iter: int = 1):
        super().__init__(in_features, features, kernel_size, stride)
        self.n_iter = n_iter
        self.register_buffer("u", torch.randn(features))

    def init_buffers(self, gen: torch.Generator) -> None:
        """``u`` normal(0, 1), as JAX draws it (from its own key)."""
        self.u.normal_(0.0, 1.0, generator=gen)

    def sigma(self) -> tuple:
        """(sigma, the iteration's new u), neither with a gradient."""
        with torch.no_grad():
            dtype = plain_dtype(self.weight)
            w = self.weight.flatten(1).t().to(dtype)  # (k * k * in, out)
            u = self.u.to(dtype)
            for _ in range(self.n_iter):
                v = _normalized(w @ u)
                u = _normalized(w.t() @ v)
            return v @ (w @ u), u

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sigma, u = self.sigma()
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
        weight = self.weight / sigma.to(self.weight.dtype)
        return F.conv2d(same_pad(x, self.kernel_size[0], self.stride[0]),
                        weight, self.bias, self.stride)
