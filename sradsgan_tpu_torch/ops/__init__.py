"""Tensor ops of the port; each hand-written kernel sits beside its plain
PyTorch version (pooling, spatial_gate, sgam_flash, rab_tail).

Each kernel's launch is a registered ``torch.library`` op in the namespace
``sradsgan_tpu_torch`` (``torch.ops.sradsgan_tpu_torch.avg_max_pool`` and
so on), defined by its op module with :func:`define`: a CUDA
implementation that calls the module's ``*_cuda`` wrapper, looked up by
name at each call, a CPU implementation that is the plain version, and a
fake one that gives the outputs' shapes and dtypes, so that ``torch.export``
records the op as one node.  The ops have no autograd of their own: the
op modules' ``autograd.Function``s call them and own the gradients.

The package also exports the host-side and library-call ops that the JAX
package's ``ops`` exports or holds: the PIL-coefficient resize, pixel
shuffle, the SRMD-style degradation (``degrade``) and the estimated-kernel
post-processing (``kernel_ops``).
"""

import importlib
from typing import Callable

import torch

NAMESPACE = "sradsgan_tpu_torch"
OP_MODULES = ("pooling", "spatial_gate", "sgam_flash", "rab_tail")

LIB = torch.library.Library(NAMESPACE, "DEF")


def plain_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' compute type: float32 for float32 and narrower
    inputs, float64 kept, so a float64 reference step stays float64."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def define(schema: str, cpu: Callable, cuda: Callable,
           fake: Callable) -> torch._ops.OpOverload:
    """Register the op ``schema`` (``"name(Tensor x, ...) -> ..."``) with its
    three implementations and return it.  An implementation takes the
    schema's arguments with their defaults: the dispatcher leaves out a
    trailing argument that equals its default."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def register_all() -> None:
    """Import every op module, so that all six ops are registered (what a
    loader of an exported program needs before ``torch.export.load``)."""
    for name in OP_MODULES:
        importlib.import_module(f"{__name__}.{name}")


from sradsgan_tpu_torch.ops.degrade import (  # noqa: E402
    add_gaussian_noise,
    add_poisson_noise,
    add_salt_pepper_noise,
    batch_blur,
    gaussian_kernels,
    srmd_preprocess,
)
from sradsgan_tpu_torch.ops.kernel_ops import (  # noqa: E402
    centralize_kernel,
    post_process_kernel,
    zeroize_negligible,
)
from sradsgan_tpu_torch.ops.pixelshuffle import pixel_shuffle  # noqa: E402
from sradsgan_tpu_torch.ops.resize import (  # noqa: E402
    bicubic_resize,
    degrade_pair,
    resize_matrix,
)

__all__ = [
    "NAMESPACE",
    "define",
    "plain_dtype",
    "register_all",
    "bicubic_resize",
    "degrade_pair",
    "resize_matrix",
    "pixel_shuffle",
    "gaussian_kernels",
    "batch_blur",
    "add_gaussian_noise",
    "add_poisson_noise",
    "add_salt_pepper_noise",
    "srmd_preprocess",
    "zeroize_negligible",
    "centralize_kernel",
    "post_process_kernel",
]
