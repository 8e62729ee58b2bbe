"""Model cost reporting and profiling.

Counterpart of ``sradsgan_tpu/utils/report.py``, the reference's thop-based
``print_network_to_file`` (utils/utils.py:971-1008, ``network.txt`` at
train and eval start): parameter counts from the module, FLOPs from
``torch.utils.flop_counter.FlopCounterMode``, and :func:`trace`, a
``torch.profiler`` context that writes a Chrome trace.  Nothing in the port
calls these, as nothing in the JAX package calls its own.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch import nn


def count_params(model: nn.Module) -> int:
    """The number of parameter values, buffers (BatchNorm statistics,
    LPIPS heads) excluded, as the JAX package counts ``variables["params"]``.
    For weights carried from JAX the two agree, but for AMSSRN, whose
    reference shares one PReLU slope among an ASPP's three branches where
    JAX holds three."""
    return sum(p.numel() for p in model.parameters())


def flops_estimate(model: nn.Module, *inputs) -> Optional[float]:
    """FLOPs of one no-grad forward ``model(*inputs)`` as
    ``FlopCounterMode`` counts them (two a multiply-add of the matmuls and
    convolutions it knows; None where the count fails).  The JAX package
    reads XLA's cost analysis of the compiled program, which also counts
    elementwise work after fusion, so the two numbers need not agree."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            model(*inputs)
        return float(counter.get_total_flops())
    except Exception:
        return None


def print_network_to_file(model: nn.Module, example_input: torch.Tensor,
                          save_dir: str, tag: str) -> str:
    """Append a block to ``save_dir/network.txt`` in the JAX package's
    format: the tag, the parameter count, the FLOPs of one forward of
    ``example_input`` and the module's repr; returns the file's path."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "network.txt")
    n_params = count_params(model)
    flops = flops_estimate(model, example_input)
    with open(path, "a") as f:
        f.write(f"=== {tag} ===\n")
        f.write(f"params: {n_params} ({n_params / 1e6:.3f} M)\n")
        if flops is not None:
            f.write(f"flops (FlopCounterMode, batch "
                    f"{example_input.shape[0]}): {flops:.3e} "
                    f"({flops / 1e9:.3f} G)\n")
        f.write(str(model) + "\n\n")
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` trace of the block, the CPU and, where there is
    one, the CUDA device, written on exit to ``log_dir`` as a Chrome trace
    ``trace_<time>_<pid>.json`` (chrome://tracing or Perfetto opens it)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))
