"""Host-side tools of the port: weight transfer, data preparation, scene
classification, the dry run and the probes."""

from __future__ import annotations

import torch


def require_cuda(device: torch.device | str, what: str) -> None:
    """Raise when ``device`` is the card and this torch sees none: a tool
    that defaults to the card never moves to the CPU on its own."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}(device={str(device)!r}) needs a CUDA "
                           "device and this torch sees none; pass "
                           "device='cpu' to run on the CPU")
