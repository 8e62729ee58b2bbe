"""Result images and comparison panels of the evaluation protocol.

Counterpart of ``sradsgan_tpu/utils/plotting.py:19-70``.  Host-side only.
Pillow and matplotlib are imported inside the calls that use them, so that a
machine without them still imports the port: :func:`save_image` raises
without Pillow, and :func:`plot_test_panel` and :func:`plot_chain_grid`
skip their figure without matplotlib, saying so on stderr.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np


def save_image(img01: np.ndarray, path: str) -> None:
    """A float [0, 1] HWC image as png, truncated to uint8 as the reference
    does (``save_img1``, ``utils/utils.py:169``)."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(f"save_image({path!r}) needs Pillow, which does "
                          "not import here") from err
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((np.clip(img01, 0, 1) * 255).astype(np.uint8)).save(path)


def _pyplot(what: str, path: str):
    """matplotlib's pyplot on the Agg backend, or None (with a note on
    stderr) where matplotlib does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"{what}: matplotlib does not import here; nothing drawn at "
              f"{path}", file=sys.stderr)
        return None
    return plt


def plot_test_panel(images: Sequence[np.ndarray], labels: Sequence[str],
                    metrics: Optional[Sequence[Optional[Dict[str, float]]]],
                    path: str) -> bool:
    """The side-by-side panel (HR / LR / bicubic / SR, or LR / bicubic /
    SR), each image titled with its label and, where ``metrics`` has a row
    for it, that row's values.  Returns False, having drawn nothing, where
    matplotlib does not import."""
    plt = _pyplot("plot_test_panel", path)
    if plt is None:
        return False
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(images)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4.6))
    for ax, img, label, m in zip(np.atleast_1d(axes), images, labels,
                                 metrics or [None] * n):
        ax.imshow(np.clip(img, 0, 1))
        ax.set_axis_off()
        title = label
        if m:
            title += "\n" + " ".join(f"{k}:{v:.3f}" for k, v in m.items())
        ax.set_title(title, fontsize=9)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def plot_chain_grid(chain01: np.ndarray, path: str) -> bool:
    """The reverse-diffusion snapshots of one image side by side, titled
    ``t0``, ``t1``, ... and ``final`` (reference sr_mfe.py:305-319, the
    ``_sr_process`` dump).  ``chain01``: (n_snapshots, H, W, C) in [0, 1],
    noise first.  Returns False, having drawn nothing, where matplotlib
    does not import."""
    plt = _pyplot("plot_chain_grid", path)
    if plt is None:
        return False
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = chain01.shape[0]
    fig, axes = plt.subplots(1, n, figsize=(2.2 * n, 2.5))
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.imshow(np.clip(chain01[i], 0, 1))
        ax.set_axis_off()
        ax.set_title("final" if i == n - 1 else f"t{i}", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True
