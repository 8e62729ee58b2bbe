"""Result images and comparison panels of the evaluation protocol.

Counterpart of ``sradsgan_tpu/utils/plotting.py:19-48``.  Host-side only.
Pillow and matplotlib are imported inside the calls that use them, so that a
machine without them still imports the port: :func:`save_image` raises
without Pillow, and :func:`plot_test_panel` skips the panel without
matplotlib, saying so on stderr.
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


def plot_test_panel(images: Sequence[np.ndarray], labels: Sequence[str],
                    metrics: Optional[Sequence[Optional[Dict[str, float]]]],
                    path: str) -> bool:
    """The side-by-side panel (HR / LR / bicubic / SR, or LR / bicubic /
    SR), each image titled with its label and, where ``metrics`` has a row
    for it, that row's values.  Returns False, having drawn nothing, where
    matplotlib does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"plot_test_panel: matplotlib does not import here; no panel "
              f"drawn at {path}", file=sys.stderr)
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
