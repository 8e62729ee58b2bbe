"""Result images, comparison panels, training curves, attention overlays
and epoch animations.

Counterpart of ``sradsgan_tpu/utils/plotting.py``.  Host-side only.
Pillow and matplotlib are imported inside the calls that use them, so that a
machine without them still imports the port: :func:`save_image` raises
without Pillow; the figures (:func:`plot_test_panel`,
:func:`plot_chain_grid`, :func:`plot_curves`,
:func:`show_attention_on_image`) are skipped without matplotlib, and
:func:`show_attention_on_image` and :func:`make_gif` without Pillow, each
saying so on stderr and returning False.
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


def _pillow(what: str, path: str):
    """Pillow's ``Image``, or None (with a note on stderr) where Pillow
    does not import."""
    try:
        from PIL import Image
    except ImportError:
        print(f"{what}: Pillow does not import here; nothing written at "
              f"{path}", file=sys.stderr)
        return None
    return Image


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


def plot_curves(history: Dict[str, Sequence[float]], path: str) -> bool:
    """One panel a non-empty series of ``history`` (the loss and metric
    curves of a training run, reference utils/utils.py:55-86).  Returns
    False, having drawn nothing, where matplotlib does not import or every
    series is empty."""
    keys = [k for k, v in history.items() if len(v)]
    if not keys:
        return False
    plt = _pyplot("plot_curves", path)
    if plt is None:
        return False
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3.2))
    for ax, k in zip(np.atleast_1d(axes), keys):
        ax.plot(history[k])
        ax.set_title(k, fontsize=10)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def show_attention_on_image(image01: np.ndarray, mask01: np.ndarray,
                            path: str) -> bool:
    """Jet-heatmap attention overlay (reference utils/utils.py:156-167):
    ``(jet(mask) + image) / max(...)``, the additive blend renormalized by
    its global maximum, matplotlib's jet colormap standing in for
    ``cv2.applyColorMap(COLORMAP_JET)``, saved by :func:`save_image`.
    ``image01``: (H, W, 3) in [0, 1]; ``mask01``: (H, W) in [0, 1].
    Returns False, having written nothing, where matplotlib or Pillow does
    not import."""
    if _pyplot("show_attention_on_image", path) is None or _pillow(
            "show_attention_on_image", path) is None:
        return False
    from matplotlib import cm

    mask8 = np.uint8(255 * np.asarray(mask01, np.float32))
    heatmap = cm.jet(mask8 / 255.0)[..., :3].astype(np.float32)
    attention = heatmap + np.asarray(image01, np.float32)
    attention = attention / max(float(attention.max()), 1e-8)
    save_image(attention, path)
    return True


def make_gif(frame_paths: Sequence[str], out_path: str,
             fps: float = 5.0) -> bool:
    """The frames (image files, e.g. each epoch's result png) as a looping
    gif at ``fps`` (reference utils/utils.py:87-95, ``make_gif``, there
    through imageio).  Returns False, having written nothing, where there
    are no frames or Pillow does not import."""
    image = _pillow("make_gif", out_path)
    if image is None or not frame_paths:
        return False
    frames = [image.open(p).convert("P", palette=image.ADAPTIVE)
              for p in frame_paths]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return True
