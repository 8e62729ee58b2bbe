"""Single-image inference of the evaluation protocol.

Counterpart of the part of ``sradsgan_tpu/evaluation/validate.py`` that
``cli infer`` needs: :class:`Evaluator` (only its ``super_resolve``) and
:func:`mfe_test_single` (the reference's ``mfe_test_single``,
``model/sradsgan.py:1603-1639``).  The image goes through the eval
generator as it is, with no bucket padding: CGAM and SGAM attend over the
whole image, so a padded image would give another SR.  PIL and matplotlib
are imported only inside the calls that use them; the panel is drawn only
where matplotlib imports.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from sradsgan_tpu_torch.evaluation.tiled import forward_numpy


def save_image(img01: np.ndarray, path: str) -> None:
    """A float [0, 1] HWC image as png, truncated to uint8 as the reference
    does (``save_img1``; ``sradsgan_tpu/utils/plotting.py:19-25``)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((np.clip(img01, 0, 1) * 255).astype(np.uint8)).save(path)


def plot_test_panel(images: Sequence[np.ndarray], labels: Sequence[str],
                    path: str) -> bool:
    """The LR / bicubic / SR panel (``sradsgan_tpu/utils/plotting.py``), or
    False where matplotlib does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, axes = plt.subplots(1, len(images), figsize=(4 * len(images), 4.6))
    for ax, img, label in zip(np.atleast_1d(axes), images, labels):
        ax.imshow(np.clip(img, 0, 1))
        ax.set_axis_off()
        ax.set_title(label, fontsize=9)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


class Evaluator:
    """SR inference with the eval generator (``validate.py:68-88``)."""

    def __init__(self, generator: nn.Module, scale: int,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32):
        self.generator = generator.to(device).eval()
        self.scale = scale
        self.device = device
        self.dtype = dtype

    def super_resolve(self, lr_batch: np.ndarray) -> np.ndarray:
        """(B, H, W, C) float [0, 1] -> (B, sH, sW, C) float32, the batch
        forwarded as it is."""
        return forward_numpy(self.generator, lr_batch, self.device,
                             self.dtype)


def mfe_test_single(generator: nn.Module, image_path: str, scale: int,
                    save_dir: str, crop_size: Optional[int] = None,
                    device: torch.device | str = "cuda",
                    dtype: torch.dtype = torch.float32) -> Dict[str, str]:
    """Centre-crop, SR, and save the SR png, the bicubic png and, where
    matplotlib imports, the panel (``validate.py:198-228``).  Returns the
    paths written."""
    from PIL import Image

    img = Image.open(image_path).convert("RGB")
    if crop_size:
        w, h = img.size
        left, top = (w - crop_size) // 2, (h - crop_size) // 2
        img = img.crop((left, top, left + crop_size, top + crop_size))
    lr01 = np.asarray(img, np.float32) / 255.0
    bc01 = np.asarray(
        img.resize((img.width * scale, img.height * scale), Image.BICUBIC),
        np.float32) / 255.0
    sr01 = Evaluator(generator, scale, device, dtype).super_resolve(
        lr01[None])[0]

    os.makedirs(save_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(image_path))[0]
    out = {"sr": os.path.join(save_dir, f"SR_{name}_x{scale}.png"),
           "bicubic": os.path.join(save_dir, f"Bicubic_{name}_x{scale}.png")}
    save_image(sr01, out["sr"])
    save_image(bc01, out["bicubic"])
    panel = os.path.join(save_dir, f"panel_{name}_x{scale}.png")
    if plot_test_panel([lr01, bc01, np.clip(sr01, 0, 1)],
                       ["LR input", "Bicubic", "SR"], panel):
        out["panel"] = panel
    else:
        print("mfe_test_single: matplotlib does not import here; no panel "
              "drawn", file=sys.stderr)
    return out
