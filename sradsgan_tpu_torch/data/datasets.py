"""Host-side datasets: folder scan and degradation triplets.

Counterpart of ``sradsgan_tpu/data/datasets.py`` for the two datasets the
training entry point uses:

- :class:`FolderDataset`: image files, degraded with PIL by the
  reference's protocol (train: HR as is, LR = PIL BICUBIC downsample, the
  bicubic twin = LR re-upsampled BICUBIC; test: LR = PIL BILINEAR, the
  torchvision ``Resize`` default).  PIL is imported only here, inside the
  calls that open or resize an image, so a machine without Pillow still
  imports this module and trains on the synthetic set.
- :class:`SyntheticDataset`: deterministic smooth random images for when no
  corpus is mounted.  It draws the same numpy fields from the same seeds as
  the JAX package's, and does the three band upsamples and the LR and twin
  resizes with ``ops/resize.py:resize_uint8`` (PIL's coefficients and its
  8-bit rounding) where the JAX package calls PIL.

Samples are dicts of float32 HWC arrays in [0, 1], ``lr``, ``hr``, ``bc``,
and a ``path``.  Not ported yet: the JAX package's random rotate/flip
augmentation (off by default there, and never applied by the reference),
its luma-only mode, and its augmented-crop, noisy, blurred,
pre-built-triplet and LMDB datasets.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from sradsgan_tpu_torch.ops.resize import resize_uint8

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def is_image_file(name: str) -> bool:
    return name.lower().endswith(IMG_EXTENSIONS)


def scan_image_dirs(dirs: Sequence[str]) -> List[str]:
    files: List[str] = []
    for d in dirs:
        files.extend(os.path.join(d, x) for x in sorted(os.listdir(d))
                     if is_image_file(x))
    return files


def scan_class_dirs(root: str) -> List[Tuple[str, str]]:
    """Sorted (class_name, class_dir) pairs, the UCMerced layout."""
    out = []
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if os.path.isdir(path):
            out.append((name, path))
    return out


def _center_crop(img, size: int):
    w, h = img.size
    if w == size and h == size:
        return img
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def make_triplet(img, scale: int, crop_size: int,
                 lr_filter: str = "bicubic"):
    """(lr, hr, bc) float32 HWC triplet of a PIL image by the reference's
    PIL protocol."""
    from PIL import Image

    img = _center_crop(img.convert("RGB"), crop_size)
    lr_size = crop_size // scale
    resample = Image.BICUBIC if lr_filter == "bicubic" else Image.BILINEAR
    lr_img = img.resize((lr_size, lr_size), resample)
    bc_img = lr_img.resize((crop_size, crop_size), Image.BICUBIC)

    def to_f32(im):
        return np.asarray(im, dtype=np.float32) / 255.0

    return to_f32(lr_img), to_f32(img), to_f32(bc_img)


@dataclasses.dataclass
class FolderDataset:
    """Triplet dataset over image files (needs Pillow)."""

    files: List[str]
    scale: int
    crop_size: int = 216
    lr_filter: str = "bicubic"   # 'bilinear' for the test protocol

    def __len__(self) -> int:
        return len(self.files)

    def load(self, index: int):
        from PIL import Image

        lr, hr, bc = make_triplet(Image.open(self.files[index]), self.scale,
                                  self.crop_size, self.lr_filter)
        return {"lr": lr, "hr": hr, "bc": bc, "path": self.files[index]}


def _resize_u8(arr: np.ndarray, size: int, method: str) -> np.ndarray:
    """HWC uint8 values (any float or integer dtype) -> (size, size, C)
    uint8 values as float32, by PIL's 8-bit resize."""
    x = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return resize_uint8(x, size, size, method).numpy()


@dataclasses.dataclass
class SyntheticDataset:
    """Deterministic smooth random images (no corpus, no Pillow)."""

    size: int
    scale: int
    crop_size: int = 216
    lr_filter: str = "bicubic"
    seed: int = 1234

    def __len__(self) -> int:
        return self.size

    def load(self, index: int):
        g = np.random.default_rng(self.seed + index)
        size = self.crop_size
        # multi-band texture: low, mid and fine random fields plus sharp
        # rectangles, so the LR -> HR mapping has high frequencies to learn
        arr = np.zeros((size, size, 3), np.float32)
        for base, amp in ((7, 0.5), (21, 0.25), (63, 0.12)):
            band = g.random((base, base, 3)).astype(np.float32)
            up = _resize_u8((band * 255).astype(np.uint8), size, "bicubic")
            arr += amp * (up / 255.0)
        for _ in range(6):  # sharp-edged rectangles (buildings, roads)
            y0, x0 = g.integers(0, size - 8, 2)
            h, w = g.integers(4, max(size // 4, 5), 2)
            arr[y0:y0 + h, x0:x0 + w] = (arr[y0:y0 + h, x0:x0 + w] * 0.4
                                         + g.random(3) * 0.6)
        arr = np.clip(arr + 0.08, 0, 1)
        hr = (arr * 255).astype(np.uint8)
        lr = _resize_u8(hr, size // self.scale, self.lr_filter)
        bc = _resize_u8(lr, size, "bicubic")
        return {"lr": lr / 255.0, "hr": hr.astype(np.float32) / 255.0,
                "bc": bc / 255.0, "path": f"synthetic_{index}"}


def build_train_dataset(cfg, scale: int):
    """The reference's RGB training set: one dir per class of AID, DOTA,
    LoveDA and RSSCN7_2800 plus the SECOND root; ``cfg`` is a
    ``DataConfig``."""
    if cfg.synthetic:
        return SyntheticDataset(cfg.synthetic_size, scale, cfg.crop_size)
    dirs: List[str] = []
    for dataset in cfg.train_datasets:
        root = os.path.join(cfg.data_dir, dataset)
        if not os.path.isdir(root):
            continue
        if dataset == "SECOND":
            dirs.append(root)
        else:
            dirs.extend(p for _, p in scan_class_dirs(root))
    files = scan_image_dirs(dirs)[:cfg.max_train_samples]
    if not files:
        raise FileNotFoundError(
            f"no training images under {cfg.data_dir} for "
            f"{cfg.train_datasets}; set data.synthetic=True for synthetic "
            "data")
    return FolderDataset(files, scale, cfg.crop_size, "bicubic")


def build_test_dataset(cfg, scale: int, class_dirs=None):
    """The reference's RGB test set: sorted class dirs, bilinear LR."""
    if cfg.synthetic:
        return SyntheticDataset(max(cfg.synthetic_size // 8, 8), scale,
                                cfg.test_crop_size, lr_filter="bilinear",
                                seed=99)
    if class_dirs is None:
        root = os.path.join(cfg.data_dir, cfg.test_dataset)
        class_dirs = [p for _, p in scan_class_dirs(root)]
    files = scan_image_dirs(class_dirs)
    if not files:
        raise FileNotFoundError(f"no test images under {class_dirs}")
    return FolderDataset(files, scale, cfg.test_crop_size,
                         lr_filter="bilinear")
