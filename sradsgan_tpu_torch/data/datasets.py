"""Host-side datasets: folder scans, degradation triplets and their
variants.

Counterpart of ``sradsgan_tpu/data/datasets.py``.  Samples are dicts of
float32 HWC arrays in [0, 1], ``lr``, ``hr``, ``bc`` (the bicubic twin),
a ``path`` and, for masked triplet folders, ``hr_mask``.  Every dataset
has ``load(index, rng=None)``; ``rng`` is a numpy ``Generator`` (the
loader's ``augment_rng``) where the dataset draws.  The variants take the
same numpy draws in the same order and make the same PIL calls as the JAX
package's, so their samples are bit-equal to its.  PIL (and ``lmdb``) are
imported only inside the calls that need them, so a machine without
Pillow still imports this module and trains on the synthetic set.

- :class:`FolderDataset`: image files, degraded with PIL by the
  reference's protocol (train: HR as is, LR = PIL BICUBIC downsample, the
  twin = LR re-upsampled BICUBIC; test: LR = PIL BILINEAR, the
  torchvision ``Resize`` default); ``augment`` rotates by k * 90 degrees
  and flips left-right and top-bottom at random (off by default, as the
  reference never applies it), ``gray`` super-resolves the luma only.
- :class:`SyntheticDataset`: deterministic smooth random images for when no
  corpus is mounted.  It draws the same numpy fields from the same seeds as
  the JAX package's, and does the three band upsamples and the LR and twin
  resizes with ``ops/resize.py:resize_uint8`` (PIL's coefficients and its
  8-bit rounding) where the JAX package calls PIL.
- :class:`AugmentedCropDataset`: random scale in [0.5, 1], random crop,
  rot90 and flips (the reference's ``Dataset``).
- :class:`NoisyDataset`: the LR with Gaussian, salt-and-pepper or Poisson
  noise (the reference's ``DatasetFromFolder``).
- :class:`BlurDegradedDataset`: PIL Gaussian blur before the downsample
  (the reference's ``RandomCropDatasetFromFolder``).
- :class:`TripletFolderDataset` and :class:`LMDBTripletDataset`: GDP's
  pre-built ``lr_{l}`` / ``hr_{r}`` / ``sr_{l}_{r}`` triplets, as folders
  or LMDB records (``tools/prepare_data.py`` writes both).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

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
                 lr_filter: str = "bicubic", gray: bool = False):
    """(lr, hr, bc) float32 HWC triplet of a PIL image by the reference's
    PIL protocol; ``gray=True`` keeps the luma (PIL's YCbCr channel 0) as
    one channel, the reference's is_gray path."""
    from PIL import Image

    img = img.convert("YCbCr").getchannel(0) if gray else img.convert("RGB")
    img = _center_crop(img, crop_size)
    lr_size = crop_size // scale
    resample = Image.BICUBIC if lr_filter == "bicubic" else Image.BILINEAR
    lr_img = img.resize((lr_size, lr_size), resample)
    bc_img = lr_img.resize((crop_size, crop_size), Image.BICUBIC)

    def to_f32(im):
        arr = _to_f32(im)
        return arr[..., None] if arr.ndim == 2 else arr

    return to_f32(lr_img), to_f32(img), to_f32(bc_img)


def _to_f32(img) -> np.ndarray:
    return np.asarray(img, dtype=np.float32) / 255.0


@dataclasses.dataclass
class FolderDataset:
    """Triplet dataset over image files (needs Pillow)."""

    files: List[str]
    scale: int
    crop_size: int = 216
    lr_filter: str = "bicubic"   # 'bilinear' for the test protocol
    augment: bool = False
    gray: bool = False           # luma-only SR (the reference's is_gray)

    def __len__(self) -> int:
        return len(self.files)

    def load(self, index: int, rng: Optional[np.random.Generator] = None):
        """The triplet of file ``index``; with ``augment`` and an ``rng``,
        rotated by ``90 * rng.integers(0, 4)`` degrees, then flipped
        left-right and top-bottom each on one ``rng.integers(0, 2)``."""
        from PIL import Image

        img = Image.open(self.files[index])
        if self.augment and rng is not None:
            k = int(rng.integers(0, 4))
            img = img.rotate(90 * k)
            if rng.integers(0, 2):
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if rng.integers(0, 2):
                img = img.transpose(Image.FLIP_TOP_BOTTOM)
        lr, hr, bc = make_triplet(img, self.scale, self.crop_size,
                                  self.lr_filter, self.gray)
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

    def load(self, index: int, rng=None):
        """Image ``index`` (``rng`` is unused: the image depends on the
        seed and the index alone)."""
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


@dataclasses.dataclass
class AugmentedCropDataset(FolderDataset):
    """Random scale, random crop, rot90 and flips, then the bicubic
    triplet (the reference's ``Dataset``, data/dataset.py:222-306): the
    image is scaled by a factor drawn in [0.5, 1] (never below the crop),
    cropped at a random corner, rotated by a random multiple of 90 degrees
    and flipped left-right and top-bottom at random.  Without an ``rng``
    it draws from ``np.random.default_rng(index)``."""

    random_scale: bool = True

    def load(self, index: int, rng: Optional[np.random.Generator] = None):
        from PIL import Image

        rng = rng or np.random.default_rng(index)
        img = Image.open(self.files[index]).convert("RGB")
        if self.random_scale:
            factor = float(rng.uniform(0.5, 1.0))
            w = max(int(img.width * factor), self.crop_size)
            h = max(int(img.height * factor), self.crop_size)
            img = img.resize((w, h), Image.BICUBIC)
        if img.width > self.crop_size or img.height > self.crop_size:
            left = int(rng.integers(0, img.width - self.crop_size + 1))
            top = int(rng.integers(0, img.height - self.crop_size + 1))
            img = img.crop((left, top, left + self.crop_size,
                            top + self.crop_size))
        k = int(rng.integers(0, 4))
        if k:
            img = img.rotate(90 * k)
        if rng.integers(0, 2):
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if rng.integers(0, 2):
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
        lr, hr, bc = make_triplet(img, self.scale, self.crop_size,
                                  self.lr_filter)
        return {"lr": lr, "hr": hr, "bc": bc, "path": self.files[index]}


@dataclasses.dataclass
class NoisyDataset(FolderDataset):
    """The folder triplet with its LR corrupted (the reference's
    ``DatasetFromFolder`` and its noise helpers, data/dataset.py:15-49),
    clipped to [0, 1]:

    - ``"gaussian"``: + normal(0, ``noise_level``);
    - ``"sp"``: white where a uniform draw a pixel is below
      ``noise_level / 2``, black where it is above ``1 - noise_level / 2``;
    - ``"poisson"``: shot noise, Poisson(lr * vals) / vals with ``vals`` the
      power of two at or above the number of distinct values in the LR (the
      reference's utils/utils.py:897-905; data-dependent, unlike
      ``ops/degrade.py``'s static 256).

    The triplet itself is not augmented; without an ``rng`` the noise is
    drawn from ``np.random.default_rng(index)``."""

    noise: str = "gaussian"   # 'gaussian' | 'sp' | 'poisson'
    noise_level: float = 0.01

    def load(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(index)
        out = super().load(index, None)
        lr = out["lr"]
        if self.noise == "gaussian":
            lr = lr + rng.normal(0, self.noise_level,
                                 lr.shape).astype(np.float32)
        elif self.noise == "poisson":
            vals = 2.0 ** np.ceil(np.log2(max(len(np.unique(lr)), 2)))
            lr = rng.poisson(np.maximum(lr, 0.0) * vals).astype(
                np.float32) / vals
        else:
            u = rng.random(lr.shape[:2] + (1,))
            lr = np.where(u < self.noise_level / 2, 1.0,
                          np.where(u > 1 - self.noise_level / 2, 0.0, lr))
        out["lr"] = np.clip(lr, 0.0, 1.0).astype(np.float32)
        return out


@dataclasses.dataclass
class BlurDegradedDataset(FolderDataset):
    """PIL Gaussian blur (radius ``blur_sigma``) of the center crop before
    its BICUBIC downsample; HR is the unblurred crop (the reference's
    ``RandomCropDatasetFromFolder``, data/dataset.py:331-366)."""

    blur_sigma: float = 1.5

    def load(self, index: int, rng: Optional[np.random.Generator] = None):
        from PIL import Image, ImageFilter

        img = Image.open(self.files[index]).convert("RGB")
        img = _center_crop(img, self.crop_size)
        blurred = img.filter(ImageFilter.GaussianBlur(self.blur_sigma))
        lr_size = self.crop_size // self.scale
        lr_img = blurred.resize((lr_size, lr_size), Image.BICUBIC)
        bc_img = lr_img.resize((self.crop_size, self.crop_size),
                               Image.BICUBIC)
        return {"lr": _to_f32(lr_img), "hr": _to_f32(img),
                "bc": _to_f32(bc_img), "path": self.files[index]}


@dataclasses.dataclass
class TripletFolderDataset:
    """Pre-built ``lr_{l}`` / ``hr_{r}`` / ``sr_{l}_{r}`` triplet folders, the
    GDP layout (GDP_x0/data/LRHR_dataset.py:9-128, folder mode), values in
    [0, 1] (the diffusion trainer maps them to [-1, 1]).  ``hflip`` flips
    the triplet left-right together on one ``rng.integers(0, 2)`` where an
    ``rng`` is given (GDP_x0/data/util.py:74-92).  ``hr_mask`` also reads
    the ``hr_mask_{r}`` sibling folder, returned as ``hr_mask`` and flipped
    with the rest (the reference augments [SR, HR, mask] together)."""

    root: str
    lr_size: int
    hr_size: int
    hflip: bool = False
    hr_mask: bool = False

    def __post_init__(self):
        def scan(name):
            return scan_image_dirs([os.path.join(self.root, name)])

        self.lr_files = scan(f"lr_{self.lr_size}")
        self.hr_files = scan(f"hr_{self.hr_size}")
        self.sr_files = scan(f"sr_{self.lr_size}_{self.hr_size}")
        if not len(self.lr_files) == len(self.hr_files) == len(self.sr_files):
            raise ValueError(
                f"{self.root}: {len(self.lr_files)} LR, {len(self.hr_files)}"
                f" HR and {len(self.sr_files)} SR files")
        self.mask_files = None
        if self.hr_mask:
            self.mask_files = scan(f"hr_mask_{self.hr_size}")
            if len(self.mask_files) != len(self.hr_files):
                raise ValueError(f"{self.root}: {len(self.mask_files)} masks "
                                 f"for {len(self.hr_files)} HR files")

    def __len__(self) -> int:
        return len(self.hr_files)

    def load(self, index: int, rng: Optional[np.random.Generator] = None):
        from PIL import Image

        def read(path):
            return _to_f32(Image.open(path).convert("RGB"))

        lr = read(self.lr_files[index])
        hr = read(self.hr_files[index])
        bc = read(self.sr_files[index])
        mask = (read(self.mask_files[index])
                if self.mask_files is not None else None)
        if self.hflip and rng is not None and rng.integers(0, 2):
            lr, hr, bc = lr[:, ::-1], hr[:, ::-1], bc[:, ::-1]
            if mask is not None:
                mask = mask[:, ::-1]
        out = {"lr": np.ascontiguousarray(lr),
               "hr": np.ascontiguousarray(hr),
               "bc": np.ascontiguousarray(bc),
               "path": self.hr_files[index]}
        if mask is not None:
            out["hr_mask"] = np.ascontiguousarray(mask)
        return out


class LMDBTripletDataset:
    """GDP's LMDB-mode triplets (GDP_x0/data/LRHR_dataset.py:18-95).

    Keys: ``b"length"`` -> the count; ``hr_{r}_{i:05d}``,
    ``sr_{l}_{r}_{i:05d}`` and ``lr_{l}_{i:05d}`` -> encoded images.  An
    index whose HR or SR record is missing is replaced by one drawn from
    ``rng`` (else ``np.random.default_rng(index)``) until both are there.
    Where the LR record is missing (or ``need_lr`` is off) the LR is the
    PIL BICUBIC downsample of the decoded HR, the protocol's LR.

    ``root_or_env`` is a path, opened read-only with the ``lmdb`` package
    (imported here; a path without it raises ``ImportError``), or any
    object with lmdb's ``begin()`` transaction interface."""

    def __init__(self, root_or_env, lr_size: int, hr_size: int,
                 data_len: int = -1, need_lr: bool = True,
                 hflip: bool = False):
        if isinstance(root_or_env, (str, os.PathLike)):
            try:
                import lmdb
            except ImportError as e:
                raise ImportError(
                    "lmdb-mode GDP datasets need the 'lmdb' package "
                    "(not bundled in this image); use the folder layout "
                    "(TripletFolderDataset) or pass a compatible env"
                ) from e
            self.env = lmdb.open(str(root_or_env), readonly=True,
                                 lock=False, readahead=False, meminit=False)
        else:
            self.env = root_or_env
        self.lr_size, self.hr_size = lr_size, hr_size
        self.need_lr = need_lr
        self.hflip = hflip
        with self.env.begin(write=False) as txn:
            self.dataset_len = int(txn.get(b"length"))
        self.data_len = (self.dataset_len if data_len <= 0
                         else min(data_len, self.dataset_len))

    def __len__(self) -> int:
        return self.data_len

    @staticmethod
    def _decode(raw: bytes) -> np.ndarray:
        import io

        from PIL import Image

        return _to_f32(Image.open(io.BytesIO(raw)).convert("RGB"))

    def _fetch(self, txn, index: int):
        tag = str(index).zfill(5)
        hr = txn.get(f"hr_{self.hr_size}_{tag}".encode())
        sr = txn.get(f"sr_{self.lr_size}_{self.hr_size}_{tag}".encode())
        lr = (txn.get(f"lr_{self.lr_size}_{tag}".encode())
              if self.need_lr else None)
        return hr, sr, lr

    def load(self, index: int, rng: Optional[np.random.Generator] = None):
        from PIL import Image

        redraw = rng if rng is not None else np.random.default_rng(index)
        with self.env.begin(write=False) as txn:
            hr, sr, lr = self._fetch(txn, index)
            while hr is None or sr is None:
                index = int(redraw.integers(0, self.data_len))
                hr, sr, lr = self._fetch(txn, index)
        out = {"hr": self._decode(hr), "bc": self._decode(sr),
               "path": f"lmdb:{index:05d}"}
        if lr is not None:
            out["lr"] = self._decode(lr)
        else:
            hr_img = Image.fromarray(
                (out["hr"] * 255.0 + 0.5).astype(np.uint8))
            out["lr"] = _to_f32(hr_img.resize((self.lr_size, self.lr_size),
                                              Image.BICUBIC))
        if self.hflip and rng is not None and rng.integers(0, 2):
            for k in ("lr", "hr", "bc"):
                out[k] = np.ascontiguousarray(out[k][:, ::-1])
        return out


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
