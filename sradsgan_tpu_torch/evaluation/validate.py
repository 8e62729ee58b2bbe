"""The reference's evaluation protocol: ``mfeNew_validate``,
``mfeNew_validateByClass`` and ``mfe_test_single``.

Counterpart of ``sradsgan_tpu/evaluation/validate.py`` (the reference's
``model/sradsgan.py:1258-1639``), the surface the published tables come
from.  Each image's SR and its bicubic twin are truncated to uint8 as
``ToPILImage`` does and scored against HR with MSE, PSNR, SSIM
(multichannel) and ERGAS (variant 2, HR first) on the host, by the numpy
tier of ``metrics/fidelity.py``; LPIPS, where asked for, on the device.
Per-class means over the sorted class dirs, then a ``"Total"`` row.

The pipeline: the host loader decodes, the generator runs in batches on the
device (no tail padding: that was an XLA recompile guard, and eager
PyTorch has nothing to recompile), LPIPS scores the raw, unclipped SR of
each batch on the device, and the uint8 metrics run on the host.  Images
and panels are written only on request; Pillow and matplotlib are imported
only there (``utils/plotting.py``).
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from sradsgan_tpu_torch.data.datasets import (build_test_dataset,
                                              scan_class_dirs)
from sradsgan_tpu_torch.data.loader import DataLoader
from sradsgan_tpu_torch.metrics.fidelity import (compare_ergas, compare_mse,
                                                 compare_psnr, compare_ssim,
                                                 tensor_to_uint8)
# importable from here as well, as in the JAX package
from sradsgan_tpu_torch.utils.plotting import (  # noqa: F401
    plot_test_panel, save_image)

MetricRow = Dict[str, float]


def _score_pair(sr01: np.ndarray, hr01: np.ndarray,
                scale: int) -> MetricRow:
    """uint8-protocol metrics of one HWC image pair (``sradsgan.py:1484-
    1496``; LPIPS is scored apart, batched on the device)."""
    sr_u8 = tensor_to_uint8(sr01)
    hr_u8 = tensor_to_uint8(hr01)
    return {
        "mse": compare_mse(sr_u8, hr_u8),
        "psnr": compare_psnr(sr_u8, hr_u8),
        "ssim": compare_ssim(sr_u8, hr_u8),
        "ergas": compare_ergas(hr_u8, sr_u8, scale=scale),
    }


def _mean_rows(rows: List[MetricRow]) -> MetricRow:
    if not rows:
        return {}
    keys = rows[0].keys()
    return {k: float(np.mean([r[k] for r in rows])) for k in keys}


def _nchw(batch: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(batch.transpose(0, 3, 1, 2)))
    return x.to(device=device, dtype=dtype)


class _Clock:
    """Seconds between two marks: on a card, CUDA events on the stream
    (read once the host has copied the batch's results back, so the stream
    has passed both); on the CPU, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def seconds(self, start, end) -> float:
        return start.elapsed_time(end) / 1e3 if self.cuda else end - start


class Evaluator:
    """The eval generator in batches on ``device``, LPIPS beside it, the
    protocol metrics on the host.

    ``lpips_fn``: what ``losses.lpips.lpips_fn(net)`` returns; the Evaluator
    runs its ``batched`` form on the device, a whole batch in one call,
    where the reference scores each image alone (``sradsgan.py:1489``).
    After :meth:`run`, ``stats`` holds the sweep's seconds by part: ``wall``
    (host clock, the whole sweep), ``feed`` (the host waiting on the
    loader), ``forward`` (the stream's time from the copy in to the end of
    the generator), ``lpips`` (the stream's time over the LPIPS calls;
    both by CUDA events on a card) and ``score`` (host time of
    the uint8 metrics and of any images written), with ``images`` and
    ``batches``."""

    def __init__(self, generator: nn.Module, scale: int,
                 lpips_fn: Optional[Callable] = None, batch_size: int = 8,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32):
        self.generator = generator.to(device).eval()
        self.scale = scale
        self.lpips_fn = lpips_fn
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.dtype = dtype
        self.stats: Dict[str, float] = {}

    @torch.inference_mode()
    def _sr(self, lr_batch: np.ndarray) -> torch.Tensor:
        """(B, H, W, C) float [0, 1] -> (B, C, sH, sW) float32 on the
        device, the batch forwarded as it is."""
        return self.generator(_nchw(lr_batch, self.device,
                                    self.dtype)).float()

    def super_resolve(self, lr_batch: np.ndarray) -> np.ndarray:
        """(B, H, W, C) float [0, 1] -> (B, sH, sW, C) float32."""
        return self._sr(lr_batch).permute(0, 2, 3, 1).cpu().numpy()

    def run(self, dataset, save_img: bool = False,
            save_dir: Optional[str] = None,
            class_of: Optional[Callable[[str], str]] = None):
        """Score a dataset; returns an OrderedDict class -> {"sr": [row per
        image], "bc": [row per image]} in the dataset's order (class
        ``"all"`` without ``class_of``)."""
        loader = DataLoader(dataset, self.batch_size, shuffle=False,
                            drop_last=False, num_workers=4)
        clock = _Clock(self.device)
        per_class: "OrderedDict[str, Dict[str, List[MetricRow]]]" = \
            OrderedDict()
        stats = dict.fromkeys(("feed", "forward", "lpips", "score"), 0.0)
        stats.update(images=0, batches=0)
        t_start = time.perf_counter()
        batches = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            stats["feed"] += time.perf_counter() - t0
            if batch is None:
                break
            marks = [clock.mark()]
            sr_t = self._sr(batch["lr"])
            marks.append(clock.mark())
            lp = []
            if self.lpips_fn is not None:
                hr_t = _nchw(batch["hr"], self.device)
                lp = [self.lpips_fn.batched(sr_t, hr_t),
                      self.lpips_fn.batched(_nchw(batch["bc"], self.device),
                                            hr_t)]
            marks.append(clock.mark())
            sr = sr_t.permute(0, 2, 3, 1).cpu().numpy()
            lp_sr, lp_bc = ([t.cpu().numpy() for t in lp] if lp
                            else (None, None))
            stats["forward"] += clock.seconds(marks[0], marks[1])
            stats["lpips"] += clock.seconds(marks[1], marks[2])
            t0 = time.perf_counter()
            for i, path in enumerate(batch["path"]):
                cls = class_of(path) if class_of else "all"
                slot = per_class.setdefault(cls, {"sr": [], "bc": []})
                slot["sr"].append(_score_pair(sr[i], batch["hr"][i],
                                              self.scale))
                slot["bc"].append(_score_pair(batch["bc"][i], batch["hr"][i],
                                              self.scale))
                if lp_sr is not None:
                    slot["sr"][-1]["lpips"] = float(lp_sr[i])
                    slot["bc"][-1]["lpips"] = float(lp_bc[i])
                if save_img and save_dir:
                    name = os.path.splitext(os.path.basename(path))[0]
                    save_image(sr[i], os.path.join(
                        save_dir, cls, f"SR_{name}_x{self.scale}.png"))
                    plot_test_panel(
                        [batch["hr"][i], batch["lr"][i], batch["bc"][i],
                         sr[i]],
                        ["HR", "LR", "Bicubic", "SR"],
                        [None, None, slot["bc"][-1], slot["sr"][-1]],
                        os.path.join(save_dir, cls,
                                     f"panel_{name}_x{self.scale}.png"))
            stats["score"] += time.perf_counter() - t0
            stats["images"] += len(batch["path"])
            stats["batches"] += 1
        stats["wall"] = time.perf_counter() - t_start
        self.stats = stats
        return per_class


def mfe_new_validate(generator: nn.Module, data_cfg, scale: int,
                     lpips_fn=None, save_img: bool = False,
                     save_dir: Optional[str] = None, batch_size: int = 8,
                     device: torch.device | str = "cuda",
                     dtype: torch.dtype = torch.float32
                     ) -> Dict[str, MetricRow]:
    """Whole-test-set means, ``{"sr": row, "bicubic": row}`` (the
    reference's ``mfeNew_validate``, ``sradsgan.py:1258-1391``)."""
    dataset = build_test_dataset(data_cfg, scale)
    ev = Evaluator(generator, scale, lpips_fn, batch_size, device, dtype)
    per_class = ev.run(dataset, save_img, save_dir)
    rows_sr = [r for c in per_class.values() for r in c["sr"]]
    rows_bc = [r for c in per_class.values() for r in c["bc"]]
    return {"sr": _mean_rows(rows_sr), "bicubic": _mean_rows(rows_bc)}


def mfe_new_validate_by_class(generator: nn.Module, data_cfg, scale: int,
                              lpips_fn=None, save_img: bool = False,
                              save_dir: Optional[str] = None,
                              batch_size: int = 8,
                              device: torch.device | str = "cuda",
                              dtype: torch.dtype = torch.float32,
                              stats: Optional[dict] = None):
    """Per-class tables and their Total (the reference's
    ``mfeNew_validateByClass``, ``sradsgan.py:1393-1601``): an OrderedDict
    class -> {"sr": mean row, "bicubic": mean row}, the classes in sorted
    order (the synthetic set is one class, ``"all"``), ``"Total"`` last.
    ``stats``, where given, receives the sweep's :attr:`Evaluator.stats`."""
    if data_cfg.synthetic:
        dataset = build_test_dataset(data_cfg, scale)
        class_of = None
    else:
        root = os.path.join(data_cfg.data_dir, data_cfg.test_dataset)
        dataset = build_test_dataset(
            data_cfg, scale, [p for _, p in scan_class_dirs(root)])
        class_of = lambda p: os.path.basename(os.path.dirname(p))  # noqa

    ev = Evaluator(generator, scale, lpips_fn, batch_size, device, dtype)
    per_class = ev.run(dataset, save_img, save_dir, class_of)
    if stats is not None:
        stats.update(ev.stats)

    table: "OrderedDict[str, Dict[str, MetricRow]]" = OrderedDict()
    all_sr: List[MetricRow] = []
    all_bc: List[MetricRow] = []
    for cls, rows in per_class.items():
        table[cls] = {"sr": _mean_rows(rows["sr"]),
                      "bicubic": _mean_rows(rows["bc"])}
        all_sr.extend(rows["sr"])
        all_bc.extend(rows["bc"])
    table["Total"] = {"sr": _mean_rows(all_sr), "bicubic": _mean_rows(all_bc)}
    return table


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
    sr01 = Evaluator(generator, scale, device=device,
                     dtype=dtype).super_resolve(lr01[None])[0]

    os.makedirs(save_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(image_path))[0]
    out = {"sr": os.path.join(save_dir, f"SR_{name}_x{scale}.png"),
           "bicubic": os.path.join(save_dir, f"Bicubic_{name}_x{scale}.png")}
    save_image(sr01, out["sr"])
    save_image(bc01, out["bicubic"])
    panel = os.path.join(save_dir, f"panel_{name}_x{scale}.png")
    if plot_test_panel([lr01, bc01, np.clip(sr01, 0, 1)],
                       ["LR input", "Bicubic", "SR"], None, panel):
        out["panel"] = panel
    return out


def save_by_class_csv(table, path: str) -> None:
    """The per-class table as CSV (the published-table layout): a column
    per metric, ``sr_`` then ``bc_``, in sorted key order, six decimals."""
    import csv
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keys = None
    with open(path, "w", newline="") as f:
        writer = None
        for cls, row in table.items():
            if not row["sr"]:
                continue
            if keys is None:
                keys = sorted(row["sr"].keys())
                writer = csv.writer(f)
                writer.writerow(["class"] + [f"sr_{k}" for k in keys]
                                + [f"bc_{k}" for k in keys])
            writer.writerow([cls] + [f"{row['sr'][k]:.6f}" for k in keys]
                            + [f"{row['bicubic'][k]:.6f}" for k in keys])


def format_by_class_table(table) -> str:
    """The per-class table as text (``val_log.txt`` style): PSNR, SSIM and
    ERGAS of the SR, PSNR and SSIM of the bicubic twin."""
    lines = []
    header = (f"{'class':<22} {'PSNR':>8} {'SSIM':>8} {'ERGAS':>8} "
              f"{'bcPSNR':>8} {'bcSSIM':>8}")
    lines.append(header)
    for cls, row in table.items():
        sr, bc = row["sr"], row["bicubic"]
        if not sr:
            continue
        lines.append(
            f"{cls:<22} {sr['psnr']:>8.4f} {sr['ssim']:>8.4f} "
            f"{sr['ergas']:>8.4f} {bc['psnr']:>8.4f} {bc['ssim']:>8.4f}")
    return "\n".join(lines)
