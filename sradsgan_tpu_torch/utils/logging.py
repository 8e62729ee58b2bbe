"""Training and validation logs: formatted text, a stdout tee and
TensorBoard.

Counterpart of ``sradsgan_tpu/utils/logging.py``: ``loss_log.txt`` and
``val_log.txt`` formatted lines, ``print_log.txt``, and TensorBoard
scalars, images and histograms through tensorboardX, which is imported
only where a :class:`Logger` asks for it; without it (or without Pillow,
which its image summaries need) those sinks do nothing.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict

import numpy as np


class PrintLogger:
    """Tee stdout to ``print_log.txt``: assign it to ``sys.stdout`` and
    :meth:`close` it when done."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.terminal = sys.stdout
        self.log = open(os.path.join(log_dir, "print_log.txt"), "a")

    def write(self, message: str) -> None:
        self.terminal.write(message)
        self.log.write(message)

    def flush(self) -> None:
        self.terminal.flush()
        self.log.flush()

    def close(self) -> None:
        self.log.close()


class Logger:
    """Formatted train and val lines, one per event, printed and appended
    to ``loss_log.txt`` / ``val_log.txt`` under ``log_dir`` (made at the
    first line), and, with ``use_tensorboard``, a tensorboardX event file
    in ``log_dir`` that the ``*_summary`` sinks write (``writer`` is None
    where tensorboardX does not import).  :meth:`close` writes out what
    the event file holds; a later summary opens a new one."""

    def __init__(self, model_name: str, log_dir: str,
                 use_tensorboard: bool = True):
        self.model_name = model_name
        self.log_dir = log_dir
        self.loss_log = os.path.join(log_dir, "loss_log.txt")
        self.val_log = os.path.join(log_dir, "val_log.txt")
        self.use_tensorboard = use_tensorboard
        self.writer = None
        self._open()

    def _open(self):
        """The event file's writer, opened where there is none yet; None
        without tensorboardX."""
        if self.writer is None and self.use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                self.use_tensorboard = False
                return None
            self.writer = SummaryWriter(self.log_dir)
        return self.writer

    def scalar_summary(self, tag: str, value: float, step: int) -> None:
        if self._open() is not None:
            self.writer.add_scalar(tag, value, step)

    def image_summary(self, tag: str, images01, step: int) -> None:
        """One picture a tag ``{tag}/{i}``: each HWC float image in [0, 1]
        as uint8 CHW (reference utils/logger.py:64-87).  tensorboardX
        encodes it with Pillow: without Pillow nothing is written, and a
        note goes to stderr."""
        if self._open() is None:
            return
        try:
            import PIL  # noqa: F401
        except ImportError:
            print(f"image_summary({tag!r}): Pillow does not import here; "
                  "no image written", file=sys.stderr)
            return
        for i, img in enumerate(images01):
            arr = (np.clip(np.asarray(img, np.float32), 0, 1)
                   * 255).astype(np.uint8)
            self.writer.add_image(f"{tag}/{i}", arr.transpose(2, 0, 1), step)

    def histo_summary(self, tag: str, values, step: int,
                      max_values: int = 100_000) -> None:
        """A histogram of ``values`` (reference utils/logger.py:89-115),
        more than ``max_values`` of them subsampled to bound the event
        file."""
        if self._open() is None:
            return
        vals = np.asarray(values).ravel()
        if vals.size > max_values:
            vals = vals[:: vals.size // max_values + 1]
        self.writer.add_histogram(tag, vals, step)

    def close(self) -> None:
        """Write every pending event to disk and close the event file."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    def print_format_results(self, mode: str,
                             results: Dict[str, object]) -> None:
        parts = [f"{k}: {v:.6f}" if isinstance(v, float) else f"{k}: {v}"
                 for k, v in results.items()]
        line = f"{time.strftime('%y-%m-%d %H:%M:%S')} [{self.model_name}] " \
               + " ".join(parts)
        os.makedirs(self.log_dir, exist_ok=True)
        path = self.val_log if mode == "val" else self.loss_log
        with open(path, "a") as f:
            f.write(line + "\n")
        print(line)
