"""Training and validation text logs, and a stdout tee.

Counterpart of ``sradsgan_tpu/utils/logging.py`` for its text sinks:
``loss_log.txt`` and ``val_log.txt`` formatted lines, and ``print_log.txt``.
TensorBoard scalars, images and histograms are not ported.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict


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
    first line)."""

    def __init__(self, model_name: str, log_dir: str):
        self.model_name = model_name
        self.log_dir = log_dir
        self.loss_log = os.path.join(log_dir, "loss_log.txt")
        self.val_log = os.path.join(log_dir, "val_log.txt")

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
