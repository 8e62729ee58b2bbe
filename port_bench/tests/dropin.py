"""A configuration that a later change could add as new files and manifest
entries alone: the program's EDSR x4 with a pixel-only L1 recipe, its own
plain reference module, a traffic mix, limits and a train and a serve
cell."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

from port_bench.tests.tiny import tiny_widths

EDSR_REFERENCE = '''"""A plain EDSR x4 (Lim et al., CVPR 2017 workshops,
arXiv:1707.02921): a 3x3 conv head, residual blocks of conv, ReLU, conv
without norm, a mid conv with the global skip, the x4 sub-pixel upsample
through one shared conv (LeakyReLU 0.01) and a 3x3 conv out.  Plain
PyTorch over the benchmark's ``Conv``; parameter names as the program's
state dict."""

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.models import Conv, upsample_x4

TINY_WIDTHS = {"base_filters": 8, "num_residuals": 2}


class ConvLayer(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.conv = Conv(c_in, c_out, 3, padding=1)

    def forward(self, x):
        return self.conv(x)


class ResBlock(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv1 = Conv(f, f, 3, padding=1)
        self.conv2 = Conv(f, f, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class EDSR(nn.Module):
    def __init__(self, base_filters=256, num_residuals=32):
        super().__init__()
        f = base_filters
        self.input_conv = ConvLayer(3, f)
        self.residual_layers = nn.Sequential(
            *(ResBlock(f) for _ in range(num_residuals)))
        self.mid_conv = ConvLayer(f, f)
        self.upsampling = nn.Module()
        self.upsampling.add_module("0", Conv(f, 4 * f, 3, padding=1))
        self.output_conv = ConvLayer(f, 3)

    def forward(self, x):
        x = self.input_conv(x)
        x = self.mid_conv(self.residual_layers(x)) + x
        up = upsample_x4(getattr(self.upsampling, "0"), x)
        return self.output_conv(up)


def build(device, **widths):
    with torch.device("meta"):
        model = EDSR(**widths)
    return model.to_empty(device=device)
'''

CONFIG = {
    "name": "edsr_x4", "source": "https://arxiv.org/abs/1707.02921",
    "model": "edsr", "scale": 4,
    "widths": {"base_filters": 256, "num_residuals": 32},
    "reference": "reference/edsr.py",
    "recipe": {"gan": "none", "pixel": "l1", "lr": 1e-4,
               "betas": [0.9, 0.999], "eps": 1e-8},
    "precision": {"train_bf16": False, "serve_dtype": "float32"},
    "reduced": []}
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap_g": 1e-3, "change_gap": 0.05,
                "change1_gap_worst": 0.5}
SERVE_LIMITS = {"output_gap": 1e-4}
TRAIN_CELL, SERVE_CELL = "edsr_x4.train_b2", "edsr_x4.serve_ucm"
TRAIN_METRICS = ("feed_wait.train", "mfu.train", "device_idle.train")
SERVE_METRICS = ("mfu.serve", "device_idle.serve")


def add_edsr(manifest: Path) -> Tuple[str, str]:
    """Into the tiny copy whose manifest is ``manifest``, the EDSR
    configuration at its tiny widths (the reference module's), a train mix
    of its own, limits and a train and a serve cell, by new files and
    appended manifest entries alone; returns the two cells' names."""
    bench = manifest.parent / "port_bench"
    (bench / "reference" / "edsr.py").write_text(EDSR_REFERENCE)
    config = dict(CONFIG, widths=tiny_widths(CONFIG, bench))
    (bench / "configs" / "edsr_x4.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "train_b16.json").read_text())
    mix.update(batch=2, lr_size=6)
    (bench / "traffic" / "train_b2.json").write_text(json.dumps(mix))
    (bench / "limits" / f"{TRAIN_CELL}.json").write_text(
        json.dumps(TRAIN_LIMITS))
    (bench / "limits" / f"{SERVE_CELL}.json").write_text(
        json.dumps(SERVE_LIMITS))

    m = json.loads(manifest.read_text())
    m["configs"].append({"name": "edsr_x4", "source": CONFIG["source"],
                         "file": "port_bench/configs/edsr_x4.json",
                         "reduced": [], "why": "a pixel-only drop-in"})
    m["workloads"] += [
        {"name": TRAIN_CELL, "config": "edsr_x4", "traffic": "train_b2",
         "chips": 1, "why": "a pixel-only drop-in"},
        {"name": SERVE_CELL, "config": "edsr_x4", "traffic": "ucm_test",
         "chips": 1, "why": "a pixel-only drop-in"}]
    cells = {"train_mpix_s": TRAIN_CELL, "serve_mpix_s": SERVE_CELL,
             "request_p95_ms": SERVE_CELL}
    cells.update({k: TRAIN_CELL for k in TRAIN_METRICS})
    cells.update({k: SERVE_CELL for k in SERVE_METRICS})
    for e in m["end_to_end"] + m["per_layer"]:
        if e["name"] in cells:
            e["workloads"].append(cells[e["name"]])
    manifest.write_text(json.dumps(m))
    return TRAIN_CELL, SERVE_CELL
