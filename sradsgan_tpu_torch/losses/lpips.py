"""LPIPS perceptual similarity (net-lin over alex / vgg / squeeze), the
evaluation protocol's fifth metric.

Counterpart of ``sradsgan_tpu/losses/lpips.py``, in NCHW.  Inputs in
[0, 1] are mapped to [-1, 1], shifted and scaled by the LPIPS v0.1
constants, run through a feature trunk whose post-ReLU maps are tapped;
each tap is normalized over channels (``x / (||x|| + 1e-10)``), the squared
difference of the two images' taps is weighted by the calibrated head
``lin{i}`` and summed over channels, averaged over space, and the taps'
scores are summed: one value per image.  Trunks: AlexNet (5 taps, the
default), VGG16 (relu{1_2,2_2,3_3,4_3,5_3}) and SqueezeNet 1.1 (7 taps).

Weights.  The calibrated heads ship with the port
(``losses/weights/lpips_{alex,vgg,squeeze}_v01.npz``, copies of the JAX
package's).  The trunk weights come from the ``.npz`` that
``SRADSGAN_TPU_{ALEXNET,VGG16,SQUEEZENET}_NPZ`` names, the same files the
JAX package reads (its flax layout, HWIO kernels; converted by
``tools/from_jax.py:lpips_state_dict``), or from torchvision's ``.pth``
itself where the variable names one
(``tools/convert_torch.py:torchvision_state_dict``).  Without one the trunk
is drawn from a seeded LeCun-normal init: the score is then a
self-consistent perceptual distance but not the published metric, and the
evaluation marks it ``lpips*``.  That seeded trunk is not the JAX
package's seeded trunk (the two draw from different generators), so
uncalibrated scores of the two packages differ; with the same trunk
weights they agree.

LPIPS always runs in float32, also when it is called under the trainer's
bfloat16 autocast, as the JAX package runs it with ``dtype=None``.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ALEXNET_WEIGHTS_ENV = "SRADSGAN_TPU_ALEXNET_NPZ"
VGG16_WEIGHTS_ENV = "SRADSGAN_TPU_VGG16_NPZ"
SQUEEZENET_WEIGHTS_ENV = "SRADSGAN_TPU_SQUEEZENET_NPZ"
_WEIGHTS_DIR = os.path.join(os.path.dirname(__file__), "weights")
TRUNK_SEED = 12345

# LPIPS v0.1 scaling layer constants (networks_basic.py:94-105).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision AlexNet features: (out_ch, kernel, stride, padding,
# max-pool 3/2 before)
_ALEX_LAYERS = (
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)


class AlexNetFeatures(nn.Module):
    """AlexNet trunk returning the five post-ReLU taps."""

    tap_channels = tuple(layer[0] for layer in _ALEX_LAYERS)

    def __init__(self):
        super().__init__()
        c_in = 3
        for i, (ch, k, s, p, _) in enumerate(_ALEX_LAYERS):
            self.add_module(f"conv{i}", nn.Conv2d(c_in, ch, k, s, p))
            c_in = ch

    def forward(self, x):
        taps = []
        for i, (*_, pool) in enumerate(_ALEX_LAYERS):
            if pool:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(getattr(self, f"conv{i}")(x))
            taps.append(x)
        return taps


_VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16Features(nn.Module):
    """VGG16 trunk returning the five taps relu1_2, relu2_2, relu3_3,
    relu4_3 and relu5_3."""

    tap_channels = tuple(ch for ch, _ in _VGG16_BLOCKS)

    def __init__(self):
        super().__init__()
        c_in, idx = 3, 0
        for ch, n in _VGG16_BLOCKS:
            for _ in range(n):
                self.add_module(f"conv{idx}", nn.Conv2d(c_in, ch, 3,
                                                        padding=1))
                c_in, idx = ch, idx + 1

    def forward(self, x):
        taps, idx = [], 0
        for b, (_, n) in enumerate(_VGG16_BLOCKS):
            if b > 0:
                x = F.max_pool2d(x, 2, 2)
            for _ in range(n):
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            taps.append(x)
        return taps


class _Fire(nn.Module):
    """SqueezeNet fire module: a 1x1 squeeze and ReLU, then 1x1 and 3x3
    expands, each with its ReLU, concatenated over channels."""

    def __init__(self, c_in: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(c_in, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x):
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)),
                          F.relu(self.expand3x3(x))], dim=1)


# squeezenet1_1: (squeeze, expand) per fire module; ceil-mode pools before
# fires 0, 2 and 4; taps after relu1 and after fires 1, 3, 4, 5, 6 and 7.
_SQUEEZE_FIRES = ((16, 64), (16, 64), (32, 128), (32, 128),
                  (48, 192), (48, 192), (64, 256), (64, 256))
_SQUEEZE_POOLS = (0, 2, 4)
_SQUEEZE_TAPS = (1, 3, 4, 5, 6, 7)


class SqueezeNetFeatures(nn.Module):
    """SqueezeNet 1.1 trunk returning the seven taps."""

    tap_channels = (64,) + tuple(2 * _SQUEEZE_FIRES[i][1]
                                 for i in _SQUEEZE_TAPS)

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 64, 3, stride=2)
        c_in = 64
        for i, (sq, ex) in enumerate(_SQUEEZE_FIRES):
            self.add_module(f"fire{i}", _Fire(c_in, sq, ex))
            c_in = 2 * ex

    def forward(self, x):
        x = F.relu(self.conv0(x))
        taps = [x]
        for i in range(len(_SQUEEZE_FIRES)):
            if i in _SQUEEZE_POOLS:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            x = getattr(self, f"fire{i}")(x)
            if i in _SQUEEZE_TAPS:
                taps.append(x)
        return taps


# net -> (trunk class, env var of its weights, the JAX trunk's scope name,
# the torchvision network of a .pth file)
NETS = {
    "alex": (AlexNetFeatures, ALEXNET_WEIGHTS_ENV, "AlexNetFeatures_0",
             "alexnet"),
    "vgg": (VGG16Features, VGG16_WEIGHTS_ENV, "VGG16Features_0", "vgg16"),
    "squeeze": (SqueezeNetFeatures, SQUEEZENET_WEIGHTS_ENV,
                "SqueezeNetFeatures_0", "squeezenet"),
}


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """net-lin LPIPS: ``forward(x, y)`` of two (B, 3, H, W) batches gives
    (B,).  The trunk is ``self.net``; the heads are the buffers ``lin{i}``
    (one weight per tap channel).  Nothing here takes a gradient."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        trunk_cls = NETS[net][0]
        self.net = trunk_cls()
        for i, ch in enumerate(trunk_cls.tap_channels):
            self.register_buffer(f"lin{i}", torch.ones(ch))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                normalize: bool = True) -> torch.Tensor:
        if normalize:  # [0, 1] -> [-1, 1], as the reference always asks
            x = 2.0 * x - 1.0
            y = 2.0 * y - 1.0
        fx = self.net((x - self.shift) / self.scale)
        fy = self.net((y - self.shift) / self.scale)
        total = 0.0
        for i, (tx, ty) in enumerate(zip(fx, fy)):
            d = (_normalize_tensor(tx) - _normalize_tensor(ty)) ** 2
            w = getattr(self, f"lin{i}").view(1, -1, 1, 1)
            total = total + (d * w).sum(dim=1).mean(dim=(1, 2))
        return total


def _seeded_trunk(model: LPIPS, seed: int) -> None:
    """Conv kernels normal(0, 1 / sqrt(fan_in)) and zero biases, drawn on
    the CPU: flax's default (LeCun-normal) scale."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.net.modules():
            if isinstance(m, nn.Conv2d):
                w = torch.randn(m.weight.shape, generator=gen)
                m.weight.copy_(w / m.weight[0].numel() ** 0.5)
                m.bias.zero_()


def _trunk_path(net: str) -> Optional[str]:
    path = os.environ.get(NETS[net][1])
    return path if path and os.path.exists(path) else None


def lpips_is_calibrated(net: str = "alex") -> bool:
    """Whether the trunk's weights file is there (else the score is
    ``lpips*``)."""
    return _trunk_path(net) is not None


def load_lpips(net: str = "alex", device: torch.device | str = "cpu"
               ) -> Tuple[LPIPS, bool]:
    """A fresh float32 :class:`LPIPS` on ``device`` with the bundled heads
    and the trunk of ``SRADSGAN_TPU_*_NPZ`` (else seeded), in eval mode;
    and whether that trunk was calibrated."""
    from sradsgan_tpu_torch.tools.convert_torch import torchvision_state_dict
    from sradsgan_tpu_torch.tools.from_jax import (load_npz,
                                                   lpips_state_dict)

    model = LPIPS(net)
    _seeded_trunk(model, TRUNK_SEED)
    with np.load(os.path.join(_WEIGHTS_DIR, f"lpips_{net}_v01.npz")) as heads:
        tree = {k: heads[k] for k in heads.files}
    path = _trunk_path(net)
    state = model.state_dict()
    if path and path.endswith(".pth"):  # torchvision's own file
        trunk = torchvision_state_dict(NETS[net][3], torch.load(
            path, map_location="cpu", weights_only=True))
        state.update({f"net.{k}": v for k, v in trunk.items()})
    elif path:
        tree[NETS[net][2]] = load_npz(path)
    state.update(lpips_state_dict(tree, net))
    model.load_state_dict(state)
    return model.to(device).eval(), path is not None


@functools.lru_cache(maxsize=6)
def _cached(net: str, device: str) -> LPIPS:
    return load_lpips(net, device)[0]


@torch.no_grad()
def batched_lpips(x: torch.Tensor, y: torch.Tensor,
                  net: str = "alex") -> torch.Tensor:
    """(B, 3, H, W) batches in [0, 1] on any device -> (B,) float32 on that
    device; the model is built once per (net, device) and kept."""
    model = _cached(net, str(x.device))
    with torch.autocast(x.device.type, enabled=False):
        return model(x.float(), y.float())


def lpips_fn(net: str = "alex") -> Callable[[np.ndarray, np.ndarray], float]:
    """Single-pair LPIPS of two HWC float [0, 1] arrays, on the CPU.  The
    callable also carries ``batched`` (:func:`batched_lpips` of that net),
    which ``evaluation.validate.Evaluator`` runs on its device."""
    def call(x01: np.ndarray, y01: np.ndarray) -> float:
        def nchw(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(a, np.float32).transpose(2, 0, 1)))[None]
        return float(batched_lpips(nchw(x01), nchw(y01), net)[0])

    call.batched = functools.partial(batched_lpips, net=net)
    return call
