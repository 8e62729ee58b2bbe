"""Convert PyTorch checkpoints to the weight files the two packages read,
without JAX.

Counterpart of ``sradsgan_tpu/tools/convert_torch.py``, with its command
line and its output, key for key and bit for bit:

1. ``vgg19``: torchvision ``vgg19-dcbb9e9d.pth`` -> the ``.npz`` of the
   VGG19 content features (``SRADSGAN_TPU_VGG19_NPZ``);
2. ``alexnet``: torchvision ``alexnet-owt-*.pth`` -> the LPIPS alex trunk
   (``SRADSGAN_TPU_ALEXNET_NPZ``);
3. ``vgg16``: torchvision ``vgg16-*.pth`` -> the LPIPS vgg trunk
   (``SRADSGAN_TPU_VGG16_NPZ``);
4. ``squeezenet``: torchvision ``squeezenet1_1-*.pth`` -> the LPIPS squeeze
   trunk (``SRADSGAN_TPU_SQUEEZENET_NPZ``);
5. ``generator``: a reference ``generator_param*.pkl`` state dict -> an
   ``.npz`` of its tensors under their own names, convs HWIO and linear
   weights (in, out) (``tools/from_reference.py`` loads such a state dict
   into the port directly).

The trunk files hold ``{layer}/kernel`` (HWIO) and ``{layer}/bias`` under
the JAX trunks' layer names.  :func:`torchvision_state_dict` maps a
torchvision state dict straight onto the port's trunk (``VGG19Features``,
or the ``AlexNetFeatures``, ``VGG16Features`` and ``SqueezeNetFeatures`` of
LPIPS), which is how ``losses.vgg.load_vgg19`` and ``losses.lpips.load_lpips``
read a ``.pth`` where the path or the variable names one.

    python -m sradsgan_tpu_torch.tools.convert_torch vgg19 vgg19.pth vgg19.npz
"""

from __future__ import annotations

import sys
from typing import Dict, Mapping

import numpy as np
import torch

KINDS = ("vgg19", "alexnet", "vgg16", "squeezenet", "generator")

# torchvision ``features`` index -> the trunk's layer name
_VGG19_FEATURE_IDS = {0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2",
                      10: "conv3_1"}
_ALEXNET_FEATURE_IDS = {0: "conv0", 3: "conv1", 6: "conv2", 8: "conv3",
                        10: "conv4"}
# the 13 convs of vgg16 (taps at relu1_2/2_2/3_3/4_3/5_3)
_VGG16_FEATURE_IDS = {idx: f"conv{i}" for i, idx in enumerate(
    (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28))}
# squeezenet1_1: a conv at 0, the eight fire modules at these indices
_SQUEEZE_FIRE_IDS = (3, 4, 6, 7, 9, 10, 11, 12)
_FIRE_PARTS = ("squeeze", "expand1x1", "expand3x3")
_FEATURE_TABLES = {"vgg19": _VGG19_FEATURE_IDS,
                   "alexnet": _ALEXNET_FEATURE_IDS,
                   "vgg16": _VGG16_FEATURE_IDS}


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's state dict (or an object's ``.state_dict()``)
    as numpy arrays."""
    state = torch.load(path, map_location="cpu")
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return {k: v.numpy() for k, v in state.items()}


def _layers(kind: str) -> Dict[str, str]:
    """The trunk's layer name -> the torchvision module that holds it."""
    if kind == "squeezenet":
        out = {"conv0": "features.0"}
        for j, idx in enumerate(_SQUEEZE_FIRE_IDS):
            for part in _FIRE_PARTS:
                out[f"fire{j}/{part}"] = f"features.{idx}.{part}"
        return out
    return {name: f"features.{idx}"
            for idx, name in _FEATURE_TABLES[kind].items()}


def _trunk_arrays(kind: str, state: Mapping[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
    """The ``.npz`` contents of a torchvision trunk: ``{layer}/kernel``
    (HWIO float32) and ``{layer}/bias``, in the JAX converter's order."""
    npz = {}
    for name, module in _layers(kind).items():
        npz[f"{name}/kernel"] = _oihw_to_hwio(
            state[f"{module}.weight"]).astype(np.float32)
        npz[f"{name}/bias"] = state[f"{module}.bias"].astype(np.float32)
    return npz


def _generator_arrays(state: Mapping[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """A reference state dict with convs HWIO, 2-D weights transposed and
    everything float32, under its own keys."""
    npz = {}
    for key, val in state.items():
        if val.ndim == 4:
            npz[key] = _oihw_to_hwio(val).astype(np.float32)
        elif val.ndim == 2:
            npz[key] = val.T.astype(np.float32)
        else:
            npz[key] = val.astype(np.float32)
    return npz


def torchvision_state_dict(kind: str, state: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """A torchvision state dict of ``kind`` (``vgg19``, ``alexnet``,
    ``vgg16``, ``squeezenet``) -> the state dict of the port's trunk:
    ``VGG19Features`` keeps torchvision's ``features.{index}`` names, the
    LPIPS trunks name their convs ``conv{i}`` and ``fire{j}.{part}``.
    Float32 copies on the CPU; a missing key raises ``KeyError``."""
    if kind not in _FEATURE_TABLES and kind != "squeezenet":
        raise ValueError(f"no torchvision trunk {kind!r}; have "
                         f"{sorted(_FEATURE_TABLES) + ['squeezenet']}")
    out = {}
    for name, module in _layers(kind).items():
        target = module if kind == "vgg19" else name.replace("/", ".")
        for leaf in ("weight", "bias"):
            out[f"{target}.{leaf}"] = torch.as_tensor(
                state[f"{module}.{leaf}"]).detach().to(torch.float32,
                                                       copy=True)
    return out


def main(argv=None) -> int:
    argv = argv or sys.argv[1:]
    if len(argv) != 3 or argv[0] not in KINDS:
        print(__doc__)
        return 1
    kind, src, dst = argv
    state = _load_torch_state(src)
    if kind == "generator":
        npz = _generator_arrays(state)
    else:
        npz = _trunk_arrays(kind, state)
    np.savez(dst, **npz)
    print(f"wrote {dst}: {len(npz)} tensors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
