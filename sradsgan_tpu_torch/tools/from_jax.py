"""Move SRADSGAN weights from the JAX package to the port.

:func:`sradsgan_state_dict` is the inverse of
``sradsgan_tpu/tools/import_reference.py:import_sradsgan``: it takes the JAX
generator's param tree (nested dicts of arrays) and returns the port's
``state_dict``.  :func:`discriminator_state_dict` does the same for the CBAM
patch discriminator (params and BatchNorm ``batch_stats``; the inverse of
``import_patch_discriminator``), and :func:`vgg19_state_dict` for the VGG19
content features (the JAX param tree, or the ``.npz`` of
``SRADSGAN_TPU_VGG19_NPZ`` read with :func:`load_npz`), and
:func:`lpips_state_dict` for LPIPS (its trunk, as the ``.npz`` of
``SRADSGAN_TPU_{ALEXNET,VGG16,SQUEEZENET}_NPZ`` holds it, and its heads).
Conv kernels go HWIO -> OIHW, the CLAM's Dense kernels (in, out) ->
bias-free 1x1 convs (out, in, 1, 1), the SLAM kernel (7, 7, 2, 1) -> (1, 2,
7, 7) with plane 0 the channel mean and plane 1 the channel max, and each
``gamma`` stays (1,).  The upsample conv is shared by
every stage, so it maps once.

A machine that serves the port needs no JAX or orbax, so JAX weights reach
it as ``.npz``: :func:`save_npz` on the JAX side writes the param tree with
``/``-joined keys, :func:`load_npz` reads it back as nested dicts.  Neither
needs JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from sradsgan_tpu_torch.losses.lpips import NETS as LPIPS_NETS
from sradsgan_tpu_torch.losses.vgg import LAYERS as VGG_LAYERS
from sradsgan_tpu_torch.models.discriminators import (ATTENTION_AFTER,
                                                      DEFAULT_BLOCKS)

Tree = Mapping[str, Any]


def _oihw(kernel) -> np.ndarray:
    """HWIO conv kernel -> OIHW weight."""
    return np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))


def _dense_as_conv(kernel) -> np.ndarray:
    """Dense (in, out) kernel -> 1x1 conv weight (out, in, 1, 1)."""
    return np.asarray(kernel, np.float32).T[:, :, None, None]


def _count(tree: Tree, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def sradsgan_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``SRADSGANGenerator`` params (or ``{"params": ...}``) -> the
    port's ``SRADSGANGenerator`` state dict, float32 on the CPU."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, np.ndarray] = {}

    def conv(name: str, node: Tree, bias: bool = True) -> None:
        sd[f"{name}.weight"] = _oihw(node["kernel"])
        if bias:
            sd[f"{name}.bias"] = np.asarray(node["bias"], np.float32)

    def local_attention(prefix: str, node: Tree) -> None:
        gate = node["ChannelGate_0"]
        sd[f"{prefix}.ca.fc1.weight"] = _dense_as_conv(
            gate["Dense_0"]["kernel"])
        sd[f"{prefix}.ca.fc2.weight"] = _dense_as_conv(
            gate["Dense_1"]["kernel"])
        conv(f"{prefix}.sa.conv1", node["SpatialGate_0"]["Conv_0"], bias=False)
        conv(f"{prefix}.conv", node["Conv_0"])

    conv("conv1.0", params["Conv_0"])
    msb = params["MSB_0"]
    for name, jax_name in (("conv1", "Conv_0"), ("conv2.0", "Conv_1"),
                           ("conv2.1", "Conv_2"), ("conv3", "Conv_3"),
                           ("conv", "Conv_4")):
        conv(f"MSB.{name}", msb[jax_name])
    for g in range(_count(params, "ResGroup_")):
        group = params[f"ResGroup_{g}"]
        for b in range(_count(group, "RAB_")):
            rab = group[f"RAB_{b}"]
            prefix = f"res_groups.{g}.RG.{b}"
            conv(f"{prefix}.conv1", rab["Conv_0"])
            conv(f"{prefix}.conv2", rab["Conv_1"])
            local_attention(prefix, rab["LocalAttention_0"])
        local_attention(f"res_groups.{g}", group["LocalAttention_0"])
    ga = params["GlobalAttention_0"]
    sd["GAB_UP.ca.gamma"] = np.asarray(ga["ChannelSelfAttention_0"]["gamma"],
                                       np.float32)
    sgam = ga["SpatialSelfAttention_0"]
    for i, name in enumerate(("query_conv", "key_conv", "value_conv")):
        conv(f"GAB_UP.sa.{name}", sgam[f"Conv_{i}"])
    sd["GAB_UP.sa.gamma"] = np.asarray(sgam["gamma"], np.float32)
    conv("GAB_UP.conv", ga["Conv_0"])
    conv("GAB_UP.upsampling.0", params["UpsampleHead_0"]["Conv_0"])
    conv("conv3.0", params["ConvBlock_0"]["Conv_0"])
    return _as_tensors(sd)


def _as_tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v))  # a writable copy
            for k, v in sd.items()}


def discriminator_state_dict(
        variables: Tree,
        blocks: Sequence[Tuple[int, int, bool]] = DEFAULT_BLOCKS
) -> Dict[str, torch.Tensor]:
    """JAX ``PatchDiscriminator`` variables (``{"params", "batch_stats"}``)
    -> the port's ``PatchDiscriminator`` state dict: convs OIHW, BatchNorm
    scale and bias as weight and bias with their running mean and variance,
    the CBAM's Dense kernels as 1x1 convs and its gate kernel as (1, 2, 7,
    7).  The walk follows the port's flat ``model`` Sequential."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    seq = conv_i = bn_i = 0

    def conv(node: Tree) -> None:
        nonlocal seq
        sd[f"model.{seq}.weight"] = _oihw(node["kernel"])
        sd[f"model.{seq}.bias"] = f32(node["bias"])
        seq += 1

    for i, (_, _, normalize) in enumerate(blocks, 1):
        conv(params[f"Conv_{conv_i}"])
        conv_i += 1
        if normalize:
            name = f"BatchNorm_{bn_i}"
            sd[f"model.{seq}.weight"] = f32(params[name]["scale"])
            sd[f"model.{seq}.bias"] = f32(params[name]["bias"])
            sd[f"model.{seq}.running_mean"] = f32(stats[name]["mean"])
            sd[f"model.{seq}.running_var"] = f32(stats[name]["var"])
            sd[f"model.{seq}.num_batches_tracked"] = np.array(0, np.int64)
            seq += 1
            bn_i += 1
        seq += 1  # LeakyReLU
        if i == ATTENTION_AFTER:
            gate = params["ChannelGate_0"]
            sd[f"model.{seq}.fc1.weight"] = _dense_as_conv(
                gate["Dense_0"]["kernel"])
            sd[f"model.{seq}.fc2.weight"] = _dense_as_conv(
                gate["Dense_1"]["kernel"])
            sd[f"model.{seq + 1}.conv1.weight"] = _oihw(
                params["SpatialGate_0"]["Conv_0"]["kernel"])
            seq += 2
    conv(params[f"Conv_{conv_i}"])
    return _as_tensors(sd)


def vgg19_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``VGG19Features`` params (``{conv1_1: {kernel, bias}, ...}``, or
    ``{"params": ...}``) -> the port's ``VGG19Features`` state dict
    (torchvision's ``features.{index}`` names)."""
    if "params" in params:
        params = params["params"]
    sd = {}
    for name, index, *_ in VGG_LAYERS:
        sd[f"features.{index}.weight"] = _oihw(params[name]["kernel"])
        sd[f"features.{index}.bias"] = np.asarray(params[name]["bias"],
                                                  np.float32)
    return _as_tensors(sd)


def lpips_state_dict(params: Tree, net: str) -> Dict[str, torch.Tensor]:
    """JAX ``LPIPS(net)`` params (or ``{"params": ...}``) -> the port's
    ``LPIPS`` state dict: the trunk's convs under ``net.`` (the flax names
    ``conv{i}`` and ``fire{i}/{squeeze,expand1x1,expand3x3}`` are the port's
    module names, kernels HWIO -> OIHW) and the heads ``lin{i}``.  Either
    part may be missing: the loader of the trunk files passes the trunk
    alone under its scope, the bundled heads alone come without one."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, np.ndarray] = {}

    def walk(node: Tree, path: str) -> None:
        if "kernel" in node:
            sd[f"net.{path}.weight"] = _oihw(node["kernel"])
            sd[f"net.{path}.bias"] = np.asarray(node["bias"], np.float32)
            return
        for key, child in node.items():
            walk(child, f"{path}.{key}" if path else key)

    walk(params.get(LPIPS_NETS[net][2], {}), "")
    for key, value in params.items():
        if key.startswith("lin"):
            sd[key] = np.asarray(value, np.float32)
    return _as_tensors(sd)


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays -> {"a/b/c": array}."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def save_npz(path: str, tree: Tree) -> None:
    """Write a param tree as an ``.npz`` with ``/``-joined keys."""
    np.savez(path, **_flatten(tree))


def load_npz(path: str) -> Dict[str, Any]:
    """Read an ``.npz`` written by :func:`save_npz` back as nested dicts."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree
