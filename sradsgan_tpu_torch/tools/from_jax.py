"""Move weights from the JAX package to the port.

One function per network, each the inverse of its reader in
``sradsgan_tpu/tools/import_reference.py``: it takes the JAX param tree
(nested dicts of arrays; for a network with BatchNorm the variables
``{"params", "batch_stats"}``) and returns the port's ``state_dict``.
:func:`generator_state_dict` dispatches on the model's name to
``{sradsgan,edsr,srgan,drcan,dssr,sragan,ndsrgan,amssrn,hat}_state_dict``;
:func:`discriminator_state_dict` covers the patch discriminators (the
inverse of ``import_patch_discriminator``), :func:`unet_state_dict` the
diffusion UNet, :func:`vgg19_state_dict` the
VGG19 content features (the JAX param tree, or the ``.npz`` of
``SRADSGAN_TPU_VGG19_NPZ`` read with :func:`load_npz`), and
:func:`lpips_state_dict` LPIPS (its trunk, as the ``.npz`` of
``SRADSGAN_TPU_{ALEXNET,VGG16,SQUEEZENET}_NPZ`` holds it, and its heads).
The block library's networks have theirs: the VGG-style and spectrally
normalized discriminators (the latter with each conv's ``u`` from the
``spectral`` collection), ``RRDBNet``, ``SRResNet``, ``DeconvBlock`` and
``Upsample2xBlock`` (a transposed conv's kernel flipped, see
:meth:`_StateDict.conv_transpose`), AA-conv and the three feature
extractors; the attention grammar's nodes map whichever submodules a mode
holds (:func:`local_attention_state_dict`).
Conv kernels go HWIO -> OIHW, Dense kernels (in, out) -> 1x1 convs (out,
in, 1, 1) (the reference's attention MLPs are convs) or, where the
reference has a linear layer (HAT's), -> (out, in), LayerNorm scale and
bias -> weight and bias, the SLAM kernel (7,
7, 2, 1) -> (1, 2, 7, 7) with plane 0 the channel mean and plane 1 the
channel max, BatchNorm scale and bias -> weight and bias with the running
mean and variance, a PReLU's alpha -> its weight, and each ``gamma`` stays
(1,).  A conv (or BatchNorm) that the reference shares between upsample
stages maps once.

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
from sradsgan_tpu_torch.models.discriminators import (
    ATTENTION_AFTER, DEFAULT_BLOCKS, GLOBAL_ATTENTION_AFTER)
from sradsgan_tpu_torch.nn.extractors import VGG19_PLAN

Tree = Mapping[str, Any]


def _oihw(kernel) -> np.ndarray:
    """HWIO conv kernel -> OIHW weight."""
    return np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))


def _dense_as_conv(kernel) -> np.ndarray:
    """Dense (in, out) kernel -> 1x1 conv weight (out, in, 1, 1)."""
    return np.asarray(kernel, np.float32).T[:, :, None, None]


def _count(tree: Tree, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


class _StateDict(dict):
    """A port state dict under construction, written from JAX nodes."""

    def conv(self, name: str, node: Tree, bias: bool = True) -> None:
        self[f"{name}.weight"] = _oihw(node["kernel"])
        if bias:
            self[f"{name}.bias"] = _f32(node["bias"])

    def conv_transpose(self, name: str, node: Tree) -> None:
        """Flax ``ConvTranspose`` (kh, kw, in, out) -> the port's
        ``SameConvTranspose2d`` (in, out, kh, kw), flipped in both spatial
        axes: Flax correlates the kernel unflipped, torch flipped."""
        kernel = np.asarray(node["kernel"], np.float32)
        self[f"{name}.weight"] = np.ascontiguousarray(
            kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        self[f"{name}.bias"] = _f32(node["bias"])

    def dense(self, name: str, node: Tree, bias: bool = True) -> None:
        """A Dense layer as the reference's 1x1 conv."""
        self[f"{name}.weight"] = _dense_as_conv(node["kernel"])
        if bias:
            self[f"{name}.bias"] = _f32(node["bias"])

    def linear(self, name: str, node: Tree) -> None:
        """A Dense layer as the reference's linear layer."""
        self[f"{name}.weight"] = _f32(node["kernel"]).T
        self[f"{name}.bias"] = _f32(node["bias"])

    def layer_norm(self, name: str, node: Tree) -> None:
        self[f"{name}.weight"] = _f32(node["scale"])
        self[f"{name}.bias"] = _f32(node["bias"])

    def batch_norm(self, name: str, params: Tree, stats: Tree) -> None:
        self[f"{name}.weight"] = _f32(params["scale"])
        self[f"{name}.bias"] = _f32(params["bias"])
        self[f"{name}.running_mean"] = _f32(stats["mean"])
        self[f"{name}.running_var"] = _f32(stats["var"])
        self[f"{name}.num_batches_tracked"] = np.array(0, np.int64)

    def local_attention(self, prefix: str, node: Tree) -> None:
        """CLAM (bias-free MLP), SLAM kernel ((7, 7, 2 or 1, 1), one input
        plane a statistic) and 1x1 conv (C or 2C -> C): whichever of them
        the node of a grammar mode holds."""
        if "ChannelGate_0" in node:
            gate = node["ChannelGate_0"]
            self.dense(f"{prefix}ca.fc1", gate["Dense_0"], bias=False)
            self.dense(f"{prefix}ca.fc2", gate["Dense_1"], bias=False)
        if "SpatialGate_0" in node:
            self.conv(f"{prefix}sa.conv1", node["SpatialGate_0"]["Conv_0"],
                      bias=False)
        if "Conv_0" in node:
            self.conv(f"{prefix}conv", node["Conv_0"])

    def global_attention(self, prefix: str, node: Tree) -> None:
        """CGAM gain, SGAM q/k/v convs and gain, 1x1 conv: whichever of
        them the node of a grammar mode holds."""
        if "ChannelSelfAttention_0" in node:
            self[f"{prefix}ca.gamma"] = _f32(
                node["ChannelSelfAttention_0"]["gamma"])
        if "SpatialSelfAttention_0" in node:
            self.sgam(f"{prefix}sa", node["SpatialSelfAttention_0"])
        if "Conv_0" in node:
            self.conv(f"{prefix}conv", node["Conv_0"])

    def sgam(self, name: str, node: Tree) -> None:
        """SGAM: q/k/v convs and gain."""
        for i, conv in enumerate(("query_conv", "key_conv", "value_conv")):
            self.conv(f"{name}.{conv}", node[f"Conv_{i}"])
        self[f"{name}.gamma"] = _f32(node["gamma"])

    def tensors(self) -> Dict[str, torch.Tensor]:
        return _as_tensors(self)


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _params(variables: Tree) -> Tree:
    return variables["params"] if "params" in variables else variables


def _stats(variables: Tree, model: str) -> Tree:
    if "batch_stats" not in variables:
        raise ValueError(f"{model}'s generator has BatchNorm: pass its JAX "
                         "variables {'params', 'batch_stats'}")
    return variables["batch_stats"]


def _stages(node: Tree) -> int:
    return _count(node, "Conv_")


def sradsgan_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``SRADSGANGenerator`` params (or ``{"params": ...}``) -> the
    port's ``SRADSGANGenerator`` state dict, float32 on the CPU."""
    params = _params(params)
    sd = _StateDict()
    sd.conv("conv1.0", params["Conv_0"])
    msb = params["MSB_0"]
    for name, jax_name in (("conv1", "Conv_0"), ("conv2.0", "Conv_1"),
                           ("conv2.1", "Conv_2"), ("conv3", "Conv_3"),
                           ("conv", "Conv_4")):
        sd.conv(f"MSB.{name}", msb[jax_name])
    for g in range(_count(params, "ResGroup_")):
        group = params[f"ResGroup_{g}"]
        for b in range(_count(group, "RAB_")):
            rab = group[f"RAB_{b}"]
            prefix = f"res_groups.{g}.RG.{b}"
            sd.conv(f"{prefix}.conv1", rab["Conv_0"])
            sd.conv(f"{prefix}.conv2", rab["Conv_1"])
            sd.local_attention(f"{prefix}.", rab["LocalAttention_0"])
        sd.local_attention(f"res_groups.{g}.", group["LocalAttention_0"])
    sd.global_attention("GAB_UP.", params["GlobalAttention_0"])
    sd.conv("GAB_UP.upsampling.0", params["UpsampleHead_0"]["Conv_0"])
    sd.conv("conv3.0", params["ConvBlock_0"]["Conv_0"])
    return sd.tensors()


def local_attention_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``LocalAttention`` params of any grammar mode -> the port's
    ``LocalAttention`` state dict."""
    sd = _StateDict()
    sd.local_attention("", _params(params))
    return sd.tensors()


def global_attention_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``GlobalAttention`` params of any grammar mode -> the port's
    ``GlobalAttention`` state dict."""
    sd = _StateDict()
    sd.global_attention("", _params(params))
    return sd.tensors()


def edsr_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``EDSR`` params -> the port's ``EDSR`` state dict."""
    params = _params(params)
    sd = _StateDict()
    sd.conv("input_conv.conv", params["ConvBlock_0"]["Conv_0"])
    for i in range(_count(params, "ResBlock_")):
        block = params[f"ResBlock_{i}"]
        for j in (0, 1):
            sd.conv(f"residual_layers.{i}.conv{j + 1}",
                    block[f"ConvBlock_{j}"]["Conv_0"])
    sd.conv("mid_conv.conv", params["ConvBlock_1"]["Conv_0"])
    sd.conv("upsampling.0", params["UpsampleHead_0"]["Conv_0"])
    sd.conv("output_conv.conv", params["ConvBlock_2"]["Conv_0"])
    return sd.tensors()


def srgan_state_dict(variables: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``SRGANGenerator`` variables (params and ``batch_stats``) -> the
    port's ``SRGANGenerator`` state dict, running statistics included."""
    params, stats = variables["params"], _stats(variables, "srgan")
    sd = _StateDict()

    def conv_bn(name: str, conv_name: str, bn_name: str, jax_name: str):
        sd.conv(f"{name}.{conv_name}", params[jax_name]["Conv_0"])
        sd.batch_norm(f"{name}.{bn_name}", params[jax_name]["BatchNorm_0"],
                      stats[jax_name]["BatchNorm_0"])

    sd.conv("conv1.0", params["ConvBlock_0"]["Conv_0"])
    n = (_count(params, "ConvBlock_") - 2) // 2
    for i in range(n):
        conv_bn(f"res_blocks.{i}.conv_block", "0", "1",
                f"ConvBlock_{1 + 2 * i}")
        conv_bn(f"res_blocks.{i}.conv_block", "3", "4",
                f"ConvBlock_{2 + 2 * i}")
    conv_bn("conv2", "0", "1", f"ConvBlock_{1 + 2 * n}")
    sd.conv("upsampling.0", params["Conv_0"])
    sd.batch_norm("upsampling.1", params["BatchNorm_0"], stats["BatchNorm_0"])
    sd.conv("conv3.0", params["Conv_1"])
    return sd.tensors()


def drcan_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``DRCAN`` params -> the port's ``DRCAN`` state dict."""
    params = _params(params)
    sd = _StateDict()
    n_groups = _count(params, "ConvBlock_") - 3
    n_blocks = _count(params, "RCAB_") // n_groups
    sd.conv("head.0", params["ConvBlock_0"]["Conv_0"])
    for g in range(n_groups):
        for b in range(n_blocks):
            rcab = params[f"RCAB_{g * n_blocks + b}"]
            prefix = f"body.{g}.body.{b}.body"
            sd.conv(f"{prefix}.0", rcab["ConvBlock_0"]["Conv_0"])
            sd.conv(f"{prefix}.2", rcab["ConvBlock_1"]["Conv_0"])
            for i, idx in enumerate((0, 2)):
                sd.dense(f"{prefix}.3.conv_du.{idx}",
                         rcab["CALayer_0"][f"Dense_{i}"])
        sd.conv(f"body.{g}.body.{n_blocks}",
                params[f"ConvBlock_{1 + g}"]["Conv_0"])
    sd.conv(f"body.{n_groups}", params[f"ConvBlock_{1 + n_groups}"]["Conv_0"])
    up = params["UpsampleHead_0"]
    for n in range(_stages(up)):
        sd.conv(f"tail.0.{2 * n}", up[f"Conv_{n}"])
    sd.conv("tail.1", params[f"ConvBlock_{2 + n_groups}"]["Conv_0"])
    return sd.tensors()


def dssr_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``DSSR`` params -> the port's ``DSSR`` state dict."""
    params = _params(params)
    sd = _StateDict()
    sd.conv("conv1.0", params["ConvBlock_0"]["Conv_0"])
    for g in range(_count(params, "DSSRGroup_")):
        group = params[f"DSSRGroup_{g}"]
        for b in range(_count(group, "WAB_")):
            wab = group[f"WAB_{b}"]
            prefix = f"res_groups.{g}.RG.{b}"
            sd.conv(f"{prefix}.conv1", wab["ConvBlock_0"]["Conv_0"])
            sd.conv(f"{prefix}.conv2", wab["ConvBlock_1"]["Conv_0"])
            sd.dense(f"{prefix}.ca.fc1", wab["ChannelGate_0"]["Dense_0"],
                     bias=False)
            sd.dense(f"{prefix}.ca.fc2", wab["ChannelGate_0"]["Dense_1"],
                     bias=False)
        sd.conv(f"res_groups.{g}.conv", group["ConvBlock_0"]["Conv_0"])
    sd.conv("UP.upsampling.0", params["UpsampleHead_0"]["Conv_0"])
    sd.conv("conv3.0", params["ConvBlock_1"]["Conv_0"])
    return sd.tensors()


def sragan_state_dict(variables: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``SRAGANGenerator`` variables (params and ``batch_stats``) ->
    the port's ``SRAGANGenerator`` state dict."""
    params, stats = variables["params"], _stats(variables, "sragan")
    sd = _StateDict()
    sd.conv("conv1.0", params["Conv_0"])
    for g in range(_count(params, "SRAGANGroup_")):
        group = params[f"SRAGANGroup_{g}"]
        n = _count(group, "BasicAttentionBlock_")
        for b in range(n):
            block = group[f"BasicAttentionBlock_{b}"]
            prefix = (f"res_blocks.{g}.blocks.{b}" if b < n - 1
                      else f"res_blocks.{g}.last_conv")
            sd.conv(f"{prefix}.conv1.conv", block["ConvBlock_0"]["Conv_0"])
            sd.conv(f"{prefix}.conv2.conv", block["ConvBlock_1"]["Conv_0"])
            sd.local_attention(f"{prefix}.", block["LocalAttention_0"])
        sd.local_attention(f"res_blocks.{g}.", group["LocalAttention_0"])
    sd.conv("conv2.0", params["Conv_1"])
    sd.batch_norm("conv2.1", params["BatchNorm_0"], stats["BatchNorm_0"])
    sd.global_attention("", params["GlobalAttention_0"])
    sd.conv("upsampling.0", params["Conv_2"])
    sd.batch_norm("upsampling.1", params["BatchNorm_1"], stats["BatchNorm_1"])
    sd.conv("conv3.0", params["Conv_3"])
    return sd.tensors()


def ndsrgan_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``NDSRGANGenerator`` params -> the port's state dict."""
    params = _params(params)
    sd = _StateDict()
    sd.conv("conv1.0", params["ConvBlock_0"]["Conv_0"])
    for k in range(_count(params, "DCRDB_")):
        block = params[f"DCRDB_{k}"]
        prefix = f"DCRDB_block.DRRDB{k + 1}"
        for r in range(3):
            dense = block[f"DenseBlock_{r}"]
            for j in range(4):
                sd.conv(f"{prefix}.RDB{r + 1}.CL_blocks.{j}.0",
                        dense[f"ConvBlock_{j}"]["Conv_0"])
            sd.conv(f"{prefix}.RDB{r + 1}.conv",
                    dense["ConvBlock_4"]["Conv_0"])
        sd.conv(f"{prefix}.conv", block["ConvBlock_0"]["Conv_0"])
    sd.conv("conv2", params["ConvBlock_1"]["Conv_0"])
    sd.conv("upsampling.1", params["NearestConvUpsample_0"]["Conv_0"])
    sd.conv("conv3.0", params["ConvBlock_2"]["Conv_0"])
    sd.conv("conv3.2", params["ConvBlock_3"]["Conv_0"])
    return sd.tensors()


def amssrn_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``AMSSRN`` params -> the port's ``AMSSRN`` state dict.

    The reference's ASPP has one PReLU for its three branches, JAX three
    slopes; they are equal in weights the reference trained (its importer
    writes the one slope to all three), and unequal ones raise."""
    params = _params(params)
    sd = _StateDict()

    def prelu(name: str, node: Tree) -> None:
        sd[f"{name}.weight"] = _f32(node["alpha"]).reshape(1)

    def rb(prefix: str, node: Tree) -> None:
        sd.conv(f"{prefix}.conv3X3", node["ConvBlock_0"]["Conv_0"])
        sd.conv(f"{prefix}.rb.0", node["ConvBlock_1"]["Conv_0"])
        prelu(f"{prefix}.rb.1", node["PReLU_0"])
        sd.conv(f"{prefix}.rb.2", node["ConvBlock_2"]["Conv_0"])

    sd.conv("head.0", params["ConvBlock_0"]["Conv_0"])
    sd["gamma"] = _f32(params["gamma"])
    for q in (0, 1):
        nl = params[f"QuadrantNonLocal_{q}"]["NonLocalBlock_0"]
        for i, name in enumerate(("g", "theta", "phi", "W")):
            sd.conv(f"non_local_{q + 1}.non_local.{name}", nl[f"Conv_{i}"])
    n_db = _count(params, "DB_")
    for i in range(n_db + _count(params, "DBASPP_")):
        node = params[f"DB_{i}" if i < n_db else f"DBASPP_{i - n_db}"]
        prefix = f"body.{i}"
        for c in range(4):
            rb(f"{prefix}.c{c + 1}", node[f"RB_{c}"])
        if i >= n_db:
            slopes = [_f32(node[f"PReLU_{d}"]["alpha"]) for d in range(3)]
            if not all(np.array_equal(slopes[0], a) for a in slopes[1:]):
                raise ValueError(f"DBASPP_{i - n_db}: the three ASPP PReLU "
                                 "slopes differ; the port shares one")
            for d in range(3):
                sd.conv(f"{prefix}.aspp.d{d + 1}", node[f"Conv_{d}"])
            prelu(f"{prefix}.aspp.act", node["PReLU_0"])
        ca = node["AmssrnCALayer_0"]
        sd.dense(f"{prefix}.ca.conv_du.0", ca["Dense_0"])
        prelu(f"{prefix}.ca.conv_du.1", ca["PReLU_0"])
        sd.dense(f"{prefix}.ca.conv_du.2", ca["Dense_1"])
        sd.conv(f"{prefix}.c5", node["Conv_3" if i >= n_db else "Conv_0"])
    n_taps = _count(params, "Conv_") - 1
    for k in range(n_taps):
        sd.conv(f"fpn_fusion.fusion.{k}", params[f"Conv_{k}"])
    sd.conv("feature_bank", params[f"Conv_{n_taps}"])
    up = params["UpsampleHead_0"]
    for n in range(_stages(up)):
        sd.conv(f"tail.{2 * n}", up[f"Conv_{n}"])
    sd.conv("reconstruction", params["ConvBlock_1"]["Conv_0"])
    return sd.tensors()


def hat_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``HAT`` params -> the port's ``HAT`` state dict (the inverse of
    ``import_reference.import_hat``): the CAB's channel attention as 1x1
    convs, the other Dense layers as linear layers, both bias tables as
    they are."""
    params = _params(params)
    sd = _StateDict()

    def mlp(prefix: str, node: Tree) -> None:
        sd.linear(f"{prefix}.mlp.fc1", node["Mlp_0"]["Dense_0"])
        sd.linear(f"{prefix}.mlp.fc2", node["Mlp_0"]["Dense_1"])

    sd.conv("conv_first", params["ConvBlock_0"]["Conv_0"])
    sd.layer_norm("patch_embed.norm", params["LayerNorm_0"])
    for i in range(_count(params, "RHAG_")):
        rhag = params[f"RHAG_{i}"]
        group = f"layers.{i}.residual_group"
        for j in range(_count(rhag, "HAB_")):
            hab, prefix = rhag[f"HAB_{j}"], f"{group}.blocks.{j}"
            sd.layer_norm(f"{prefix}.norm1", hab["LayerNorm_0"])
            cab = hab["CAB_0"]
            sd.conv(f"{prefix}.conv_block.cab.0", cab["ConvBlock_0"]["Conv_0"])
            sd.conv(f"{prefix}.conv_block.cab.2", cab["ConvBlock_1"]["Conv_0"])
            for k, idx in enumerate((1, 3)):
                sd.dense(f"{prefix}.conv_block.cab.3.attention.{idx}",
                         cab["ChannelAttentionHAT_0"][f"Dense_{k}"])
            wa = hab["WindowAttention_0"]
            sd.linear(f"{prefix}.attn.qkv", wa["Dense_0"])
            sd.linear(f"{prefix}.attn.proj", wa["Dense_1"])
            sd[f"{prefix}.attn.relative_position_bias_table"] = _f32(
                wa["relative_position_bias_table"])
            sd.layer_norm(f"{prefix}.norm2", hab["LayerNorm_1"])
            mlp(prefix, hab)
        ocab, prefix = rhag["OCAB_0"], f"{group}.overlap_attn"
        sd.layer_norm(f"{prefix}.norm1", ocab["LayerNorm_0"])
        sd.linear(f"{prefix}.qkv", ocab["Dense_0"])
        sd[f"{prefix}.relative_position_bias_table"] = _f32(
            ocab["relative_position_bias_table"])
        sd.linear(f"{prefix}.proj", ocab["Dense_1"])
        sd.layer_norm(f"{prefix}.norm2", ocab["LayerNorm_1"])
        mlp(prefix, ocab)
        sd.conv(f"layers.{i}.conv", rhag["ConvBlock_0"]["Conv_0"])
    sd.layer_norm("norm", params["LayerNorm_1"])
    sd.conv("conv_after_body", params["ConvBlock_1"]["Conv_0"])
    sd.conv("conv_before_upsample.0", params["ConvBlock_2"]["Conv_0"])
    sd.conv("upsample.upsampling.0", params["UpsampleHead_0"]["Conv_0"])
    sd.conv("conv_last", params["ConvBlock_3"]["Conv_0"])
    return sd.tensors()


GENERATOR_BRIDGES = {
    "sradsgan": sradsgan_state_dict, "edsr": edsr_state_dict,
    "srgan": srgan_state_dict, "drcan": drcan_state_dict,
    "dssr": dssr_state_dict, "sragan": sragan_state_dict,
    "ndsrgan": ndsrgan_state_dict, "amssrn": amssrn_state_dict,
    "hat": hat_state_dict,
}


def generator_state_dict(model: str,
                         variables: Tree) -> Dict[str, torch.Tensor]:
    """The JAX generator of ``model`` (its params, or its variables
    ``{"params", "batch_stats"}``, which SRGAN and SRAGAN need) -> the
    port's state dict of the same generator."""
    try:
        bridge = GENERATOR_BRIDGES[model.lower()]
    except KeyError:
        raise KeyError(f"no weight bridge for model {model!r}; have "
                       f"{sorted(GENERATOR_BRIDGES)}") from None
    return bridge(variables)


def unet_state_dict(params: Tree,
                    channel_mults: Sequence[int] = (1, 2, 4, 8),
                    attn_res: Sequence[int] = (8,), res_blocks: int = 2,
                    resblock_updown: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """JAX diffusion ``UNet`` params (or ``{"params": ...}``) -> the port's
    ``diffusion.unet.UNet`` state dict, for the UNet of these structural
    arguments (the JAX defaults, those of every bundled GDP config).  The
    walk follows the Flax auto-names in creation order: ``Dense_0/1`` the
    time MLP, ``Conv_i`` the input conv, the stride-2 and upsample convs
    (``resblock_updown=False``) and the final conv, ``ResBlock_i`` down,
    middle and up, the named ``attn_down_{level}_{i}``, ``attn_mid`` and
    ``attn_up_{level}_{i}``, and the final ``GroupNorm_0``.  Every leaf is
    consumed exactly once; a leaf left over raises."""
    flat = _flatten(_params(params))
    sd = _StateDict()

    def take(path: str) -> np.ndarray:
        return flat.pop(path)

    def conv(name: str, node: str) -> None:
        sd[f"{name}.weight"] = _oihw(take(f"{node}/kernel"))
        sd[f"{name}.bias"] = _f32(take(f"{node}/bias"))

    def linear(name: str, node: str) -> None:
        sd[f"{name}.weight"] = _f32(take(f"{node}/kernel")).T
        sd[f"{name}.bias"] = _f32(take(f"{node}/bias"))

    def norm(name: str, node: str) -> None:
        sd[f"{name}.weight"] = _f32(take(f"{node}/scale"))
        sd[f"{name}.bias"] = _f32(take(f"{node}/bias"))

    counters = {"Conv": 0, "ResBlock": 0}

    def next_name(kind: str) -> str:
        i = counters[kind]
        counters[kind] += 1
        return f"{kind}_{i}"

    def res(name: str) -> None:
        node = next_name("ResBlock")
        norm(f"{name}.in_norm", f"{node}/GroupNorm_0")
        conv(f"{name}.in_conv", f"{node}/Conv_0")
        linear(f"{name}.emb_proj", f"{node}/Dense_0")
        norm(f"{name}.out_norm", f"{node}/GroupNorm_1")
        conv(f"{name}.out_conv", f"{node}/Conv_1")
        if f"{node}/Conv_2/kernel" in flat:
            conv(f"{name}.skip", f"{node}/Conv_2")

    def attn(name: str, node: str) -> None:
        norm(f"{name}.norm", f"{node}/GroupNorm_0")
        conv(f"{name}.qkv", f"{node}/Conv_0")
        conv(f"{name}.proj_out", f"{node}/Conv_1")

    def attn_at(level: int) -> bool:
        return 2 ** level in tuple(attn_res)

    linear("time_embed.0", "Dense_0")
    linear("time_embed.2", "Dense_1")
    conv("input_blocks.0.0", next_name("Conv"))
    k, last = 1, len(channel_mults) - 1
    for level in range(len(channel_mults)):
        for i in range(res_blocks):
            res(f"input_blocks.{k}.0")
            if attn_at(level):
                attn(f"input_blocks.{k}.1", f"attn_down_{level}_{i}")
            k += 1
        if level != last:
            if resblock_updown:
                res(f"input_blocks.{k}.0")
            else:
                conv(f"input_blocks.{k}.0", next_name("Conv"))
            k += 1
    res("middle_block.0")
    attn("middle_block.1", "attn_mid")
    res("middle_block.2")
    k = 0
    for level in reversed(range(len(channel_mults))):
        for i in range(res_blocks + 1):
            res(f"output_blocks.{k}.0")
            j = 1
            if attn_at(level):
                attn(f"output_blocks.{k}.1", f"attn_up_{level}_{i}")
                j = 2
            if level != 0 and i == res_blocks:
                if resblock_updown:
                    res(f"output_blocks.{k}.{j}")
                else:
                    conv(f"output_blocks.{k}.{j}.conv", next_name("Conv"))
            k += 1
    norm("out.0", "GroupNorm_0")
    conv("out.2", next_name("Conv"))
    if flat:
        raise ValueError(f"unet_state_dict: JAX leaves not mapped (check "
                         f"the structural arguments): {sorted(flat)[:8]}")
    return sd.tensors()


def _as_tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v))  # a writable copy
            for k, v in sd.items()}


def discriminator_state_dict(
        variables: Tree,
        blocks: Sequence[Tuple[int, int, bool]] = DEFAULT_BLOCKS,
        use_attention: bool = True,
        use_global_attention: bool = False) -> Dict[str, torch.Tensor]:
    """JAX ``PatchDiscriminator`` variables (``{"params", "batch_stats"}``)
    -> the port's ``PatchDiscriminator`` state dict: convs OIHW (any kernel
    size), BatchNorm scale and bias as weight and bias with their running
    mean and variance, the CBAM's Dense kernels as 1x1 convs and its gate
    kernel as (1, 2, 7, 7), with ``use_global_attention`` the CGAM's gain
    and the SGAM's convs and gain.  The walk follows the port's flat
    ``model`` Sequential."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = _StateDict()
    seq = conv_i = bn_i = 0
    for i, (_, _, normalize) in enumerate(blocks, 1):
        sd.conv(f"model.{seq}", params[f"Conv_{conv_i}"])
        seq, conv_i = seq + 1, conv_i + 1
        if normalize:
            name = f"BatchNorm_{bn_i}"
            sd.batch_norm(f"model.{seq}", params[name], stats[name])
            seq, bn_i = seq + 1, bn_i + 1
        seq += 1  # LeakyReLU
        if use_attention and i == ATTENTION_AFTER:
            gate = params["ChannelGate_0"]
            sd.dense(f"model.{seq}.fc1", gate["Dense_0"], bias=False)
            sd.dense(f"model.{seq}.fc2", gate["Dense_1"], bias=False)
            sd.conv(f"model.{seq + 1}.conv1",
                    params["SpatialGate_0"]["Conv_0"], bias=False)
            seq += 2
        if use_global_attention and i == GLOBAL_ATTENTION_AFTER:
            sd[f"model.{seq}.gamma"] = _f32(
                params["ChannelSelfAttention_0"]["gamma"])
            sd.sgam(f"model.{seq + 1}", params["SpatialSelfAttention_0"])
            seq += 2
    sd.conv(f"model.{seq}", params[f"Conv_{conv_i}"])
    return sd.tensors()


def sn_patch_discriminator_state_dict(variables: Tree
                                      ) -> Dict[str, torch.Tensor]:
    """JAX ``SNPatchDiscriminator`` variables (``{"params", "spectral"}``)
    -> the port's ``SNPatchDiscriminator`` state dict: each ``SNConv_i``'s
    kernel, bias and power-iteration vector ``u``, then the last conv."""
    params, spectral = variables["params"], variables["spectral"]
    sd = _StateDict()
    n = _count(params, "SNConv_")
    for i in range(n):
        sd.conv(f"model.{2 * i}", params[f"SNConv_{i}"])
        sd[f"model.{2 * i}.u"] = _f32(spectral[f"SNConv_{i}"]["u"])
    sd.conv(f"model.{2 * n}", params["Conv_0"])
    return sd.tensors()


def vgg_style_discriminator_state_dict(variables: Tree
                                       ) -> Dict[str, torch.Tensor]:
    """JAX ``VGGStyleDiscriminator`` variables -> the port's: per stage the
    3x3 conv (a bias in the first stage only), its BatchNorm (not in the
    first), the 4x4 conv and its BatchNorm, in ``features``; the two Dense
    layers as ``classifier.0`` and ``classifier.2`` (the port flattens in
    JAX's NHWC order)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = _StateDict()
    seq = bn_i = 0

    def bn() -> None:
        nonlocal seq, bn_i
        name = f"BatchNorm_{bn_i}"
        sd.batch_norm(f"features.{seq}", params[name], stats[name])
        seq, bn_i = seq + 1, bn_i + 1

    for i in range(_count(params, "Conv_") // 2):
        sd.conv(f"features.{seq}", params[f"Conv_{2 * i}"], bias=i == 0)
        seq += 1
        if i > 0:
            bn()
        seq += 1  # LeakyReLU
        sd.conv(f"features.{seq}", params[f"Conv_{2 * i + 1}"], bias=False)
        seq += 1
        bn()
        seq += 1  # LeakyReLU
    sd.linear("classifier.0", params["Dense_0"])
    sd.linear("classifier.2", params["Dense_1"])
    return sd.tensors()


def rrdbnet_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``RRDBNet`` params -> the port's ``RRDBNet`` state dict."""
    params = _params(params)
    sd = _StateDict()
    sd.conv("conv_first", params["Conv_0"])
    for b in range(_count(params, "RRDB_")):
        rrdb = params[f"RRDB_{b}"]
        for r in range(3):
            rdb = rrdb[f"ResidualDenseBlock5C_{r}"]
            for c in range(5):
                sd.conv(f"trunk.{b}.RDB{r + 1}.conv{c + 1}", rdb[f"Conv_{c}"])
    sd.conv("trunk_conv", params["Conv_1"])
    up = params["UpsampleHead_0"]
    for n in range(_stages(up)):
        sd.conv(f"upsampling.{2 * n}", up[f"Conv_{n}"])
    sd.conv("HRconv.0", params["ConvBlock_0"]["Conv_0"])
    sd.conv("conv_last.0", params["ConvBlock_1"]["Conv_0"])
    return sd.tensors()


def srresnet_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``SRResNet`` params -> the port's ``SRResNet`` state dict."""
    params = _params(params)
    sd = _StateDict()
    nb = (_count(params, "ConvBlock_") - 3) // 2
    sd.conv("conv_first.0", params["ConvBlock_0"]["Conv_0"])
    for b in range(nb):
        for j in (0, 1):
            sd.conv(f"body.{b}.conv{j + 1}",
                    params[f"ConvBlock_{1 + 2 * b + j}"]["Conv_0"])
    sd.conv("trunk_conv.0", params[f"ConvBlock_{1 + 2 * nb}"]["Conv_0"])
    up = params["UpsampleHead_0"]
    for n in range(_stages(up)):
        sd.conv(f"upsampling.{2 * n}", up[f"Conv_{n}"])
    sd.conv("conv_last.0", params[f"ConvBlock_{2 + 2 * nb}"]["Conv_0"])
    return sd.tensors()


def deconv_block_state_dict(variables: Tree, prefix: str = ""
                            ) -> Dict[str, torch.Tensor]:
    """JAX ``DeconvBlock`` variables (``{"params"[, "batch_stats"]}``) ->
    the port's ``DeconvBlock``: the transposed conv, flipped, as
    ``deconv``, the BatchNorm as ``bn``."""
    params = _params(variables)
    sd = _StateDict()
    sd.conv_transpose(f"{prefix}deconv", params["ConvTranspose_0"])
    if "BatchNorm_0" in params:
        sd.batch_norm(f"{prefix}bn", params["BatchNorm_0"],
                      variables["batch_stats"]["BatchNorm_0"])
    return sd.tensors()


def upsample2x_state_dict(variables: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``Upsample2xBlock`` variables -> the port's: 'deconv' its
    ``DeconvBlock_0`` as ``upsample``, 'ps' and 'rnc' the conv as ``conv``
    and the BatchNorm as ``bn``."""
    params = _params(variables)
    if "DeconvBlock_0" in params:
        stats = variables.get("batch_stats", {}).get("DeconvBlock_0", {})
        return deconv_block_state_dict(
            {"params": params["DeconvBlock_0"], "batch_stats": stats},
            "upsample.")
    sd = _StateDict()
    sd.conv("conv", params["Conv_0"])
    if "BatchNorm_0" in params:
        sd.batch_norm("bn", params["BatchNorm_0"],
                      variables["batch_stats"]["BatchNorm_0"])
    return sd.tensors()


def augmented_conv_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``AugmentedConv`` params -> the port's: ``conv_out``,
    ``qkv_conv``, ``attn_out`` and, with relative logits, ``key_rel_w``
    and ``key_rel_h`` as they are."""
    params = _params(params)
    sd = _StateDict()
    for i, name in enumerate(("conv_out", "qkv_conv", "attn_out")):
        sd.conv(name, params[f"Conv_{i}"])
    for name in ("key_rel_w", "key_rel_h"):
        if name in params:
            sd[name] = _f32(params[name])
    return sd.tensors()


def vgg_feature_extractor_state_dict(variables: Tree, feature_layer: int = 34,
                                     use_bn: bool = False
                                     ) -> Dict[str, torch.Tensor]:
    """JAX ``VGGFeatureExtractor`` variables -> the port's: the convs
    ``conv{stage}_{i}`` (and with ``use_bn`` the BatchNorms in order) at
    torchvision's ``features.{index}``, up to ``feature_layer``."""
    params = _params(variables)
    sd = _StateDict()
    idx = bn_i = 0
    for stage, (_, n_convs) in enumerate(VGG19_PLAN, 1):
        for c in range(1, n_convs + 1):
            if idx > feature_layer:
                return sd.tensors()
            sd.conv(f"features.{idx}", params[f"conv{stage}_{c}"])
            idx += 1
            if use_bn:
                name = f"BatchNorm_{bn_i}"
                sd.batch_norm(f"features.{idx}", params[name],
                              variables["batch_stats"][name])
                bn_i += 1
            idx += 2 if use_bn else 1  # (BatchNorm and) ReLU
        idx += 1  # max pool
    return sd.tensors()


def resnet101_state_dict(variables: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``ResNet101FeatureExtractor`` variables -> the port's: the stem
    conv and BatchNorm at ``features.0`` / ``.1``, then each
    ``_Bottleneck_i`` (numbered through all stages) at ``features.{4 +
    stage}.{block}``: ``Conv_0..2`` / ``BatchNorm_0..2`` as ``conv1..3`` /
    ``bn1..3``, ``Conv_3`` / ``BatchNorm_3`` as ``downsample.0`` / ``.1``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = _StateDict()
    sd.conv("features.0", params["Conv_0"], bias=False)
    sd.batch_norm("features.1", params["BatchNorm_0"], stats["BatchNorm_0"])
    stage, b = -1, 0
    for k in range(_count(params, "_Bottleneck_")):
        node, st = params[f"_Bottleneck_{k}"], stats[f"_Bottleneck_{k}"]
        if "Conv_3" in node:  # a downsample opens each stage
            stage, b = stage + 1, 0
        prefix = f"features.{4 + stage}.{b}"
        for j in range(3):
            sd.conv(f"{prefix}.conv{j + 1}", node[f"Conv_{j}"], bias=False)
            sd.batch_norm(f"{prefix}.bn{j + 1}", node[f"BatchNorm_{j}"],
                          st[f"BatchNorm_{j}"])
        if "Conv_3" in node:
            sd.conv(f"{prefix}.downsample.0", node["Conv_3"], bias=False)
            sd.batch_norm(f"{prefix}.downsample.1", node["BatchNorm_3"],
                          st["BatchNorm_3"])
        b += 1
    return sd.tensors()


def minc_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``MINCNet`` params -> the port's (the same conv names)."""
    params = _params(params)
    sd = _StateDict()
    for name, node in params.items():
        sd.conv(name, node)
    return sd.tensors()


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
