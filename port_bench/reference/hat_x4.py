"""A plain HAT x4, the Hybrid Attention Transformer (Chen et al., "Activating
More Pixels in Image Super-Resolution Transformer", CVPR 2023,
arXiv:2205.04437), as published in XPixelGroup/HAT ``hat/archs/hat_arch.py``
with ``upsampler: pixelshuffle``, ``resi_connection: 1conv``, ``img_range``
1 and the RGB mean shift, and the test-time pad and crop of
``hat/models/hat_model.py`` (``pre_process``, ``post_process``).

Plain PyTorch in float32, nothing of the program.  The body runs on (B,
H*W, C) tokens as published: ``conv_first``; ``patch_embed`` (flatten,
LayerNorm); residual hybrid attention groups (RHAG: hybrid attention blocks
(HAB), then an overlapping cross-attention block (OCAB), then a 3x3 conv on
the image and the group's input added); LayerNorm; ``conv_after_body``
plus the shallow features; a 3x3 conv and LeakyReLU(0.01); a conv and a
pixel shuffle per x2 stage; ``conv_last``.

- HAB: LayerNorm; beside each other, the channel-attention block (3x3 conv
  to C / compress_ratio, GELU, 3x3 conv back, the squeeze-and-excitation
  gate of C / squeeze_factor) times ``conv_scale``, and the window
  attention, the odd blocks' over windows cyclically shifted by half a
  window with the -100 mask between regions; then LayerNorm and the MLP.
- OCAB: queries from each window, keys and values from the window widened
  by ``overlap_ratio`` (``nn.Unfold`` with zero padding, split in the
  published ``rearrange`` order ``b (nc ch owh oww) nw -> nc (b nw) (owh
  oww) ch``), the relative-position bias of the published index table;
  then the projection, the residual, LayerNorm and an MLP of the model's
  ``mlp_ratio``.
- Both attentions call one ``Attend``: the logits of q * head_dim^-1/2 and
  k, the bias (and the mask) added and the softmax taken in float32, the
  product with v.  Its products go through ``Products.einsum`` and every
  dense layer and conv through ``Linear`` and ``Conv``, so that the float8
  control reaches each product; LayerNorm runs in float32.
- The GELU is exact (``nn.GELU``); the upsampler has a conv per stage.

Departures from the published model:

- no stochastic depth: its random per-sample drops (``drop_path_rate`` 0.1)
  cannot be compared draw for draw; the program leaves it out too;
- no EMA of the weights (BasicSR's ``ema_decay`` 0.999): a training step
  here is one Adam step of the network itself;
- names as the program's state dict, so that one set of weights loads into
  both: the upsampler's convs are ``upsample.upsampling.0`` and ``.2``
  (published ``upsample.0``, ``.2``), the pre-upsample conv
  ``conv_before_upsample.0``; the relative position index tables and the
  mask are made in the forward, not held as buffers;
- x4 alone (two x2 stages), 3 channels in and out, no absolute position
  embedding, no dropout (all published defaults of HAT_SRx4).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.models import (Conv, Linear, Products,
                                         autocast_off)

MEAN = (0.4488, 0.4371, 0.4040)
UPSCALE = 4
PUBLISHED = {"gelu": "exact", "share_upsample": False}
# one group of an unshifted and a shifted HAB; wide enough that at the
# benchmark's weights (normal(0, 0.02)) unshifted windows move the output
# past the serving limit
TINY_WIDTHS = {"embed_dim": 48, "depths": [2], "num_heads": [2],
               "window_size": 4, "overlap_ratio": 0.5, "mlp_ratio": 2,
               "compress_ratio": 3, "squeeze_factor": 16, "conv_scale": 0.01,
               "num_feat": 64, "gelu": "exact", "share_upsample": False}


def conv3(c_in: int, c_out: int) -> Conv:
    return Conv(c_in, c_out, 3, padding=1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in float32 (autocast off), eps 1e-5 as ``nn.LayerNorm``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with autocast_off(x):
            return F.layer_norm(x.float(), self.normalized_shape,
                                self.weight, self.bias, self.eps)


# ---------------------------------------------------------------------------
# Index tables and the mask (HAT.calculate_rpi_sa, calculate_rpi_oca,
# calculate_mask)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rpi_sa(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def rpi_oca(ws: int, overlap_ratio: float) -> torch.Tensor:
    ext = ws + int(overlap_ratio * ws)
    ori = torch.flatten(torch.stack(torch.meshgrid(
        torch.arange(ws), torch.arange(ws), indexing="ij")), 1)
    wide = torch.flatten(torch.stack(torch.meshgrid(
        torch.arange(ext), torch.arange(ext), indexing="ij")), 1)
    rel = (wide[:, None, :] - ori[:, :, None]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - ext + 1
    rel[:, :, 1] += ws - ext + 1
    rel[:, :, 0] *= ws + ext - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(b, h, w, c) -> (b * nw, ws, ws, c)."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    """(b * nw, ws, ws, c) -> (b, h, w, c)."""
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


@functools.lru_cache(maxsize=None)
def attn_mask(h: int, w: int, ws: int) -> torch.Tensor:
    """(nw, ws*ws, ws*ws): 0 within a region of the shifted image, -100
    across regions."""
    shift = ws // 2
    img = torch.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    m = window_partition(img, ws).view(-1, ws * ws)
    m = m.unsqueeze(1) - m.unsqueeze(2)
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Attend(Products):
    """softmax(q k^T * d^-1/2 + bias [+ mask]) v: q (B_, heads, Nq, d), k
    and v (B_, heads, Nk, d), bias (heads, Nq, Nk), mask (nw, Nq, Nk) or
    None -> (B_, heads, Nq, d).  The logits, bias, mask and softmax in
    float32."""

    def forward(self, q, k, v, bias, mask=None):
        b_, heads, nq, d = q.shape
        attn = self.einsum("bhqd,bhkd->bhqk", q * d ** -0.5, k)
        with autocast_off(attn):
            attn = attn.float() + bias.float().unsqueeze(0)
            if mask is not None:
                nw = mask.shape[0]
                attn = (attn.view(b_ // nw, nw, heads, nq, -1)
                        + mask.unsqueeze(1).unsqueeze(0))
                attn = attn.view(-1, heads, nq, attn.shape[-1])
            attn = torch.softmax(attn, dim=-1)
        return self.einsum("bhqk,bhkd->bhqd", attn, v)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ChannelAttention(nn.Module):
    def __init__(self, c: int, squeeze_factor: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), Conv(c, c // squeeze_factor, 1),
            nn.ReLU(), Conv(c // squeeze_factor, c, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x)


class CAB(nn.Module):
    def __init__(self, c: int, compress_ratio: int, squeeze_factor: int):
        super().__init__()
        self.cab = nn.Sequential(
            conv3(c, c // compress_ratio), nn.GELU(),
            conv3(c // compress_ratio, c),
            ChannelAttention(c, squeeze_factor))

    def forward(self, x):
        return self.cab(x)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, ws: int, heads: int):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * ws - 1) ** 2, heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.attend = Attend()

    def forward(self, x, mask):
        b_, n, c = x.shape
        qkv = self.qkv(x).reshape(b_, n, 3, self.heads,
                                  c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        rpi = rpi_sa(self.ws).to(x.device)
        bias = self.relative_position_bias_table[rpi.view(-1)].view(
            n, n, -1).permute(2, 0, 1).contiguous()
        out = self.attend(q, k, v, bias, mask)
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


class HAB(nn.Module):
    def __init__(self, dim, heads, ws, shift, compress_ratio, squeeze_factor,
                 conv_scale, mlp_ratio):
        super().__init__()
        self.ws, self.shift, self.conv_scale = ws, shift, conv_scale
        self.norm1 = LayerNorm(dim)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor)
        self.attn = WindowAttention(dim, ws, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, x_size, mask):
        h, w = x_size
        b, _, c = x.shape
        shortcut = x
        x = self.norm1(x).view(b, h, w, c)
        conv_x = self.conv_block(x.permute(0, 3, 1, 2))
        conv_x = conv_x.permute(0, 2, 3, 1).contiguous().view(b, h * w, c)
        if self.shift > 0:
            x = torch.roll(x, shifts=(-self.shift, -self.shift), dims=(1, 2))
        else:
            mask = None
        windows = window_partition(x, self.ws).view(-1, self.ws * self.ws, c)
        windows = self.attn(windows, mask).view(-1, self.ws, self.ws, c)
        x = window_reverse(windows, self.ws, h, w)
        if self.shift > 0:
            x = torch.roll(x, shifts=(self.shift, self.shift), dims=(1, 2))
        x = shortcut + x.view(b, h * w, c) + conv_x * self.conv_scale
        return x + self.mlp(self.norm2(x))


class OCAB(nn.Module):
    def __init__(self, dim, heads, ws, overlap_ratio, mlp_ratio):
        super().__init__()
        self.dim, self.heads, self.ws = dim, heads, ws
        self.overlap_ratio = overlap_ratio
        self.ows = int(ws * overlap_ratio) + ws
        self.norm1 = LayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim)
        self.unfold = nn.Unfold(kernel_size=(self.ows, self.ows), stride=ws,
                                padding=(self.ows - ws) // 2)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((ws + self.ows - 1) ** 2, heads))
        self.attend = Attend()
        self.proj = Linear(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, x_size):
        h, w = x_size
        b, _, c = x.shape
        ws, ows, heads = self.ws, self.ows, self.heads
        shortcut = x
        x = self.norm1(x).view(b, h, w, c)
        qkv = self.qkv(x).reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)
        q = qkv[0].permute(0, 2, 3, 1)  # b, h, w, c
        kv = torch.cat((qkv[1], qkv[2]), dim=1)  # b, 2c, h, w
        q_windows = window_partition(q, ws).view(-1, ws * ws, c)
        kv_windows = self.unfold(kv)  # b, 2c * ows * ows, nw
        nw = kv_windows.shape[-1]
        kv_windows = kv_windows.view(b, 2, c, ows, ows, nw).permute(
            1, 0, 5, 3, 4, 2).reshape(2, b * nw, ows * ows, c)
        k_windows, v_windows = kv_windows[0], kv_windows[1]
        b_, nq, _ = q_windows.shape
        n = k_windows.shape[1]
        d = self.dim // heads
        q = q_windows.reshape(b_, nq, heads, d).permute(0, 2, 1, 3)
        k = k_windows.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
        v = v_windows.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
        rpi = rpi_oca(ws, self.overlap_ratio).to(x.device)
        bias = self.relative_position_bias_table[rpi.view(-1)].view(
            ws * ws, ows * ows, -1).permute(2, 0, 1).contiguous()
        out = self.attend(q, k, v, bias).transpose(1, 2).reshape(
            b_, nq, self.dim)
        out = window_reverse(out.view(-1, ws, ws, self.dim), ws, h, w)
        x = self.proj(out.view(b, h * w, self.dim)) + shortcut
        return x + self.mlp(self.norm2(x))


class AttenBlocks(nn.Module):
    def __init__(self, dim, depth, heads, ws, overlap_ratio, mlp_ratio,
                 compress_ratio, squeeze_factor, conv_scale):
        super().__init__()
        self.blocks = nn.ModuleList(
            HAB(dim, heads, ws, 0 if i % 2 == 0 else ws // 2,
                compress_ratio, squeeze_factor, conv_scale, mlp_ratio)
            for i in range(depth))
        self.overlap_attn = OCAB(dim, heads, ws, overlap_ratio, mlp_ratio)

    def forward(self, x, x_size, mask):
        for block in self.blocks:
            x = block(x, x_size, mask)
        return self.overlap_attn(x, x_size)


class RHAG(nn.Module):
    def __init__(self, dim, depth, heads, ws, overlap_ratio, mlp_ratio,
                 compress_ratio, squeeze_factor, conv_scale):
        super().__init__()
        self.residual_group = AttenBlocks(
            dim, depth, heads, ws, overlap_ratio, mlp_ratio, compress_ratio,
            squeeze_factor, conv_scale)
        self.conv = conv3(dim, dim)

    def forward(self, x, x_size, mask):
        b, _, c = x.shape
        y = self.residual_group(x, x_size, mask)
        y = y.transpose(1, 2).view(b, c, *x_size)  # patch_unembed
        return self.conv(y).flatten(2).transpose(1, 2) + x  # patch_embed


class HAT(nn.Module):
    def __init__(self, embed_dim, depths, num_heads, window_size,
                 overlap_ratio, mlp_ratio, compress_ratio, squeeze_factor,
                 conv_scale, num_feat):
        super().__init__()
        self.ws = window_size
        self.conv_first = conv3(3, embed_dim)
        self.patch_embed = nn.Module()
        self.patch_embed.norm = LayerNorm(embed_dim)
        self.layers = nn.ModuleList(
            RHAG(embed_dim, depth, heads, window_size, overlap_ratio,
                 mlp_ratio, compress_ratio, squeeze_factor, conv_scale)
            for depth, heads in zip(depths, num_heads))
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = conv3(embed_dim, embed_dim)
        self.conv_before_upsample = nn.Sequential(conv3(embed_dim, num_feat),
                                                  nn.LeakyReLU(0.01))
        self.upsample = nn.Module()
        self.upsample.upsampling = nn.Sequential(
            conv3(num_feat, 4 * num_feat), nn.PixelShuffle(2),
            conv3(num_feat, 4 * num_feat), nn.PixelShuffle(2))
        self.conv_last = conv3(num_feat, 3)

    def forward_features(self, x):
        b, c, h, w = x.shape
        mask = attn_mask(h, w, self.ws).to(x.device)
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        for layer in self.layers:
            x = layer(x, (h, w), mask)
        return self.norm(x).transpose(1, 2).view(b, c, h, w)

    def forward(self, x):
        # pre_process: reflect pad at the bottom and right to the window
        h0, w0 = x.shape[2:]
        ph, pw = (-h0) % self.ws, (-w0) % self.ws
        x = F.pad(x, (0, pw, 0, ph), "reflect")
        mean = torch.tensor(MEAN, dtype=x.dtype).view(1, 3, 1, 1).to(
            x.device)
        x = self.conv_first(x - mean)
        x = self.conv_after_body(self.forward_features(x)) + x
        x = self.conv_last(self.upsample.upsampling(
            self.conv_before_upsample(x)))
        # post_process: crop the padding's share of the output
        return (x + mean)[:, :, :h0 * UPSCALE, :w0 * UPSCALE]


def build(device, gelu="exact", share_upsample=False, **widths):
    """The published HAT x4 at ``widths`` (``HAT``'s arguments) with
    uninitialised storage on ``device``; ``gelu`` and ``share_upsample``
    must be the published model's."""
    if {"gelu": gelu, "share_upsample": share_upsample} != PUBLISHED:
        raise ValueError(f"the reference is the published HAT: {PUBLISHED}")
    with torch.device("meta"):
        model = HAT(**widths)
    return model.to_empty(device=device)
