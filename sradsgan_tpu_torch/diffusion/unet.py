"""Guided-diffusion-style conditional UNet for diffusion SR, NCHW.

Counterpart of ``sradsgan_tpu/diffusion/unet.py`` (the reference's
GDP_x0 ``model/gdp_modules/unet.py``): a sinusoidal timestep embedding and
its two-layer MLP, ResBlocks with GroupNorm(32) scale-shift time
conditioning, QKV self-attention, channel mults (1, 2, 4, 8), input the
noisy image concatenated with the bicubic conditioner (6 channels).

What the JAX module does, and so this one:

- GroupNorm takes Flax's epsilon, 1e-6 (``nn.GroupNorm``'s is 1e-5).
- Scale-shift: ``GN(h) * (1 + scale) + shift``, ``scale`` then ``shift``
  split from ``Linear(silu(emb))``; a 1x1 skip conv only where the channel
  counts differ.
- ``resblock_updown``: the down and up ResBlocks resample both ``h`` and
  the skip ``x`` between the first norm-SiLU and the conv (2x2 average
  pool, floor on odd sizes; nearest at exactly 2x).  Without it a stride-2
  conv with padding 1 goes down, nearest 2x and a conv go up.
- Attention sits where ``2**level`` is in ``attn_res`` (a downsample rate,
  not a pixel size), and always in the middle; ``max(c // 64, 1)`` heads,
  the qkv channels laid out as (3, heads, d), q scaled by ``d**-0.5``
  before the product, the softmax in float32 and cast back (float64 stays
  float64 throughout, for a reference run).
- The timestep embedding is ``[cos, sin]`` in float32 with a zero column
  for odd widths.

Weights are drawn as Flax inits them (:func:`flax_init`): LeCun-normal
kernels (truncated normal), zero biases, GroupNorm scale one and shift
zero, and zero kernels in each ResBlock's second conv, each attention's
output projection and the final conv, so the freshly initialised net
outputs exactly zero.  Mixed precision is ``torch.autocast`` to bfloat16
over these float32 weights, as the JAX ``dtype=bfloat16`` over float32
params.  Submodule names follow guided-diffusion's layout
(``input_blocks``, ``middle_block``, ``output_blocks``, ``out``);
``tools/from_jax.py:unet_state_dict`` maps the Flax names onto them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.blocks import lecun_normal_

GN_GROUPS = 32
GN_EPS = 1e-6  # flax.linen.GroupNorm's default
HEAD_CHANNELS = 64  # guided-diffusion's num_head_channels


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) float32 ``[cos, sin]`` features."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for a float64 model (a reference run)."""
    return torch.promote_types(dtype, torch.float32)


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, channels, eps=GN_EPS)


def conv3(in_ch: int, out_ch: int, zero: bool = False) -> nn.Conv2d:
    """3x3 SAME conv; ``zero``: Flax's zeros kernel init."""
    layer = nn.Conv2d(in_ch, out_ch, 3, padding=1)
    layer.zero_init = zero
    return layer


def conv1(in_ch: int, out_ch: int, zero: bool = False) -> nn.Conv2d:
    layer = nn.Conv2d(in_ch, out_ch, 1)
    layer.zero_init = zero
    return layer


def _down2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResBlock(nn.Module):
    """Scale-shift-norm residual block, optionally fused with up or down
    sampling (reference unet.py:276-390)."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int,
                 dropout: float = 0.0, up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down = up, down
        self.in_norm = group_norm(in_ch)
        self.in_conv = conv3(in_ch, out_ch)
        self.emb_proj = nn.Linear(emb_ch, 2 * out_ch)
        self.out_norm = group_norm(out_ch)
        self.dropout = nn.Dropout(dropout)
        self.out_conv = conv3(out_ch, out_ch, zero=True)
        self.skip = conv1(in_ch, out_ch) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.in_norm(x))
        if self.down:
            h, x = _down2(h), _down2(x)
        elif self.up:
            h, x = _up2(h), _up2(x)
        h = self.in_conv(h)
        scale, shift = self.emb_proj(F.silu(emb))[:, :, None, None].chunk(
            2, dim=1)
        h = self.out_norm(h) * (1 + scale) + shift
        h = self.out_conv(self.dropout(F.silu(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AttnBlock(nn.Module):
    """QKV self-attention over the H*W positions; ``max(c // 64, 1)`` heads
    (reference unet.py:392-527, 576-577)."""

    def __init__(self, channels: int):
        super().__init__()
        self.heads = max(channels // HEAD_CHANNELS, 1)
        self.norm = group_norm(channels)
        self.qkv = conv1(channels, 3 * channels)
        self.proj_out = conv1(channels, channels, zero=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        d = c // self.heads
        qkv = self.qkv(self.norm(x)).reshape(b, 3, self.heads, d, h * w)
        q, k, v = qkv.unbind(1)  # each (b, heads, d, n)
        attn = torch.einsum("bhdq,bhdk->bhqk", q * (d ** -0.5), k)
        attn = attn.to(_at_least_f32(attn.dtype)).softmax(dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bhdk->bhdq", attn, v).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv (``resblock_updown=False``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_up2(x))


class EmbedSequential(nn.ModuleList):
    """Runs its modules in order, handing the embedding to the ResBlocks."""

    def forward(self, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        for layer in self:
            h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
        return h


class UNet(nn.Module):
    """(B, in_channel, H, W) and (B,) timesteps -> (B, out_channel, H, W);
    H and W multiples of ``2 ** (len(channel_mults) - 1)``.  The JAX
    constructor's arguments (``image_size`` is kept and unused, as there),
    weights drawn by :func:`flax_init` from ``seed``."""

    def __init__(self, in_channel: int = 6, out_channel: int = 3,
                 inner_channel: int = 64,
                 channel_mults: Sequence[int] = (1, 2, 4, 8),
                 attn_res: Sequence[int] = (8,), res_blocks: int = 2,
                 dropout: float = 0.0, image_size: int = 216,
                 resblock_updown: bool = True, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        self.channel_mults = tuple(channel_mults)
        self.attn_res = tuple(attn_res)
        self.res_blocks = res_blocks
        self.resblock_updown = resblock_updown
        self.image_size = image_size
        ch, emb_ch = inner_channel, 4 * inner_channel
        self.inner_channel = ch
        with torch.device("meta"):  # skip torch's default init
            self.time_embed = nn.Sequential(
                nn.Linear(ch, emb_ch), nn.SiLU(), nn.Linear(emb_ch, emb_ch))
            self.input_blocks = nn.ModuleList(
                [EmbedSequential([conv3(in_channel, ch)])])
            chans, cur = [ch], ch
            last = len(self.channel_mults) - 1
            for level, mult in enumerate(self.channel_mults):
                for _ in range(res_blocks):
                    block = [ResBlock(cur, ch * mult, emb_ch, dropout)]
                    cur = ch * mult
                    if self.attn_at(level):
                        block.append(AttnBlock(cur))
                    self.input_blocks.append(EmbedSequential(block))
                    chans.append(cur)
                if level != last:
                    down = (ResBlock(cur, cur, emb_ch, dropout, down=True)
                            if resblock_updown else
                            nn.Conv2d(cur, cur, 3, stride=2, padding=1))
                    self.input_blocks.append(EmbedSequential([down]))
                    chans.append(cur)
            self.middle_block = EmbedSequential([
                ResBlock(cur, cur, emb_ch, dropout), AttnBlock(cur),
                ResBlock(cur, cur, emb_ch, dropout)])
            self.output_blocks = nn.ModuleList()
            for level, mult in reversed(list(enumerate(self.channel_mults))):
                for i in range(res_blocks + 1):
                    block = [ResBlock(cur + chans.pop(), ch * mult, emb_ch,
                                      dropout)]
                    cur = ch * mult
                    if self.attn_at(level):
                        block.append(AttnBlock(cur))
                    if level != 0 and i == res_blocks:
                        block.append(
                            ResBlock(cur, cur, emb_ch, dropout, up=True)
                            if resblock_updown else Upsample(cur))
                    self.output_blocks.append(EmbedSequential(block))
            self.out = nn.Sequential(group_norm(cur), nn.SiLU(),
                                     conv3(cur, out_channel, zero=True))
        flax_init(self, seed)
        self.to(device)

    def attn_at(self, level: int) -> bool:
        """Attention by downsample rate (reference unet.py:628-641)."""
        return (2 ** level) in self.attn_res

    @property
    def size_multiple(self) -> int:
        return 2 ** (len(self.channel_mults) - 1)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.inner_channel)
        emb = self.time_embed(emb.to(self.time_embed[0].weight.dtype))
        skips = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb)
            skips.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, skips.pop()], dim=1), emb)
        return self.out(h)


def flax_init(model: nn.Module, seed: int) -> None:
    """Give a model built on the meta device CPU storage and Flax's default
    init, drawn from ``torch.Generator().manual_seed(seed)`` in module
    order: conv and linear kernels LeCun normal (zero where ``zero_init``
    is set), biases zero, GroupNorm scale one and shift zero.  A parameter
    of any other kind raises."""
    model.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(seed)
    done = set()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                if getattr(m, "zero_init", False):
                    m.weight.zero_()
                else:
                    lecun_normal_(m.weight, gen)
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.reset_parameters()
            else:
                continue
            done.update(id(p) for p in m.parameters(recurse=False))
        for name, p in model.named_parameters():
            if id(p) not in done:
                raise TypeError(f"flax_init: no init for {name}")
