"""HAT, the Hybrid Attention Transformer SR generator, in PyTorch.

Counterpart of ``sradsgan_tpu/models/hat.py``: six residual hybrid
attention groups (RHAG) of six hybrid attention blocks (HAB: (shifted-)
window self-attention with a relative position bias, a parallel conv
channel-attention branch scaled by 0.01, and an MLP), each group closed by
an overlapping cross-attention block (OCAB) and a 3x3 conv; embed 96, 6
heads, window 9 for scales 2^n and 8 for 3^n, the RGB mean shift, a
LeakyReLU conv and the shared sub-pixel upsample.  Pixel loss only.

The defaults are the SRADSGAN repo's HAT, which the JAX package mirrors:
the tanh GELU and one upsample conv shared by every x2 stage.
``gelu="exact"`` and ``share_upsample=False`` are the published
XPixelGroup HAT (``hat/archs/hat_arch.py``): ``nn.GELU``, and basicsr's
``Upsample``, a conv and a pixel shuffle per stage.

One formulation, the JAX package's default: q, k and v stay in (B, N,
heads, d) and the attention is an einsum over that layout, the logits, the
bias tables and the mask added and the softmax taken in float32 whatever
the compute dtype.  No kernel stands behind it: plain PyTorch matmuls and
softmax.  The spans ``hat.window_attention`` and ``hat.overlap_attention``
(``utils/spans.py``) hold each attention's bias gather and its
:func:`_attend` call, the OCAB's also its overlapping key and value
windows; ``_attend.calls`` and ``_attend.logit_elements`` count the calls
and their B_ * heads * Nq * Nk logits, eager and captured, as the kernel
ops count their launches.  The body runs on (B, H, W, C) tokens, so
LayerNorm and the dense layers act on the last axis; the CAB's convs and
each group's closing conv see an NCHW view of them.  The default GELU is
the tanh approximation, Flax's ``nn.gelu`` default (:func:`gelu`).

The index tables and the shifted-window mask (:func:`rpi_sa`,
:func:`rpi_oca`, :func:`sw_attn_mask`) are numpy, cached by shape, and
copied once to each device they are used on.  Module names follow the
reference's ``state_dict``, which ``import_reference.import_hat`` reads
(``conv_first``, ``patch_embed.norm``, ``layers.{i}.residual_group.
blocks.{j}.{norm1, conv_block.cab, attn, norm2, mlp}``,
``layers.{i}.residual_group.overlap_attn``, ``layers.{i}.conv``, ``norm``,
``conv_after_body``, ``conv_before_upsample.0``, ``upsample.upsampling.0``,
``conv_last``; with ``share_upsample=False`` ``upsample.upsampling.0``
and ``.2``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sradsgan_tpu_torch.nn.blocks import (ConvBlock, UpsampleHead, conv,
                                          materialize)
from sradsgan_tpu_torch.ops import plain_dtype
from sradsgan_tpu_torch.utils.spans import span

MEAN = (0.4488, 0.4371, 0.4040)
LN_EPS = 1e-5
GELUS = ("tanh", "exact")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _activate(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """The exact GELU (the published ``nn.GELU``) or :func:`gelu`."""
    return F.gelu(x) if exact else gelu(x)


def _exact(kind: str) -> bool:
    if kind not in GELUS:
        raise ValueError(f"gelu must be one of {GELUS}, got {kind!r}")
    return kind == "exact"


class _Gelu(nn.Module):
    def __init__(self, exact: bool = False):
        super().__init__()
        self.exact = exact

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _activate(x, self.exact)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


# ---------------------------------------------------------------------------
# Index tables and the mask (numpy, as the JAX package's, hat.py:78-121)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def rpi_sa(window: int) -> np.ndarray:
    """(w*w, w*w) index of each (query, key) pair's relative position in
    the window attention's bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[..., 0] += window - 1
    rel[..., 1] += window - 1
    rel[..., 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=32)
def rpi_oca(window: int, overlap_ratio: float) -> np.ndarray:
    """(w*w, we*we) index into the OCAB's bias table, we the overlapping
    window."""
    wo = window
    we = window + int(overlap_ratio * window)
    co = np.stack(np.meshgrid(np.arange(wo), np.arange(wo),
                              indexing="ij")).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(we), np.arange(we),
                              indexing="ij")).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0).astype(
        np.int64)
    rel[..., 0] += wo - we + 1
    rel[..., 1] += wo - we + 1
    rel[..., 0] *= wo + we - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def sw_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, w*w, w*w) additive mask of 0 / -100 for shifted windows."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    m = img.reshape(h // window, window, w // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


_ON_DEVICE: dict = {}


def _on_device(table: Callable[..., np.ndarray], *args,
               device: torch.device) -> torch.Tensor:
    """``table(*args)`` as a tensor on ``device``, copied there once (made
    outside inference mode, so that a training step may save it).  A
    tensor made while ``torch.export`` traces (a fake one) is not kept."""
    key = (table.__name__, args, device)
    t = _ON_DEVICE.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.from_numpy(table(*args)).to(device)
        if type(t) is torch.Tensor:
            _ON_DEVICE[key] = t
    return t


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, win, win, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c)


def window_reverse(windows: torch.Tensor, win: int, h: int,
                   w: int) -> torch.Tensor:
    """(B*nW, win, win, C) -> (B, H, W, C)."""
    b = windows.shape[0] // (h * w // win // win)
    x = windows.reshape(b, h // win, w // win, win, win, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, mask: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """q (B_, Nq, h, d), k and v (B_, Nk, h, d) -> (B_, Nq, h*d): scaled
    logits, the (h, Nq, Nk) bias and the (nW, Nq, Nk) mask added and the
    softmax taken in float32 (float64 kept), the weights cast back to q's
    dtype (JAX ``hat.py:214-222``)."""
    b_, nq, heads, d = q.shape
    _attend.calls += 1
    _attend.logit_elements += b_ * heads * nq * k.shape[1]
    attn = torch.einsum("bqhd,bkhd->bhqk", q * d ** -0.5, k)
    dtype = plain_dtype(attn)  # float32, or float64 kept
    attn = attn.to(dtype) + bias.to(dtype)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(b_ // nw, nw, heads, nq, -1)
                + mask[None, :, None]).reshape(b_, heads, nq, -1)
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b_, nq, -1)


_attend.calls = 0
_attend.logit_elements = 0


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Mlp(nn.Module):
    """``fc1``, GELU (exact with ``exact_gelu``, else tanh), ``fc2`` on the
    last axis."""

    def __init__(self, dim: int, hidden: int, exact_gelu: bool = False):
        super().__init__()
        self.exact_gelu = exact_gelu
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_activate(self.fc1(x), self.exact_gelu))


class ChannelAttentionHAT(nn.Module):
    """The CAB's channel attention on NCHW: the spatial mean, two 1x1 convs
    (``attention.1``, ``attention.3``; Dense layers in JAX) with a ReLU
    between, a sigmoid gate."""

    def __init__(self, dim: int, squeeze_factor: int = 30):
        super().__init__()
        hidden = max(dim // squeeze_factor, 1)
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, hidden, 1), nn.ReLU(),
            nn.Conv2d(hidden, dim, 1), nn.Sigmoid())
        for i in (1, 3):  # Dense layers in JAX: truncated normal init
            self.attention[i].trunc_init = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.attention(x)


class CAB(nn.Module):
    """Channel attention block on NCHW: ``cab`` = 3x3 conv to dim /
    compress_ratio, GELU, 3x3 conv back, channel attention."""

    def __init__(self, dim: int, compress_ratio: int = 3,
                 squeeze_factor: int = 30, exact_gelu: bool = False):
        super().__init__()
        self.cab = nn.Sequential(
            conv(dim, dim // compress_ratio), _Gelu(exact_gelu),
            conv(dim // compress_ratio, dim),
            ChannelAttentionHAT(dim, squeeze_factor))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cab(x)


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias: ``qkv``, ``proj`` and the
    ``relative_position_bias_table`` ((2 window - 1)^2, heads), which stays
    float32 in a bf16 copy (``serving._compute_copy``)."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.window = window
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads))

    def forward(self, x: torch.Tensor, win: int,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (B_, win*win, C) windows."""
        b_, n, c = x.shape
        h = self.num_heads
        q, k, v = (t.reshape(b_, n, h, c // h)
                   for t in self.qkv(x).chunk(3, dim=-1))
        with span("hat.window_attention"):
            idx = _on_device(rpi_sa, win, device=x.device)
            bias = self.relative_position_bias_table[idx.reshape(-1)].reshape(
                n, n, h).permute(2, 0, 1)
            out = _attend(q, k, v, bias, mask)
        return self.proj(out)


class HAB(nn.Module):
    """Hybrid attention block on (B, H, W, C): (shifted-)window attention
    plus the 0.01-scaled CAB of the same LayerNorm's output, then the MLP.
    The window is ``min(window, H, W)``, and a window that shrinks takes no
    shift (JAX ``hat.py:258-259``; inside :class:`HAT`, which pads to a
    window multiple, it never shrinks)."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 compress_ratio: int = 3, squeeze_factor: int = 30,
                 conv_scale: float = 0.01, mlp_ratio: float = 4.0,
                 exact_gelu: bool = False):
        super().__init__()
        self.window, self.shift, self.conv_scale = window, shift, conv_scale
        self.norm1 = _layer_norm(dim)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor,
                              exact_gelu)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = _layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), exact_gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hgt, wdt, c = x.shape
        win = min(self.window, hgt, wdt)
        shift = self.shift if win == self.window else 0
        xn = self.norm1(x)
        conv_x = self.conv_block(xn.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        mask = None
        if shift > 0:
            xn = torch.roll(xn, (-shift, -shift), (1, 2))
            mask = _on_device(sw_attn_mask, hgt, wdt, win, shift,
                              device=x.device)
        windows = window_partition(xn, win).reshape(-1, win * win, c)
        attn = window_reverse(self.attn(windows, win, mask).reshape(
            -1, win, win, c), win, hgt, wdt)
        if shift > 0:
            attn = torch.roll(attn, (shift, shift), (1, 2))
        x = x + attn + conv_x * self.conv_scale
        return x + self.mlp(self.norm2(x))


class OCAB(nn.Module):
    """Overlapping cross-attention on (B, H, W, C): queries from each
    window, keys and values from the window widened by ``overlap_ratio``
    (zero-padded at the image's border), in row-major order."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 2.0,
                 exact_gelu: bool = False):
        super().__init__()
        self.window, self.overlap_ratio = window, overlap_ratio
        self.num_heads = num_heads
        owin = window + int(overlap_ratio * window)
        self.norm1 = _layer_norm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((window + owin - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = _layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), exact_gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hgt, wdt, c = x.shape
        win = min(self.window, hgt, wdt)
        owin = win + int(self.overlap_ratio * win)
        pad = (owin - win) // 2
        heads = self.num_heads
        d = c // heads

        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        qw = window_partition(q, win).reshape(-1, win * win, heads, d)

        def overlap_windows(t: torch.Tensor) -> torch.Tensor:
            t = F.pad(t, (0, 0, pad, pad, pad, pad))
            # (B, nh, nw, C, owin, owin) -> (B*nh*nw, owin*owin, heads, d)
            t = t.unfold(1, owin, win).unfold(2, owin, win)
            return t.permute(0, 1, 2, 4, 5, 3).reshape(-1, owin * owin,
                                                       heads, d)

        with span("hat.overlap_attention"):
            kw, vw = overlap_windows(k), overlap_windows(v)
            idx = _on_device(rpi_oca, win, self.overlap_ratio,
                             device=x.device)
            bias = self.relative_position_bias_table[idx.reshape(-1)].reshape(
                win * win, owin * owin, heads).permute(2, 0, 1)
            out = _attend(qw, kw, vw, bias, None)
        out = self.proj(window_reverse(out.reshape(-1, win, win, c), win,
                                       hgt, wdt))
        x = x + out
        return x + self.mlp(self.norm2(x))


class ResidualGroup(nn.Module):
    """``blocks`` (HABs, odd ones shifted by window // 2), then
    ``overlap_attn`` (its MLP of ratio 2, the JAX package's, whatever
    ``mlp_ratio``; the published OCAB takes ``mlp_ratio``, which HAT_SRx4
    sets to 2)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int,
                 overlap_ratio: float, mlp_ratio: float, compress_ratio: int,
                 squeeze_factor: int, conv_scale: float,
                 exact_gelu: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(
            HAB(dim, num_heads, window, 0 if i % 2 == 0 else window // 2,
                compress_ratio, squeeze_factor, conv_scale, mlp_ratio,
                exact_gelu)
            for i in range(depth))
        self.overlap_attn = OCAB(dim, num_heads, window, overlap_ratio,
                                 exact_gelu=exact_gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return self.overlap_attn(x)


class RHAG(nn.Module):
    """Residual hybrid attention group: ``residual_group``, the 3x3
    ``conv``, plus the input."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 4.0,
                 compress_ratio: int = 3, squeeze_factor: int = 30,
                 conv_scale: float = 0.01, exact_gelu: bool = False):
        super().__init__()
        self.residual_group = ResidualGroup(
            dim, depth, num_heads, window, overlap_ratio, mlp_ratio,
            compress_ratio, squeeze_factor, conv_scale, exact_gelu)
        self.conv = conv(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.residual_group(x)
        return self.conv(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + x


def default_window(scale: int) -> int:
    """9 for scales 2^n, 8 for 3^n (JAX ``hat.py:412-415``)."""
    return 9 if (scale & (scale - 1)) == 0 else 8


class HAT(nn.Module):
    """(B, num_channels, H, W) -> (B, num_channels, sH, sW); the JAX
    package's constructor arguments (``window_size=0``: the scale's default
    window), weights drawn as the JAX package inits them
    (``nn.blocks.materialize``).  Any H, W: the input is reflect-padded to
    a window multiple and the output cropped back.  ``gelu``: "tanh" (the
    JAX package's) or "exact" (the published model's), every GELU of the
    model; ``share_upsample``: one conv for every x2 stage (the JAX
    package's), or a conv per stage (the published model's)."""

    def __init__(self, scale: int = 4, num_channels: int = 3,
                 embed_dim: int = 96,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 window_size: int = 0, overlap_ratio: float = 0.5,
                 mlp_ratio: float = 4.0, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01,
                 num_feat: int = 64, gelu: str = "tanh",
                 share_upsample: bool = True, *, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        exact = _exact(gelu)
        self.scale = scale
        self.window = window_size or default_window(scale)
        with torch.device("meta"):  # skip torch's default init
            self.conv_first = conv(num_channels, embed_dim)
            self.patch_embed = nn.Module()
            self.patch_embed.norm = _layer_norm(embed_dim)
            self.layers = nn.ModuleList(
                RHAG(embed_dim, depth, heads, self.window, overlap_ratio,
                     mlp_ratio, compress_ratio, squeeze_factor, conv_scale,
                     exact)
                for depth, heads in zip(depths, num_heads))
            self.norm = _layer_norm(embed_dim)
            self.conv_after_body = conv(embed_dim, embed_dim)
            self.conv_before_upsample = ConvBlock(embed_dim, num_feat,
                                                  activation="lrelu01")
            self.upsample = nn.Module()
            self.upsample.upsampling = UpsampleHead(
                num_feat, scale, activation=None,
                share_stages=share_upsample)
            self.conv_last = conv(num_feat, num_channels)
        materialize(self, seed)
        # the RGB mean shift, in the input's dtype (not in the state dict)
        self.register_buffer("mean", torch.tensor(MEAN).reshape(1, 3, 1, 1),
                             persistent=False)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        win = self.window
        h0, w0 = x.shape[2:]
        ph, pw = (win - h0 % win) % win, (win - w0 % win) % win
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        mean = self.mean.to(x.dtype)
        feat = self.conv_first(x - mean)
        y = self.patch_embed.norm(feat.permute(0, 2, 3, 1))
        for layer in self.layers:
            y = layer(y)
        y = self.conv_after_body(self.norm(y).permute(0, 3, 1, 2))
        feat = self.conv_before_upsample(feat + y)
        out = self.conv_last(self.upsample.upsampling(feat)) + mean
        if ph or pw:
            out = out[:, :, :h0 * self.scale, :w0 * self.scale]
        return out
