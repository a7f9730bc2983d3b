"""SwinUNETR: a shifted-window transformer encoder with a residual conv
decoder (Hatamizadeh et al., arXiv:2201.01266; MONAI's
``monai.networks.nets.SwinUNETR``). Only the port has it: the JAX package
holds no such net.

Encoder: a 2^3 stride-2 patch embedding (``patch_embed.proj``), then four
stages of dim C = ``feature_size`` * 2^s, each two blocks and a patch
merging. A block is ``x += attn(LN1(x))``, ``x += W2 GELU(W1 LN2(x))``;
its attention pads the far end of each axis with zeros to a multiple of
the window ``w = min(7, g)``, rolls by -3 in every second block on the axes
where g > 7, partitions the grid into windows of N tokens ((d, h, w)
row-major), runs ``qkv``, the windowed attention with the relative
position bias and the shift mask (``ops/window_attn.py``: kernels on the
card) and ``proj``, and undoes the partition, the roll and the pad. The
merging concatenates the eight stride-2 sub-grids in ``product(range(2),
repeat=3)`` order, then ``LN(8C)`` and a bias-free ``Linear(8C, 2C)``
(MONAI's ``mergingv2``). The hidden states h0..h4 (the embedding and each
stage's merged output) are LayerNorm'd without affine.

Decoder: ``RB`` is MONAI's ``UnetResBlock`` (two bias-free 3^3 convs, each
instance-normalised, LeakyReLU 0.01, a bias-free 1^3 conv plus instance
norm on the residual where the channels change), ``Up`` its
``UnetrUpBlock`` (a bias-free 2^3 stride-2 transposed conv, the concat
with the skip, an RB). ``encoder1`` takes the input, ``encoder2..4`` h0..h2,
``encoder10`` h4; ``decoder5..1`` go up from h4 with the skips h3, enc3,
enc2, enc1 and enc0; ``out`` is a 1^3 conv with bias.

Every 3^3 conv is ``layers.Conv3x3x3`` (kernels B and C on the card; the
first, from one channel, ``F.conv3d``); the patch embedding, the 1^3 convs
and the transposed convs are cuDNN's. Activations are in the compute dtype
(bf16) and channels_last_3d on the card, the transformer's tokens the
same memory viewed as (B, D, H, W, C); LayerNorm, the instance norms'
statistics and the softmax run in f32; parameters stay f32. Every
extent must be a multiple of 32 (the patch embedding and four merges). The
net has no dropout (MONAI's rates default to 0) and no space split.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bcp_tpu_torch.models.layers import (Conv3d, Conv3x3x3, ConvTranspose3d,
                                         InstanceNorm, LayerNorm, Linear)
from bcp_tpu_torch.ops.window_attn import (HEAD_DIM, table_size,
                                           window_attention)

#: the extent every input axis must be a multiple of
DIVISOR = 32
#: MONAI's LayerNorm and instance-norm epsilon
EPS = 1e-5
#: LeakyReLU's negative slope
SLOPE = 0.01


def window_geometry(grid: Sequence[int], window: int, shifted: bool
                    ) -> Tuple[tuple, tuple, tuple]:
    """(window, shift, padded grid) of a block on ``grid``: the window
    clipped to the grid, the shift w // 2 on the axes where a shifted
    block's grid exceeds the window, each axis padded to whole windows
    (MONAI's ``get_window_size`` and its pad)."""
    win = tuple(min(window, g) for g in grid)
    shift = tuple(window // 2 if shifted and g > window else 0
                  for g in grid)
    padded = tuple(-(-g // w) * w for g, w in zip(grid, win))
    return win, shift, padded


def partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(B, P0, P1, P2, C) -> (B * windows, N, C), windows row-major."""
    b, p0, p1, p2, c = x.shape
    w0, w1, w2 = window
    x = x.view(b, p0 // w0, w0, p1 // w1, w1, p2 // w2, w2, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, w0 * w1 * w2, c)


def reverse(windows: torch.Tensor, window: Sequence[int], batch: int,
            padded: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`partition`."""
    (w0, w1, w2), (p0, p1, p2) = window, padded
    c = windows.shape[-1]
    x = windows.view(batch, p0 // w0, p1 // w1, p2 // w2, w0, w1, w2, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(batch, p0, p1, p2, c)


class WindowAttention(nn.Module):
    """MONAI's ``WindowAttention``: ``qkv``, the windowed attention with
    the (13^3, heads) relative position bias table, ``proj``."""

    def __init__(self, dim: int, heads: int, window: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table_size(window), heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, windows: torch.Tensor, padded, window, shift
                ) -> torch.Tensor:
        o = window_attention(self.qkv(windows),
                             self.relative_position_bias_table, padded,
                             window, shift)
        return self.proj(o)


class Mlp(nn.Module):
    """MONAI's ``MLPBlock``: ``linear2(GELU(linear1(x)))``."""

    def __init__(self, dim: int, hidden: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear1 = Linear(dim, hidden, dtype=dtype)
        self.linear2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x)))


class SwinBlock(nn.Module):
    """MONAI's ``SwinTransformerBlock`` on (B, D, H, W, C) tokens; the odd
    blocks of a stage are ``shifted``."""

    def __init__(self, dim: int, heads: int, window: int, shifted: bool,
                 mlp_ratio: float, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.window, self.shifted = window, shifted
        self.norm1 = LayerNorm(dim, EPS, dtype)
        self.attn = WindowAttention(dim, heads, window, dtype)
        self.norm2 = LayerNorm(dim, EPS, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        b, *grid, c = x.shape
        win, shift, padded = window_geometry(grid, self.window,
                                             self.shifted)
        pad = [p - g for g, p in zip(grid, padded)]
        if any(pad):
            x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        if any(shift):
            x = torch.roll(x, [-s for s in shift], dims=(1, 2, 3))
        o = self.attn(partition(x, win), padded, win, shift)
        x = reverse(o, win, b, padded)
        if any(shift):
            x = torch.roll(x, list(shift), dims=(1, 2, 3))
        if any(pad):
            x = x[:, :grid[0], :grid[1], :grid[2]]
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self._attend(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """MONAI's ``PatchMergingV2``: the eight stride-2 sub-grids
    concatenated, ``LN(8C)``, a bias-free ``Linear(8C, 2C)``."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm = LayerNorm(8 * dim, EPS, dtype)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                       itertools.product(range(2), repeat=3)], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """A stage: its blocks (every second one shifted), then the merging."""

    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 mlp_ratio: float, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, window, i % 2 == 1, mlp_ratio, dtype)
            for i in range(depth)])
        self.downsample = PatchMerging(dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


def hidden_state(x: torch.Tensor) -> torch.Tensor:
    """A (B, D, H, W, C) stage output LayerNorm'd over C without affine
    (f32 statistics), as a logical (B, C, D, H, W) view (channels_last_3d
    memory)."""
    sdt = torch.promote_types(torch.float32, x.dtype)
    y = F.layer_norm(x.to(sdt), x.shape[-1:], eps=EPS).to(x.dtype)
    return y.permute(0, 4, 1, 2, 3)


class SwinViT(nn.Module):
    """MONAI's ``SwinTransformer``: the patch embedding and four stages;
    ``forward`` returns the hidden states h0..h4 (B, C, D, H, W)."""

    def __init__(self, n_channels: int, feature_size: int,
                 depths: Sequence[int], heads: Sequence[int], window: int,
                 patch: int, mlp_ratio: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv3d(n_channels, feature_size, patch,
                                       stride=patch, dtype=dtype)
        for s, (depth, h) in enumerate(zip(depths, heads)):
            self.add_module(f"layers{s + 1}", nn.ModuleList([BasicLayer(
                feature_size * 2 ** s, depth, h, window, mlp_ratio,
                dtype)]))

    def forward(self, x: torch.Tensor):
        z = self.patch_embed.proj(x).permute(0, 2, 3, 4, 1)
        out = [hidden_state(z)]
        for s in range(4):
            z = getattr(self, f"layers{s + 1}")[0](z)
            out.append(hidden_state(z))
        return out


def card_refusal(model: nn.Module) -> Optional[str]:
    """Why the window attention kernels cannot run ``model`` (a
    :class:`SwinUNETR`) on the card, or None: they take the bf16 compute
    dtype and heads of 16 channels (``feature_size`` 48 at the published
    heads 3-6-12-24)."""
    if model.compute_dtype != torch.bfloat16:
        return (f"the window attention kernels take the bf16 compute "
                f"dtype, not {model.compute_dtype}")
    widths = sorted({m.qkv.in_features // m.heads for m in model.modules()
                     if isinstance(m, WindowAttention)})
    if widths != [HEAD_DIM]:
        return (f"the window attention kernels take heads of {HEAD_DIM} "
                f"channels, not {widths}")
    return None


class ResBlock(nn.Module):
    """MONAI's ``UnetResBlock`` (kernel 3, stride 1, instance norm without
    affine, LeakyReLU 0.01, bias-free convs)."""

    def __init__(self, n_in: int, n_out: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv3x3x3(n_in, n_out, dtype=dtype, bias=False)
        self.conv2 = Conv3x3x3(n_out, n_out, dtype=dtype, bias=False)
        self.conv3 = (Conv3d(n_in, n_out, 1, bias=False, dtype=dtype)
                      if n_in != n_out else None)
        self.norm = InstanceNorm(EPS, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.norm(self.conv1(x)), SLOPE)
        y = self.norm(self.conv2(y))
        r = x if self.conv3 is None else self.norm(self.conv3(x))
        return F.leaky_relu(y + r, SLOPE)


class UpBlock(nn.Module):
    """MONAI's ``UnetrUpBlock``: a bias-free 2^3 stride-2 transposed conv,
    the concat with the skip, a :class:`ResBlock` from twice ``n_out``."""

    def __init__(self, n_in: int, n_out: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.transp_conv = ConvTranspose3d(n_in, n_out, 2, stride=2,
                                           bias=False, dtype=dtype)
        self.conv_block = ResBlock(2 * n_out, n_out, dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = self.transp_conv(x)
        return self.conv_block(torch.cat([up, skip.to(up.dtype)], dim=1))


class SwinUNETR(nn.Module):
    """SwinUNETR. ``forward(x)`` takes (B, n_channels, X, Y, Z), each
    extent a multiple of 32, and returns (logits in f32, f64 for f64, the
    last decoder feature), as ``layers.logits_of`` takes them."""

    def __init__(self, n_channels: int = 1, n_classes: int = 2,
                 feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 2,
                 mlp_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        fs = feature_size
        self.compute_dtype = dtype
        self.swinViT = SwinViT(n_channels, fs, depths, num_heads,
                               window_size, patch_size, mlp_ratio, dtype)
        self.encoder1 = ResBlock(n_channels, fs, dtype)
        self.encoder2 = ResBlock(fs, fs, dtype)
        self.encoder3 = ResBlock(2 * fs, 2 * fs, dtype)
        self.encoder4 = ResBlock(4 * fs, 4 * fs, dtype)
        self.encoder10 = ResBlock(16 * fs, 16 * fs, dtype)
        self.decoder5 = UpBlock(16 * fs, 8 * fs, dtype)
        self.decoder4 = UpBlock(8 * fs, 4 * fs, dtype)
        self.decoder3 = UpBlock(4 * fs, 2 * fs, dtype)
        self.decoder2 = UpBlock(2 * fs, fs, dtype)
        self.decoder1 = UpBlock(fs, fs, dtype)
        self.out = Conv3d(fs, n_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if any(s % DIVISOR for s in x.shape[2:]):
            raise ValueError(
                f"SwinUNETR takes extents that {DIVISOR} divides (a patch "
                f"embedding of 2, then four 2x merges); got "
                f"{tuple(x.shape[2:])}")
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last_3d)
        h = self.swinViT(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(h[0])
        enc2 = self.encoder3(h[1])
        enc3 = self.encoder4(h[2])
        d = self.decoder5(self.encoder10(h[4]), h[3])
        d = self.decoder4(d, enc3)
        d = self.decoder3(d, enc2)
        d = self.decoder2(d, enc1)
        d = self.decoder1(d, enc0)
        logits = self.out(d)
        return logits.to(torch.promote_types(torch.float32, logits.dtype)), d
