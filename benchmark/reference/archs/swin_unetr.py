"""SwinUNETR (Hatamizadeh et al., arXiv:2201.01266; MONAI's
``monai.networks.nets.SwinUNETR``) in plain PyTorch, the reference of
configurations whose ``reference_net`` is ``"swin_unetr"``; widths
``feature_size``, ``depths``, ``num_heads``, ``window_size``,
``patch_size``, ``mlp_ratio`` and ``n_classes``.

The net as MONAI's v2 modules compute it, channels first (B, C, D, H, W)
between the stages and (B, D, H, W, C) inside them: a 2^3 stride-2 patch
embedding with bias; four stages of two ``SwinTransformerBlock``s (pre-LN
window attention with the (13^3, heads) relative position bias table and,
in every second block, the cyclic shift by -3 with the region mask of -100
on the axes where the grid exceeds the window; the window clipped to a
grid at most 7 long, each axis padded with zeros at its far end to whole
windows before the shift; GELU MLP of ratio 4), each stage ending in a
patch merging; each hidden state LayerNorm'd without affine; the
``UnetResBlock`` / ``UnetrUpBlock`` decoder with bias-free convs, instance
norm without affine and LeakyReLU 0.01; a 1^3 output conv with bias.

Departures from MONAI, each for the comparison only:

- the patch merging is MONAI's ``mergingv2`` (the eight stride-2 sub-grids
  in ``product(range(2), repeat=3)`` order), as the configuration states;
  MONAI's default ``"merging"`` (its v0.9 module) is reported to read two
  of the eight slices twice, at the same shapes and costs;
- ``forward(x, keeps)`` takes the keep masks of the dropouts as the other
  reference nets do; there are none (every rate is 0), so ``keeps`` is
  ignored;
- the relative position index is not a buffer (the state_dict holds the
  parameters only, as the program's does) and the attention runs over
  chunks of windows, so that the reference fits on the card at 96^3;
- module names are the program's (``swinViT.layers1.0.blocks.0.attn.qkv``,
  ``encoder1.conv1``, ``decoder5.transp_conv``, ``out``), so one state_dict
  loads into both.

With ``quantize`` every value the program computes in its compute dtype
is rounded: each conv's and linear layer's input, weight and output
(:class:`QConv`, :class:`QConvTranspose`, :class:`QLinear`), q, k, v, P
and each head's output, and the outputs of the LayerNorms, GELUs,
instance norms and LeakyReLUs.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nets import (QConv, QConvTranspose, round_outputs,
                                      rounded)

#: windows of one attention chunk
CHUNK = 128
EPS = 1e-5


class QLinear(nn.Linear):
    """``nn.Linear`` whose input, weight and output may be rounded."""

    def __init__(self, *args, quantize: Optional[str] = None, **kw):
        super().__init__(*args, **kw)
        self.quantize = quantize

    def forward(self, x):
        q = self.quantize
        return rounded(F.linear(rounded(x, q), rounded(self.weight, q),
                                self.bias), q)


def relative_index(window: int) -> torch.Tensor:
    """MONAI's ``relative_position_index`` of a window^3 window."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(window)] * 3, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (window - 1)
    s = 2 * window - 1
    return rel[..., 0] * s * s + rel[..., 1] * s + rel[..., 2]


def window_partition(x: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows: torch.Tensor, ws: Sequence[int], b: int,
                   dims: Sequence[int]) -> torch.Tensor:
    d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1],
                     ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def compute_mask(dims: Sequence[int], ws: Sequence[int],
                 ss: Sequence[int], device) -> torch.Tensor:
    """MONAI's ``compute_mask``: (windows, N, N), 0 within a region and
    -100 across."""
    img = torch.zeros((1, *dims, 1), device=device)
    cnt = 0
    for d in (slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None)):
        for h in (slice(-ws[1]), slice(-ws[1], -ss[1]),
                  slice(-ss[1], None)):
            for w in (slice(-ws[2]), slice(-ws[2], -ss[2]),
                      slice(-ss[2], None)):
                img[:, d, h, w, :] = cnt
                cnt += 1
    mw = window_partition(img, ws).squeeze(-1)
    m = mw.unsqueeze(1) - mw.unsqueeze(2)
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


def window_geometry(grid, window: int, shifted: bool):
    """MONAI's ``get_window_size`` and its pad: (window, shift, padded)."""
    ws = tuple(min(window, g) for g in grid)
    ss = tuple(window // 2 if shifted and g > window else 0 for g in grid)
    padded = tuple(int(np.ceil(g / w)) * w for g, w in zip(grid, ws))
    return ws, ss, padded


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, q):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.quantize = q
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, heads))
        self.index = relative_index(window)
        self.qkv = QLinear(dim, 3 * dim, quantize=q)
        self.proj = QLinear(dim, dim, quantize=q)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        bw, n, c = x.shape
        q_ = self.quantize
        idx = self.index[:n, :n].reshape(-1).to(x.device)
        bias = self.relative_position_bias_table[idx].reshape(
            n, n, -1).permute(2, 0, 1)
        outs = []
        for lo in range(0, bw, CHUNK):
            xc = x[lo:lo + CHUNK]
            qkv = self.qkv(xc).reshape(xc.shape[0], n, 3, self.heads,
                                       c // self.heads).permute(2, 0, 3, 1, 4)
            q = rounded(qkv[0] * self.scale, q_)
            k, v = rounded(qkv[1], q_), rounded(qkv[2], q_)
            attn = q @ k.transpose(-2, -1) + bias[None]
            if mask is not None:
                rows = torch.arange(lo, lo + xc.shape[0],
                                    device=x.device) % mask.shape[0]
                attn = attn + mask[rows][:, None]
            attn = rounded(torch.softmax(attn, dim=-1), q_)
            o = rounded(attn @ v, q_)
            outs.append(o.transpose(1, 2).reshape(xc.shape[0], n, c))
        return self.proj(torch.cat(outs))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shifted, mlp_ratio, q):
        super().__init__()
        self.window, self.shifted = window, shifted
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = WindowAttention(dim, heads, window, q)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp = nn.Module()
        self.mlp.linear1 = QLinear(dim, int(dim * mlp_ratio), quantize=q)
        self.mlp.act = nn.GELU()
        self.mlp.linear2 = QLinear(int(dim * mlp_ratio), dim, quantize=q)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        b, d, h, w, c = x.shape
        ws, ss, (dp, hp, wp) = window_geometry((d, h, w), self.window,
                                               self.shifted)
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h, 0, dp - d))
        mask = None
        if any(ss):
            x = torch.roll(x, shifts=(-ss[0], -ss[1], -ss[2]),
                           dims=(1, 2, 3))
            mask = compute_mask((dp, hp, wp), ws, ss, x.device)
        o = self.attn(window_partition(x, ws), mask)
        x = window_reverse(o, ws, b, (dp, hp, wp))
        if any(ss):
            x = torch.roll(x, shifts=ss, dims=(1, 2, 3))
        x = shortcut + x[:, :d, :h, :w]
        m = self.mlp
        return x + m.linear2(m.act(m.linear1(self.norm2(x))))


class PatchMergingV2(nn.Module):
    def __init__(self, dim, q):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=EPS)
        self.reduction = QLinear(8 * dim, 2 * dim, bias=False, quantize=q)

    def forward(self, x):
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                       itertools.product(range(2), range(2), range(2))], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, heads, window, mlp_ratio, q):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, window, i % 2 == 1, mlp_ratio, q)
            for i in range(depth)])
        self.downsample = PatchMergingV2(dim, q)

    def forward(self, x):   # (B, C, D, H, W) -> the merged, the same form
        x = x.permute(0, 2, 3, 4, 1)
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x).permute(0, 4, 1, 2, 3)


class SwinViT(nn.Module):
    def __init__(self, fs, depths, heads, window, patch, mlp_ratio, q):
        super().__init__()
        self.quantize = q
        self.patch_embed = nn.Module()
        self.patch_embed.proj = QConv(1, fs, patch, stride=patch,
                                      quantize=q)
        for s, (depth, h) in enumerate(zip(depths, heads)):
            self.add_module(f"layers{s + 1}", nn.ModuleList([BasicLayer(
                fs * 2 ** s, depth, h, window, mlp_ratio, q)]))

    def proj_out(self, x):
        """The hidden state LayerNorm'd over the channels, no affine."""
        y = F.layer_norm(x.permute(0, 2, 3, 4, 1), [x.shape[1]], eps=EPS)
        return rounded(y.permute(0, 4, 1, 2, 3), self.quantize)

    def forward(self, x):
        z = self.patch_embed.proj(x)
        out = [self.proj_out(z)]
        for s in range(4):
            z = getattr(self, f"layers{s + 1}")[0](z)
            out.append(self.proj_out(z))
        return out


class ResBlock(nn.Module):
    """``UnetResBlock``: kernel 3, stride 1, instance norm, LeakyReLU."""

    def __init__(self, n_in, n_out, q):
        super().__init__()
        self.conv1 = QConv(n_in, n_out, 3, padding=1, bias=False,
                           quantize=q)
        self.conv2 = QConv(n_out, n_out, 3, padding=1, bias=False,
                           quantize=q)
        self.conv3 = (QConv(n_in, n_out, 1, bias=False, quantize=q)
                      if n_in != n_out else None)
        self.norm1 = nn.InstanceNorm3d(n_out, eps=EPS)
        self.norm2 = nn.InstanceNorm3d(n_out, eps=EPS)
        self.norm3 = nn.InstanceNorm3d(n_out, eps=EPS)
        self.lrelu1 = nn.LeakyReLU(0.01)
        self.lrelu2 = nn.LeakyReLU(0.01)

    def forward(self, x):
        y = self.lrelu1(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        r = x if self.conv3 is None else self.norm3(self.conv3(x))
        return self.lrelu2(y + r)


class UpBlock(nn.Module):
    """``UnetrUpBlock``: transposed conv, concat with the skip, RB."""

    def __init__(self, n_in, n_out, q):
        super().__init__()
        self.transp_conv = QConvTranspose(n_in, n_out, 2, stride=2,
                                          bias=False, quantize=q)
        self.conv_block = ResBlock(2 * n_out, n_out, q)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], 1))


class RefSwinUNETR(nn.Module):
    def __init__(self, feature_size=48, depths=(2, 2, 2, 2),
                 num_heads=(3, 6, 12, 24), window_size=7, patch_size=2,
                 mlp_ratio=4.0, n_classes=2, quantize=None):
        super().__init__()
        fs, q = feature_size, quantize
        self.swinViT = SwinViT(fs, depths, num_heads, window_size,
                               patch_size, mlp_ratio, q)
        self.encoder1 = ResBlock(1, fs, q)
        self.encoder2 = ResBlock(fs, fs, q)
        self.encoder3 = ResBlock(2 * fs, 2 * fs, q)
        self.encoder4 = ResBlock(4 * fs, 4 * fs, q)
        self.encoder10 = ResBlock(16 * fs, 16 * fs, q)
        self.decoder5 = UpBlock(16 * fs, 8 * fs, q)
        self.decoder4 = UpBlock(8 * fs, 4 * fs, q)
        self.decoder3 = UpBlock(4 * fs, 2 * fs, q)
        self.decoder2 = UpBlock(2 * fs, fs, q)
        self.decoder1 = UpBlock(fs, fs, q)
        self.out = QConv(fs, n_classes, 1, quantize=q)

    def forward(self, x, keeps=None):
        h = self.swinViT(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(h[0])
        enc2 = self.encoder3(h[1])
        enc3 = self.encoder4(h[2])
        d = self.decoder5(self.encoder10(h[4]), h[3])
        d = self.decoder4(d, enc3)
        d = self.decoder3(d, enc2)
        d = self.decoder2(d, enc1)
        return self.out(self.decoder1(d, enc0))


def build(widths: dict, quantize: Optional[str] = None) -> nn.Module:
    w = widths
    return round_outputs(RefSwinUNETR(
        w["feature_size"], tuple(w["depths"]), tuple(w["num_heads"]),
        w["window_size"], w["patch_size"], w["mlp_ratio"], w["n_classes"],
        quantize), quantize,
        (nn.LayerNorm, nn.GELU, nn.InstanceNorm3d, nn.LeakyReLU))


def dropout_shapes(widths: dict, patch, n: int):
    return []


def extra_flops(widths: dict, patch, n: int) -> int:
    """q k^T and p v over the padded windows of every block: 2 * 2 *
    windows * N^2 * C a block and sample."""
    w = widths
    total = 0
    for s, depth in enumerate(w["depths"]):
        grid = [p // (w["patch_size"] * 2 ** s) for p in patch]
        c = w["feature_size"] * 2 ** s
        for i in range(depth):
            ws, _, padded = window_geometry(grid, w["window_size"], i % 2)
            windows = int(np.prod([p // v for p, v in zip(padded, ws)]))
            tokens = int(np.prod(ws))
            total += 2 * 2 * windows * tokens * tokens * c * n
    return total
