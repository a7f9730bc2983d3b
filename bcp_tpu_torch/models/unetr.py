"""UNETR, the ViT-encoder U-Net of the model zoo, and ``UNETR_DTC`` as its
dual-task form.

Counterpart of ``bcp_tpu/models/unetr.py`` (reference
`networks/unetr.py:54-407`): a stride-16 patch embedding plus learned,
zero-initialised position embeddings; ``num_layers`` pre-LN transformer
blocks (multi-head attention with attention and projection dropout, a ReLU
MLP of ``d_ff``); the hidden states after ``ext_layers`` go back to the
patch grid and a conv / transposed-conv decoder with concat skips takes
them to a 1^3 head. With ``dtc`` a second head on the same decoder feature
gives ``(tanh(logits), seg2)``, else ``(logits, z0)``; outputs in f32.

The attention is the JAX package's: q k^T with f32 accumulation over the
compute dtype's inputs, / sqrt(head dim), softmax and dropout in f32, then
probs in the compute dtype times v with f32 accumulation. No Pallas kernel
runs here in the JAX package, so these are plain matmuls. The patch
embedding (16^3, stride 16) and the 2^3 transposed convs are cuDNN's; the
3^3 convs are ``layers.Conv3x3x3``, kernels B and C where Ci and Co are
multiples of 16, as in UNet3D (``models/unet3d.py`` says why).

The position embeddings fix the input extent: ``img_shape`` must equal
the window the model sees, and a forward of another extent is refused
(the JAX package's test CLIs never pass ``img_shape``, so theirs fail at
LA's 112x112x80 patch). The module names are the flax paths
(``layer3.attn.query``, ``decoder9.conv``, ``dec9_conv0.bn``), for
``convert.state_dict_from_flax``. ``d_ff``, ``width_scale`` and
``ext_layers`` are the JAX package's knobs for small fixtures.

Under a space split (``parallel.mesh``) the input is an x slab. The patch
embedding runs on it where the token grid's planes divide by S (at 128^3,
P = 16 and S <= 8 the slab is a whole number of patches), else on the
gathered input; the token planes are gathered over the space group before
the position embeddings, and the transformer runs replicated on the S
ranks of a sample, its dropouts drawing the whole draw on each. The four
extracted grids go back to x slabs at the first decoder level whose
planes divide by S (:class:`TokenLevels`: the token grid itself at 128^3,
the level above a 1-plane grid), and the levels from there on run on
slabs: the 2^3 transposed convs are slab-local, the 3^3 convs take the
halo, ``decoder0_*`` runs on the input slab and the head's concat lines
up with it. A level below runs replicated and its up step takes the slab
back, as ``layers.SpaceLevels`` does for the U-shaped nets.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bcp_tpu_torch.models.layers import (Conv3d, Conv3x3x3, ConvTranspose3d,
                                         Dropout, LayerNorm, Linear,
                                         TorchBatchNorm, conv_bn_relu)
from bcp_tpu_torch.parallel import mesh


class SelfAttention(nn.Module):
    """`SelfAttention` (`unetr.py:27-58`) over (N, T, D) tokens."""

    def __init__(self, num_heads: int, embed_dim: int, dropout: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        D = embed_dim
        self.query = Linear(D, D, dtype=dtype)
        self.key = Linear(D, D, dtype=dtype)
        self.value = Linear(D, D, dtype=dtype)
        self.attn_dropout = Dropout(dropout)
        self.out = Linear(D, D, dtype=dtype)
        self.proj_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, T, D = x.shape
        H = self.num_heads
        hd = D // H

        def heads(t):       # (N, T, D) -> (N, H, T, hd)
            return t.reshape(N, T, H, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), \
            heads(self.value(x))
        acc = torch.promote_types(torch.float32, q.dtype)
        scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
        probs = torch.softmax(scores / math.sqrt(hd), dim=-1)
        probs = self.attn_dropout(probs)
        ctx = torch.matmul(probs.to(v.dtype).to(acc), v.to(acc))
        ctx = ctx.transpose(1, 2).reshape(N, T, D).to(x.dtype)
        return self.proj_dropout(self.out(ctx))


class TransformerBlock(nn.Module):
    """`TransformerBlock` (`unetr.py:61-85`): pre-LN attention and pre-LN
    ReLU MLP, each with its residual add; the MLP's dropout is 0.1."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float,
                 d_ff: int = 2048, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.attention_norm = LayerNorm(embed_dim, 1e-6, dtype)
        self.attn = SelfAttention(num_heads, embed_dim, dropout, dtype)
        self.mlp_norm = LayerNorm(embed_dim, 1e-6, dtype)
        self.w_1 = Linear(embed_dim, d_ff, dtype=dtype)
        self.mlp_dropout = Dropout(0.1)
        self.w_2 = Linear(d_ff, embed_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(self.attention_norm(x)) + x
        y = self.mlp_dropout(F.relu(self.w_1(self.mlp_norm(x))))
        return self.w_2(y) + x


class ConvBNReLU(nn.Module):
    """`ConvBNReLU` (`unetr.py:88-99`): 3^3 conv, BN, ReLU."""

    def __init__(self, n_in: int, n_out: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv3x3x3(n_in, n_out, dtype=dtype)
        self.bn = TorchBatchNorm(n_out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_relu(self.conv, self.bn, x)


class DeconvBlock(nn.Module):
    """`DeconvBlock` (`unetr.py:102-117`): 2^3 stride-2 transposed conv,
    3^3 conv, BN, ReLU."""

    def __init__(self, n_in: int, n_out: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.deconv = ConvTranspose3d(n_in, n_out, 2, stride=2, dtype=dtype)
        self.conv = Conv3x3x3(n_out, n_out, dtype=dtype)
        self.bn = TorchBatchNorm(n_out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_relu(self.conv, self.bn, self.deconv(x))


def _deconv2x(n_in: int, n_out: int, dtype) -> ConvTranspose3d:
    return ConvTranspose3d(n_in, n_out, 2, stride=2, dtype=dtype)


class TokenLevels:
    """Which of UNETR's decoder levels run on x slabs under a space split:
    level 0 is the token grid (``planes`` in x), level L its 2^L-fold
    upsample, level 4 the input's extent. Levels from the first whose
    planes divide by S run on slabs, those below replicated; outside a
    split every method is the plain call."""

    def __init__(self, planes: int):
        self.on = mesh.space_split()
        S = mesh.space_size()
        #: the first sliced level
        self.first = next(L for L in range(5) if (planes << L) % S == 0) \
            if self.on else 0

    def sliced(self, level: int) -> bool:
        return self.on and level >= self.first

    def grid(self, z: torch.Tensor) -> torch.Tensor:
        """An extracted grid (level 0, whole on every rank): this rank's
        slab where the token level is sliced."""
        return mesh.shard_space(z, 2) if self.sliced(0) else z

    def run(self, level: int, fn, *args):
        """``fn(*args)`` at ``level``: the split on there or off."""
        if not self.on:
            return fn(*args)
        with mesh.split(self.sliced(level)):
            return fn(*args)

    def up(self, level: int, fn, x: torch.Tensor) -> torch.Tensor:
        """The up step ``fn`` (a 2^3 transposed conv, alone or with its
        3^3 conv) from ``level - 1`` to ``level``: on the slabs where the
        level below is sliced, else replicated and then this rank's
        slab where ``level`` is the first sliced one."""
        y = self.run(level - 1, fn, x)
        return mesh.shard_space(y, 2) if self.on and level == self.first \
            and level > 0 else y


class UNETR(nn.Module):
    """`UNETR` (`unetr.py:126-230`). ``forward(x)`` takes (B, n_channels,
    *img_shape)."""

    def __init__(self, img_shape: Sequence[int] = (128, 128, 128),
                 n_channels: int = 1, n_classes: int = 2,
                 embed_dim: int = 768, patch_size: int = 16,
                 num_heads: int = 12, num_layers: int = 12,
                 dropout: float = 0.1,
                 ext_layers: Sequence[int] = (3, 6, 9, 12),
                 dtc: bool = False, d_ff: int = 2048,
                 width_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.img_shape = tuple(img_shape)
        self.patch_size = P = patch_size
        self.embed_dim = D = embed_dim
        self.num_layers = num_layers
        self.ext_layers = tuple(ext_layers)
        self.dtc = dtc
        self.compute_dtype = dtype
        self.patch_dim = tuple(s // P for s in self.img_shape)

        def w(f: int) -> int:
            return max(4, round(f * width_scale))

        def conv(n_in, n_out):
            return ConvBNReLU(n_in, n_out, dtype)

        self.patch_embeddings = Conv3d(n_channels, D, P, stride=P,
                                       dtype=dtype)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, math.prod(self.patch_dim), D))
        self.embed_dropout = Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerBlock(
                D, num_heads, dropout, d_ff, dtype))
        self.decoder12_upsampler = _deconv2x(D, w(512), dtype)
        self.decoder9 = DeconvBlock(D, w(512), dtype)
        self.dec9_conv0 = conv(2 * w(512), w(512))
        self.dec9_conv1 = conv(w(512), w(512))
        self.dec9_conv2 = conv(w(512), w(512))
        self.decoder9_upsampler = _deconv2x(w(512), w(256), dtype)
        self.decoder6_a = DeconvBlock(D, w(512), dtype)
        self.decoder6_b = DeconvBlock(w(512), w(256), dtype)
        self.dec6_conv0 = conv(2 * w(256), w(256))
        self.dec6_conv1 = conv(w(256), w(256))
        self.decoder6_upsampler = _deconv2x(w(256), w(128), dtype)
        self.decoder3_a = DeconvBlock(D, w(512), dtype)
        self.decoder3_b = DeconvBlock(w(512), w(256), dtype)
        self.decoder3_c = DeconvBlock(w(256), w(128), dtype)
        self.dec3_conv0 = conv(2 * w(128), w(128))
        self.dec3_conv1 = conv(w(128), w(128))
        self.decoder3_upsampler = _deconv2x(w(128), w(64), dtype)
        self.decoder0_a = conv(n_channels, w(32))
        self.decoder0_b = conv(w(32), w(64))
        self.head_a = conv(2 * w(64), w(64))
        self.head_b = conv(w(64), w(64))
        self.out_conv = Conv3d(w(64), n_classes, 1, dtype=dtype)
        if dtc:
            self.head2_a = conv(2 * w(64), w(64))
            self.head2_b = conv(w(64), w(64))
            self.out_conv2 = Conv3d(w(64), n_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        extent = (x.shape[2] * mesh.space_size() if mesh.space_split()
                  else x.shape[2], *x.shape[3:])
        if extent != self.img_shape:
            raise ValueError(
                f"UNETR built for img_shape {self.img_shape} got a "
                f"{extent} input: its position embeddings fix "
                f"the extent, so build it with img_shape equal to the "
                f"window (a test CLI's patch_size)")
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last_3d)
        N, D = x.shape[0], self.embed_dim
        lv = TokenLevels(self.patch_dim[0])
        if lv.sliced(0):
            # the slab is whole patches: embed it, then gather the tokens
            grid = mesh.gather_space(self.patch_embeddings(x), 2)
        else:
            grid = self.patch_embeddings(mesh.gather_space(x, 2))
        with mesh.split(False):
            extracted = self._transformer(
                grid.flatten(2).transpose(1, 2))
        # (N, T, D) -> (N, D, *patch_dim): a channels_last_3d view
        z3, z6, z9, z12 = [lv.grid(z.transpose(1, 2).reshape(
            N, D, *self.patch_dim)) for z in extracted]

        z12 = lv.up(1, self.decoder12_upsampler, z12)
        y = torch.cat([lv.up(1, self.decoder9, z9), z12], dim=1)
        y = lv.run(1, lambda t: self.dec9_conv2(self.dec9_conv1(
            self.dec9_conv0(t))), y)
        z9 = lv.up(2, self.decoder9_upsampler, y)

        z6 = lv.up(2, self.decoder6_b, lv.up(1, self.decoder6_a, z6))
        y = lv.run(2, lambda t: self.dec6_conv1(self.dec6_conv0(t)),
                   torch.cat([z6, z9], dim=1))
        z6 = lv.up(3, self.decoder6_upsampler, y)

        z3 = lv.up(3, self.decoder3_c, lv.up(2, self.decoder3_b, lv.up(
            1, self.decoder3_a, z3)))
        y = lv.run(3, lambda t: self.dec3_conv1(self.dec3_conv0(t)),
                   torch.cat([z3, z6], dim=1))
        z3 = lv.up(4, self.decoder3_upsampler, y)

        # level 4, the input's extent, is always sliced under a split
        z0 = self.decoder0_b(self.decoder0_a(x))
        cat = torch.cat([z0, z3], dim=1)
        logits = self.out_conv(self.head_b(self.head_a(cat)))
        if self.dtc:
            seg2 = self.out_conv2(self.head2_b(self.head2_a(cat)))
            return torch.tanh(logits).float(), seg2.float()
        return logits.float(), z0

    def _transformer(self, tokens: torch.Tensor):
        """The embedded tokens (N, T, D) through the position embeddings
        and the blocks: the hidden states after ``ext_layers``."""
        h = self.embed_dropout(
            tokens + self.position_embeddings.to(tokens.dtype))
        extracted = []
        for i in range(self.num_layers):
            h = getattr(self, f"layer{i}")(h)
            if i + 1 in self.ext_layers:
                extracted.append(h)
        return extracted
