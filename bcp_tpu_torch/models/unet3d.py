"""UNet3D, the residual 3-D U-Net of the model zoo, and ``UNet_DTC`` as its
two-head form.

Counterpart of ``bcp_tpu/models/unet3d.py`` (reference
`networks/Unet3D.py:8-133`): five levels of double-conv blocks
(``feat_channels`` (64, 256, 256, 512, 1024)) with bias-free 1^3 residual
adapters, 2^3 max pooling down, 3^3 stride-2 transposed convs up, concat
skips (upsampled first), channel dropout 0.5 after the two middle decoder
blocks in train mode, 1^3 heads. With ``n_heads=2`` the outputs are
``(tanh(head 0), head 1)``, else ``(logits, decoder feature)``; the heads
come out in f32, as the JAX package casts them.

The module names are the flax module paths (``conv_blk1.conv1``,
``deconv_blk4.deconv``, ``one_conv_0``), so ``convert.state_dict_from_flax``
carries the JAX package's variables over by name; no reference ``.pth``
layout is known for this net (the JAX converter maps none).

Every 3^3 conv is the port's one conv module, ``layers.Conv3x3x3``, as in
the V-Net: a stride-1 SAME conv whose Ci and Co are multiples of 16 runs
kernel B forward and as dx and kernel C for dW on the card, the rest (the
Ci = 1 first conv) ``F.conv3d``. The JAX package leaves these convs to
XLA (`layers.py:40-44`, a plain ``nn.Conv``), and cuDNN would be the
like-for-like choice here; the port keeps one conv module for every 3-D
net so that the zoo's widths, up to 1024 channels at the bottom level,
run on the same kernels, pickers and launch counts as the V-Net's. The
transposed convs, the 1^3 adapters and heads are cuDNN's.

Tensors are logical NCDHW and run channels_last_3d on the card. The
BatchNorms are :class:`~bcp_tpu_torch.models.layers.TorchBatchNorm`, so
``bn_groups`` and ``frozen_running_stats`` apply as in the V-Net; the
JAX net has no ``bn_groups`` field, so the self-train step's concat
forwards normalise the whole concat batch as one (the class sets no
``grouped``, ``train.steps.concat_groups``).

Under a space split (``parallel.mesh``) the five levels run on x slabs or
replicated as :class:`~bcp_tpu_torch.models.layers.SpaceLevels` decides:
the 2^3 max pool is slab-local where the slab is even, and the down step
at the first odd slab gathers (LA's 112 planes: level 3 at S = 2, level 2
at S = 4); the 3^3 convs take the halo, the 1^3 adapters and heads are
local, the concat skips line up with the slabs, and the transposed convs
take their neighbour's plane (``layers.ConvTransposeSame3d``). The channel
dropout's (N, C) mask is the same on every slab.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bcp_tpu_torch.models.layers import (ChannelDropout, Conv3d, Conv3x3x3,
                                         ConvTransposeSame3d, SpaceLevels,
                                         TorchBatchNorm, conv_bn_relu)

#: the max-pool down steps
DOWNS = 4


class Conv3DBlock(nn.Module):
    """`Conv3DBlock` (`unet3d.py:26-48`): 2 x (3^3 conv, BN, ReLU), plus
    a bias-free 1^3 conv of the input with ``residual``; each (conv, BN,
    ReLU) is ``layers.conv_bn_relu``."""

    def __init__(self, n_in: int, n_out: int, residual: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv3x3x3(n_in, n_out, dtype=dtype)
        self.bn1 = TorchBatchNorm(n_out, dtype=dtype)
        self.conv2 = Conv3x3x3(n_out, n_out, dtype=dtype)
        self.bn2 = TorchBatchNorm(n_out, dtype=dtype)
        self.residual = (Conv3d(n_in, n_out, 1, bias=False, dtype=dtype)
                         if residual else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn_relu(self.conv1, self.bn1, x)
        y = conv_bn_relu(self.conv2, self.bn2, y)
        return y + self.residual(x) if self.residual is not None else y


class Deconv3DBlock(nn.Module):
    """`Deconv3DBlock` (`unet3d.py:51-63`): flax's SAME 3^3 stride-2
    transposed conv, ReLU."""

    def __init__(self, n_in: int, n_out: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.deconv = ConvTransposeSame3d(n_in, n_out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.deconv(x))


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool3d(x, 2, 2)


class UNet3D(nn.Module):
    """`UNet3D` (`unet3d.py:65-129`). ``forward(x)`` takes (B, n_channels,
    X, Y, Z), each extent a multiple of 16."""

    def __init__(self, n_channels: int = 1, n_classes: int = 2,
                 feat_channels: Sequence[int] = (64, 256, 256, 512, 1024),
                 residual: bool = True, n_heads: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        fc = tuple(feat_channels)
        self.compute_dtype = dtype
        self.n_heads = n_heads
        ins = (n_channels,) + fc[:4]
        for i in range(5):
            self.add_module(f"conv_blk{i + 1}",
                            Conv3DBlock(ins[i], fc[i], residual, dtype))
        # the decoder, top-down in the forward's order (its dropouts too)
        for i in (4, 3, 2, 1):
            self.add_module(f"deconv_blk{i}",
                            Deconv3DBlock(fc[i], fc[i - 1], dtype))
            self.add_module(f"dec_conv_blk{i}",
                            Conv3DBlock(2 * fc[i - 1], fc[i - 1], residual,
                                        dtype))
            if i in (3, 2):
                self.add_module(f"drop{i}", ChannelDropout(0.5))
        for h in range(n_heads):
            self.add_module(f"one_conv_{h}",
                            Conv3d(fc[0], n_classes, 1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last_3d)
        lv = SpaceLevels(x.shape[2], DOWNS)
        feats = [lv.run(0, self.conv_blk1, x)]
        for i in range(1, 5):
            feats.append(lv.run(i, getattr(self, f"conv_blk{i + 1}"),
                                lv.down(i - 1, _pool, feats[-1])))
        d = feats[4]
        for i in (4, 3, 2, 1):
            up = lv.up(i - 1, getattr(self, f"deconv_blk{i}"), d)
            d = lv.run(i - 1, getattr(self, f"dec_conv_blk{i}"),
                       torch.cat([up, feats[i - 1].to(up.dtype)], dim=1))
            if i in (3, 2):
                d = getattr(self, f"drop{i}")(d)
        heads = [getattr(self, f"one_conv_{h}")(d).float()
                 for h in range(self.n_heads)]
        if self.n_heads == 1:
            return heads[0], d
        return torch.tanh(heads[0]), heads[1]
