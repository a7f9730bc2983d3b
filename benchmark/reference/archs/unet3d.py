"""The residual 3-D U-Net (`networks/Unet3D.py:8-133` of
DeepMed-Lab-ECNU/BCP) in plain PyTorch, the reference of configurations
whose ``reference_net`` is ``"unet3d"``; widths ``feat_channels`` (five)
and ``n_classes``. Parameter names follow the module paths
``conv_blk1.conv1`` ... ``one_conv_0``. The transposed convs follow the
SAME padding of the configuration's source (2n planes out of n: torch's
unpadded transposed conv, cropped to its first 2n planes)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nets import (QConv, QConvTranspose, drop_channels,
                                      round_outputs, rounded)


class ResBlock(nn.Module):
    """`Conv3DBlock`: 2 x (3^3 conv, BN, ReLU) plus a bias-free 1^3 conv
    of the input."""

    def __init__(self, n_in: int, n_out: int, q):
        super().__init__()
        self.conv1 = QConv(n_in, n_out, 3, padding=1, quantize=q)
        self.bn1 = nn.BatchNorm3d(n_out)
        self.conv2 = QConv(n_out, n_out, 3, padding=1, quantize=q)
        self.bn2 = nn.BatchNorm3d(n_out)
        self.residual = QConv(n_in, n_out, 1, bias=False, quantize=q)

    def forward(self, x):
        q = self.conv1.quantize
        y = rounded(F.relu(self.bn1(self.conv1(x))), q)
        y = rounded(F.relu(self.bn2(self.conv2(y))), q)
        return y + self.residual(x)


class Deconv(nn.Module):
    def __init__(self, n_in: int, n_out: int, q):
        super().__init__()
        self.deconv = QConvTranspose(n_in, n_out, 3, stride=2, quantize=q,
                                     crop=True)

    def forward(self, x):
        return rounded(F.relu(self.deconv(x)), self.deconv.quantize)


class RefUNet3D(nn.Module):
    """The residual 3-D U-Net. ``forward(x, keeps)``: ``keeps`` is None or
    the keep masks of the dropouts after the level-3 and level-2 decoder
    blocks, in that order. Returns the logits."""

    def __init__(self, feat: Sequence[int] = (64, 256, 256, 512, 1024),
                 n_classes: int = 2, quantize: Optional[str] = None):
        super().__init__()
        fc = tuple(feat)
        ins = (1,) + fc[:4]
        for i in range(5):
            self.add_module(f"conv_blk{i + 1}", ResBlock(ins[i], fc[i],
                                                         quantize))
        for i in (4, 3, 2, 1):
            self.add_module(f"deconv_blk{i}", Deconv(fc[i], fc[i - 1],
                                                     quantize))
            self.add_module(f"dec_conv_blk{i}",
                            ResBlock(2 * fc[i - 1], fc[i - 1], quantize))
        self.one_conv_0 = QConv(fc[0], n_classes, 1, quantize=quantize)

    def forward(self, x, keeps: Optional[Sequence[torch.Tensor]] = None):
        drops = dict(zip((3, 2), keeps)) if keeps is not None else {}
        feats = [self.conv_blk1(x)]
        for i in range(2, 6):
            feats.append(getattr(self, f"conv_blk{i}")(
                F.max_pool3d(feats[-1], 2, 2)))
        d = feats[4]
        for i in (4, 3, 2, 1):
            up = getattr(self, f"deconv_blk{i}")(d)
            d = getattr(self, f"dec_conv_blk{i}")(
                torch.cat([up, feats[i - 1]], dim=1))
            if i in drops:
                d = drop_channels(d, drops[i])
        return self.one_conv_0(d)


def build(widths: dict, quantize: Optional[str] = None) -> nn.Module:
    return round_outputs(RefUNet3D(widths["feat_channels"],
                                   widths["n_classes"], quantize),
                         quantize, (nn.BatchNorm3d, nn.ReLU))


def dropout_shapes(widths: dict, patch, n: int):
    fc = widths["feat_channels"]
    return [((n, fc[2]), 0.5), ((n, fc[1]), 0.5)]
