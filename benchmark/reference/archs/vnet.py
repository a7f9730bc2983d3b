"""The BCP V-Net (`networks/VNet.py:145-290` of DeepMed-Lab-ECNU/BCP,
batchnorm, n_filters 16) in plain PyTorch, the reference of configurations
whose ``reference_net`` is ``"vnet"``; widths ``n_filters`` and
``n_classes``. Parameter names are the reference repository's. The
projection heads it builds and never uses are left out."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from benchmark.reference.nets import (QConv, QConvTranspose, drop_channels,
                                      round_outputs)


def _stage(n: int, n_in: int, n_out: int, q) -> nn.Sequential:
    ops = []
    for i in range(n):
        ops += [QConv(n_in if i == 0 else n_out, n_out, 3, padding=1,
                      quantize=q), nn.BatchNorm3d(n_out), nn.ReLU()]
    return nn.Sequential(*ops)


class _Block(nn.Module):
    def __init__(self, seq: nn.Sequential):
        super().__init__()
        self.conv = seq

    def forward(self, x):
        return self.conv(x)


def _conv_block(n, n_in, n_out, q):
    return _Block(_stage(n, n_in, n_out, q))


def _down(n_in, n_out, q):
    return _Block(nn.Sequential(QConv(n_in, n_out, 2, stride=2, quantize=q),
                                nn.BatchNorm3d(n_out), nn.ReLU()))


def _up(n_in, n_out, q):
    return _Block(nn.Sequential(
        QConvTranspose(n_in, n_out, 2, stride=2, quantize=q),
        nn.BatchNorm3d(n_out), nn.ReLU()))


class VNetEncoder(nn.Module):
    def __init__(self, nf: int, q):
        super().__init__()
        self.block_one = _conv_block(1, 1, nf, q)
        self.block_one_dw = _down(nf, 2 * nf, q)
        self.block_two = _conv_block(2, 2 * nf, 2 * nf, q)
        self.block_two_dw = _down(2 * nf, 4 * nf, q)
        self.block_three = _conv_block(3, 4 * nf, 4 * nf, q)
        self.block_three_dw = _down(4 * nf, 8 * nf, q)
        self.block_four = _conv_block(3, 8 * nf, 8 * nf, q)
        self.block_four_dw = _down(8 * nf, 16 * nf, q)
        self.block_five = _conv_block(3, 16 * nf, 16 * nf, q)


class VNetDecoder(nn.Module):
    def __init__(self, nf: int, n_classes: int, q):
        super().__init__()
        self.block_five_up = _up(16 * nf, 8 * nf, q)
        self.block_six = _conv_block(3, 8 * nf, 8 * nf, q)
        self.block_six_up = _up(8 * nf, 4 * nf, q)
        self.block_seven = _conv_block(3, 4 * nf, 4 * nf, q)
        self.block_seven_up = _up(4 * nf, 2 * nf, q)
        self.block_eight = _conv_block(2, 2 * nf, 2 * nf, q)
        self.block_eight_up = _up(2 * nf, nf, q)
        self.block_nine = _conv_block(1, nf, nf, q)
        self.out_conv = QConv(nf, n_classes, 1, quantize=q)


class RefVNet(nn.Module):
    """The BCP V-Net. ``forward(x, keeps)``: ``keeps`` is None (no
    dropout) or the (N, 16 nf) and (N, nf) keep masks of the dropouts
    after block_five and block_nine. Returns the logits."""

    def __init__(self, n_filters: int = 16, n_classes: int = 2,
                 quantize: Optional[str] = None):
        super().__init__()
        self.encoder = VNetEncoder(n_filters, quantize)
        self.decoder = VNetDecoder(n_filters, n_classes, quantize)

    def forward(self, x, keeps: Optional[Sequence[torch.Tensor]] = None):
        e, d = self.encoder, self.decoder
        k5, k9 = keeps if keeps is not None else (None, None)
        x1 = e.block_one(x)
        x2 = e.block_two(e.block_one_dw(x1))
        x3 = e.block_three(e.block_two_dw(x2))
        x4 = e.block_four(e.block_three_dw(x3))
        x5 = drop_channels(e.block_five(e.block_four_dw(x4)), k5)
        x6 = d.block_six(d.block_five_up(x5) + x4)
        x7 = d.block_seven(d.block_six_up(x6) + x3)
        x8 = d.block_eight(d.block_seven_up(x7) + x2)
        x9 = drop_channels(d.block_nine(d.block_eight_up(x8) + x1), k9)
        return d.out_conv(x9)


def build(widths: dict, quantize: Optional[str] = None) -> nn.Module:
    return round_outputs(RefVNet(widths["n_filters"], widths["n_classes"],
                                 quantize),
                         quantize, (nn.BatchNorm3d, nn.ReLU))


def dropout_shapes(widths: dict, patch, n: int):
    nf = widths["n_filters"]
    return [((n, 16 * nf), 0.5), ((n, nf), 0.5)]
