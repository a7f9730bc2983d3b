"""A toy reference architecture for the tests, in the form of the files
under ``benchmark/reference/archs/``: a patch-embedding conv, a free
position parameter, a LayerNorm, one attention layer of linear
projections, an element-wise dropout at p = 0.1, a channel dropout at
p = 0.5 and a transposed conv back to the patch. Widths ``dim``,
``heads`` and ``n_classes``. The tests copy it into an architecture
directory as ``toy.py``."""

from __future__ import annotations

from math import prod
from typing import Optional

import torch
from torch import nn

from benchmark.reference.nets import (QConv, QConvTranspose, drop_channels,
                                      round_outputs)

P_ELEMENT, P_CHANNEL = 0.1, 0.5


class Toy(nn.Module):
    def __init__(self, dim: int, heads: int, n_classes: int,
                 quantize: Optional[str] = None):
        super().__init__()
        self.heads = heads
        self.embed = QConv(1, dim, 2, stride=2, quantize=quantize)
        self.pos = nn.Parameter(torch.zeros(dim))
        self.norm = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.head = QConvTranspose(dim, n_classes, 2, stride=2,
                                   quantize=quantize)

    def forward(self, x, keeps=None):
        e = self.embed(x)
        n, c, *grid = e.shape
        d = c // self.heads
        t = e.flatten(2).transpose(1, 2) + self.pos
        q, k, v = self.qkv(self.norm(t)).view(n, -1, 3, self.heads,
                                              d).permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-2, -1) / d ** 0.5, -1) @ v
        t = t + self.proj(a.transpose(1, 2).reshape(n, -1, c))
        if keeps is not None:
            t = torch.where(keeps[0], t / (1.0 - P_ELEMENT), 0.0)
        e = t.transpose(1, 2).reshape(n, c, *grid)
        if keeps is not None:
            e = drop_channels(e, keeps[1], P_CHANNEL)
        return self.head(e)


def _tokens(patch) -> int:
    return prod(p // 2 for p in patch)


def build(widths: dict, quantize: Optional[str] = None) -> nn.Module:
    return round_outputs(Toy(widths["dim"], widths["heads"],
                             widths["n_classes"], quantize),
                         quantize, (nn.Linear, nn.LayerNorm))


def dropout_shapes(widths: dict, patch, n: int):
    return [((n, _tokens(patch), widths["dim"]), P_ELEMENT),
            ((n, widths["dim"]), P_CHANNEL)]


def extra_flops(widths: dict, patch, n: int) -> int:
    """q k^T and p v over every head: 2 T^2 dim each a sample."""
    t = _tokens(patch)
    return 2 * (2 * n * t * t * widths["dim"])
