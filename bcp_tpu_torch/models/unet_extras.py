"""The dead-net tail of the reference's ``networks/unet.py`` for the port:
``Sep_UNet_2d``, ``UNet_2dBCP``, ``UNet_tsne``, ``net_D`` and the trilinear
deep-supervision ``UNet_3D``.

Counterpart of ``bcp_tpu/models/unet_extras.py`` (reference
`networks/unet.py:259-510`; no reference entry point builds these nets).
The 2-D nets wrap the port's :class:`~bcp_tpu_torch.models.unet2d.UNet2D`
as ``body`` (its state_dict names are the reference's), and the heads and
the rest carry the flax module paths (``heads.projection_head.fc0``,
``heads.selectors_0.bn``, ``encoder1``, ``map4``), for
``convert.state_dict_from_flax``. The MLP heads' BatchNorms are
:class:`~bcp_tpu_torch.models.layers.TorchBatchNorm` on (N, F) rows, as in
the JAX package. :func:`~bcp_tpu_torch.models.layers.grad_reverse` is the
gradient-reversal layer ``net_D`` pairs with.

Tensors are NCHW / NCDHW, the JAX package's channels-last moved: ``NetD``
permutes its (b, 256, 3, 3) input to channels-last before flattening, so
its first Linear reads the JAX package's order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bcp_tpu_torch.models.layers import (Conv3d, Conv3x3x3, Linear,
                                         TorchBatchNorm, resize_trilinear)
from bcp_tpu_torch.models.unet2d import UNet2D


class _MLPHead(nn.Module):
    """Linear, BatchNorm1d, ReLU, Linear: the projection / prediction heads
    (`unet_extras.py:58-69`)."""

    def __init__(self, dim_in: int, feat_dim: int = 32):
        super().__init__()
        self.fc0 = Linear(dim_in, feat_dim)
        self.bn = TorchBatchNorm(feat_dim)
        self.fc1 = Linear(feat_dim, feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc1(F.relu(self.bn(self.fc0(x))))


class _SelectorHead(nn.Module):
    """Linear, BatchNorm1d, LeakyReLU(0.2), Linear(1): a per-class
    contrastive selector (`unet_extras.py:72-83`)."""

    def __init__(self, feat_dim: int = 32):
        super().__init__()
        self.fc0 = Linear(feat_dim, feat_dim)
        self.bn = TorchBatchNorm(feat_dim)
        self.fc1 = Linear(feat_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc1(F.leaky_relu(self.bn(self.fc0(x)), 0.2))


class _ContrastiveHeads(nn.Module):
    """The projection and prediction heads and the 2 x 4 class selectors
    of Sep_UNet_2d and UNet_tsne (`unet_extras.py:86-108`)."""

    def __init__(self, dim_in: int, feat_dim: int = 32,
                 n_selector_classes: int = 4):
        super().__init__()
        self.n = n_selector_classes
        self.projection_head = _MLPHead(dim_in, feat_dim)
        self.prediction_head = _MLPHead(feat_dim, feat_dim)
        for kind in ("selectors", "selectors_memory"):
            for c in range(self.n):
                self.add_module(f"{kind}_{c}", _SelectorHead(feat_dim))

    def selectors(self, kind: str = "selectors") -> List[nn.Module]:
        return [getattr(self, f"{kind}_{c}") for c in range(self.n)]

    def forward(self, features: torch.Tensor):
        proj = self.projection_head(features)
        pred = self.prediction_head(proj)
        return (proj, pred, [s(proj) for s in self.selectors()],
                [s(proj) for s in self.selectors("selectors_memory")])


class _HeadsMixin:
    """``init_heads`` and the two head forwards of the nets that carry
    :class:`_ContrastiveHeads`."""

    def init_heads(self, features: torch.Tensor):
        """The whole head stack on (N, dim_in) features."""
        return self.heads(features)

    def forward_projection_head(self, features: torch.Tensor):
        return self.heads.projection_head(features)

    def forward_prediction_head(self, features: torch.Tensor):
        return self.heads.prediction_head(features)


class SepUNet2D(_HeadsMixin, nn.Module):
    """`Sep_UNet_2d` (`unet_extras.py:111-144`): the 2-D U-Net plus the
    contrastive heads; ``forward`` returns ``(feature, logits)``, the
    feature the bottleneck max-pooled twice (3 x 3, stride 2, VALID)."""

    def __init__(self, n_channels: int = 1, n_classes: int = 4,
                 feature_chns: Sequence[int] = (16, 32, 64, 128, 256),
                 dropout: Sequence[float] = (0.05, 0.1, 0.2, 0.3, 0.5),
                 feat_dim: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.body = UNet2D(n_channels, n_classes, feature_chns, dropout,
                           dtype, expose_bottleneck=True)
        self.heads = _ContrastiveHeads(feature_chns[0], feat_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, _, bottleneck = self.body(x)
        f = F.max_pool2d(F.max_pool2d(bottleneck, 3, 2), 3, 2)
        return f, logits


class UNet2DBCP(nn.Module):
    """`UNet_2dBCP` (`unet_extras.py:147-161`): the 2-D U-Net's logits
    alone, a bare tensor."""

    def __init__(self, n_channels: int = 1, n_classes: int = 4,
                 feature_chns: Sequence[int] = (16, 32, 64, 128, 256),
                 dropout: Sequence[float] = (0.05, 0.1, 0.2, 0.3, 0.5),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.body = UNet2D(n_channels, n_classes, feature_chns, dropout,
                           dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)[0]


class UNetTsne(_HeadsMixin, nn.Module):
    """`UNet_tsne` (`unet_extras.py:164-190`): the 2-D U-Net's
    ``(logits, x_last)`` plus the contrastive heads (not on the forward's
    path)."""

    def __init__(self, n_channels: int = 1, n_classes: int = 4,
                 feature_chns: Sequence[int] = (16, 32, 64, 128, 256),
                 dropout: Sequence[float] = (0.05, 0.1, 0.2, 0.3, 0.5),
                 feat_dim: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.body = UNet2D(n_channels, n_classes, feature_chns, dropout,
                           dtype)
        self.heads = _ContrastiveHeads(feature_chns[0], feat_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.body(x)


class NetD(nn.Module):
    """`net_D` (`unet_extras.py:193-208`): the whole batch's (b_size, 256,
    3, 3) Sep_UNet_2d feature flattened channels-last into one row, Linear
    / Tanh twice, Linear / Sigmoid; out (1, 1)."""

    def __init__(self, b_size: int = 4):
        super().__init__()
        total = b_size * 256 * 3 * 3
        self.fc0 = Linear(total, total // 2)
        self.fc1 = Linear(total // 2, total // 4)
        self.fc2 = Linear(total // 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1).reshape(1, -1)
        x = torch.tanh(self.fc1(torch.tanh(self.fc0(x))))
        return torch.sigmoid(self.fc2(x))


class UNet3DTrilinear(nn.Module):
    """`UNet_3D` (`unet_extras.py:223-276`): encoder levels of one 3^3
    conv, 2^3 max pool and ReLU; decoder levels of one 3^3 conv, the 2x
    trilinear resize, ReLU and an additive skip; four softmaxed
    deep-supervision maps. The reference's quirk is kept: each map is
    resized one level past the input in H and W, so maps are (D, 2H, 2W).
    In train mode ``forward`` returns (map1 .. map4), else map4 alone, a
    bare tensor. Extents are multiples of 16."""

    def __init__(self, n_channels: int = 1, n_classes: int = 2,
                 feat: Sequence[int] = (32, 64, 128, 256),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        ft = tuple(feat)
        self.compute_dtype = dtype
        ins = (n_channels,) + ft[:3]
        for i in range(4):
            self.add_module(f"encoder{i + 1}",
                            Conv3x3x3(ins[i], ft[i], dtype=dtype))
        self.map1 = Conv3d(ft[3], n_classes, 1, dtype=dtype)
        self.decoder2 = Conv3x3x3(ft[3], ft[2], dtype=dtype)
        self.map2 = Conv3d(ft[2], n_classes, 1, dtype=dtype)
        self.decoder3 = Conv3x3x3(ft[2], ft[1], dtype=dtype)
        self.map3 = Conv3d(ft[1], n_classes, 1, dtype=dtype)
        self.decoder4 = Conv3x3x3(ft[1], ft[0], dtype=dtype)
        self.decoder5 = Conv3x3x3(ft[0], 2, dtype=dtype)
        self.map4 = Conv3d(2, n_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last_3d)

        def head(y, conv, scale):
            y = resize_trilinear(conv(y), scale)
            return torch.softmax(y.float(), dim=1)

        def up(y, conv):
            return F.relu(resize_trilinear(conv(y), (2, 2, 2)))

        skips = []
        out = x
        for i in range(1, 5):
            out = F.relu(F.max_pool3d(getattr(self, f"encoder{i}")(out), 2, 2))
            skips.append(out)
        t1, t2, t3 = skips[:3]
        output1 = head(out, self.map1, (16, 32, 32))
        out = up(out, self.decoder2) + t3
        output2 = head(out, self.map2, (8, 16, 16))
        out = up(out, self.decoder3) + t2
        output3 = head(out, self.map3, (4, 8, 8))
        out = up(out, self.decoder4) + t1
        out = up(out, self.decoder5)
        output4 = head(out, self.map4, (1, 2, 2))
        if self.training:
            return output1, output2, output3, output4
        return output4
