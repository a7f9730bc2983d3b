"""UNet2D, the 2-D segmentation net of the ACDC pipeline.

Counterpart of ``bcp_tpu/models/unet2d.py`` with the reference module tree
(`networks/unet.py:15-257`, ``UNet_2d``), so the state_dict names are the
reference's: ``encoder.in_conv.conv_conv.0.weight``,
``encoder.down1.maxpool_conv.1.conv_conv.0.weight`` ...
``decoder.up1.conv1x1.weight``, ``decoder.up1.conv.conv_conv.0.weight`` ...
``decoder.out_conv.weight``, each ``conv_conv`` stepping over [conv, BN,
LeakyReLU, dropout, conv, BN, LeakyReLU]. A reference ACDC ``.pth`` loads by
name once its dead heads are dropped (``convert.load_reference_checkpoint``).

Encoder: five ConvBlocks of (16, 32, 64, 128, 256) channels with 2x2 max
pooling between them and element-wise dropout (0.05, 0.1, 0.2, 0.3, 0.5) in
train mode. Decoder: per level a 1x1 conv, the 2x bilinear align-corners
upsample and the concat skip (skip first), then a ConvBlock without
dropout; a 3x3 head. Tensors are logical NCHW; on the card they run in
channels_last, the layout cuDNN prefers. The convs are cuDNN's: no Pallas
kernel runs on this model in the JAX package either.

Under a space split (``parallel.mesh``) the rows (H, dim 2) are split:
the 3x3 convs read their neighbours' rows, a 2x2 pool is slab-local where
the slab is even (ACDC's 256 rows at S = 2 halve to 16 without a
replicated level), the levels below the first odd slab run replicated
(:class:`~bcp_tpu_torch.models.layers.SpaceLevels`), and the
align-corners upsample, whose sample positions are global, runs on the
gathered level and keeps this rank's slab.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from bcp_tpu_torch.models.layers import (Conv2d, Dropout, SpaceLevels,
                                         TorchBatchNorm,
                                         upsample2x_align_corners)


class ConvBlock(nn.Module):
    """`ConvBlock` (`networks/unet.py:15-30`, `unet2d.py:25-45`)."""

    def __init__(self, n_in: int, n_out: int, dropout_p: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_conv = nn.Sequential(
            Conv2d(n_in, n_out, 3, padding=1, dtype=dtype),
            TorchBatchNorm(n_out, dtype=dtype),
            nn.LeakyReLU(0.01),
            Dropout(dropout_p) if dropout_p > 0 else nn.Identity(),
            Conv2d(n_out, n_out, 3, padding=1, dtype=dtype),
            TorchBatchNorm(n_out, dtype=dtype),
            nn.LeakyReLU(0.01))

    def forward(self, x):
        return self.conv_conv(x)


class DownBlock(nn.Module):
    """`DownBlock` (`networks/unet.py:33-42`): 2x2 max pool, ConvBlock."""

    def __init__(self, n_in: int, n_out: int, dropout_p: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), ConvBlock(n_in, n_out, dropout_p, dtype))

    def forward(self, x):
        return self.maxpool_conv(x)


class UpBlock(nn.Module):
    """`UpBlock` (`networks/unet.py:45-57`, `unet2d.py:48-63`): 1x1 conv,
    upsample, concat(skip, x), ConvBlock without dropout."""

    def __init__(self, n_deep: int, n_skip: int, n_out: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1x1 = Conv2d(n_deep, n_skip, 1, dtype=dtype)
        self.conv = ConvBlock(2 * n_skip, n_out, 0.0, dtype)

    def forward(self, x_deep, x_skip, lv: SpaceLevels, level: int):
        """From the level below to ``level``."""
        x = lv.upsample(level, upsample2x_align_corners,
                        lv.run(level + 1, self.conv1x1, x_deep))
        return lv.run(level, self.conv,
                      torch.cat([x_skip.to(x.dtype), x], dim=1))


class Encoder(nn.Module):
    def __init__(self, n_channels: int, ft: Sequence[int],
                 dp: Sequence[float], dtype):
        super().__init__()
        self.in_conv = ConvBlock(n_channels, ft[0], dp[0], dtype)
        self.down1 = DownBlock(ft[0], ft[1], dp[1], dtype)
        self.down2 = DownBlock(ft[1], ft[2], dp[2], dtype)
        self.down3 = DownBlock(ft[2], ft[3], dp[3], dtype)
        self.down4 = DownBlock(ft[3], ft[4], dp[4], dtype)

    def forward(self, x, lv: SpaceLevels):
        x0 = lv.run(0, self.in_conv, x)
        x1 = lv.down(0, self.down1, x0)
        x2 = lv.down(1, self.down2, x1)
        x3 = lv.down(2, self.down3, x2)
        return x0, x1, x2, x3, lv.down(3, self.down4, x3)


class Decoder(nn.Module):
    def __init__(self, n_classes: int, ft: Sequence[int], dtype):
        super().__init__()
        self.up1 = UpBlock(ft[4], ft[3], ft[3], dtype)
        self.up2 = UpBlock(ft[3], ft[2], ft[2], dtype)
        self.up3 = UpBlock(ft[2], ft[1], ft[1], dtype)
        self.up4 = UpBlock(ft[1], ft[0], ft[0], dtype)
        self.out_conv = Conv2d(ft[0], n_classes, 3, padding=1, dtype=dtype)

    def forward(self, feats, lv: SpaceLevels):
        x0, x1, x2, x3, x4 = feats
        y = self.up3(self.up2(self.up1(x4, x3, lv, 3), x2, lv, 2), x1, lv, 1)
        x_last = self.up4(y, x0, lv, 0)
        return lv.run(0, self.out_conv, x_last), x_last


class UNet2D(nn.Module):
    """`UNet_2d` (`networks/unet.py:203-257`, `unet2d.py:66-106`).

    ``forward(x)`` takes (B, n_channels, H, W), H and W multiples of 16, and
    returns ``(logits, x_last)`` with the logits promoted to at least f32.
    ``dtype`` is the compute dtype; parameters stay f32. The dropouts act
    in train mode only and hold no parameters, so train and eval models
    share one state_dict layout."""

    def __init__(self, n_channels: int = 1, n_classes: int = 4,
                 feature_chns: Sequence[int] = (16, 32, 64, 128, 256),
                 dropout: Sequence[float] = (0.05, 0.1, 0.2, 0.3, 0.5),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.encoder = Encoder(n_channels, feature_chns, dropout, dtype)
        self.decoder = Decoder(n_classes, feature_chns, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        lv = SpaceLevels(x.shape[2], 4)
        logits, x_last = self.decoder(self.encoder(x, lv), lv)
        return logits.to(torch.promote_types(torch.float32, logits.dtype)), \
            x_last
