"""Building blocks of the port's models: convs with a compute dtype and the
eval-mode BatchNorm of the JAX package.

Counterpart of ``bcp_tpu/models/layers.py``. Parameters stay f32 and keep
``nn.Conv3d`` / ``nn.BatchNorm3d`` names and layouts, so a reference
state_dict loads by name; each forward casts input and parameters to the
module's compute dtype (bf16 for mixed precision), as the flax modules'
``dtype`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bcp_tpu_torch.ops.conv3d import conv3x3x3_same, kernel_takes


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


class Conv3x3x3(nn.Conv3d):
    """3^3 stride-1 SAME conv: ``ZPackedConv3D`` (`layers.py:162-249`).

    Channel counts the CUDA kernel takes go through ``conv3x3x3_same``
    (the kernel on the card, its plain version on the CPU); the rest
    (the V-Net's Ci = 1 first conv) use ``F.conv3d``, as the JAX package
    leaves those to XLA. The bias is added after the conv, in the compute
    dtype (`layers.py:249`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size=3,
                         padding=1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.compute_dtype)
        w = self.weight.to(x.dtype)
        if kernel_takes(self.in_channels, self.out_channels):
            y = conv3x3x3_same(x, w)
        else:
            y = F.conv3d(x, w, None, padding=1)
        return y + self.bias.to(x.dtype).view(1, -1, 1, 1, 1)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computed in the compute dtype (the flax ``nn.Conv``
    with ``dtype``): the V-Net's stride-2 down-convs and 1^3 head."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.compute_dtype)
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` computed in the compute dtype: the V-Net's
    stride-2 up-convs. The weight keeps torch's (Ci, Co, k, k, k) layout;
    ``convert.state_dict_from_flax`` undoes the flax kernel's spatial
    flip."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.compute_dtype)
        return F.conv_transpose3d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class TorchBatchNorm(nn.Module):
    """``TorchBatchNorm`` (`layers.py:262-353`) in eval mode, with
    ``nn.BatchNorm3d``'s parameter and buffer names.

    The arithmetic mirrors the JAX package's running-average branch in
    the compute dtype (`layers.py:299-304`):
    ``x * (rsqrt(var + eps) * scale) + (bias - mean * inv * scale)``.
    Train mode, with its grouped batch statistics, comes with the training
    slice and raises here."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "TorchBatchNorm runs in eval mode only; batch statistics "
                "come with the training slice")
        x = _cast(x, self.compute_dtype)
        dt = x.dtype
        mean = self.running_mean.to(dt)
        var = self.running_var.to(dt)
        scale = self.weight.to(dt)
        # eps rounded to dt first, as the JAX package's weakly typed add;
        # a 0-dim host tensor enters the kernel as a scalar, while one made
        # on the card would be a blocking copy that stalls the host
        inv = torch.rsqrt(var + torch.tensor(self.eps, dtype=dt))
        mul = inv * scale
        add = self.bias.to(dt) - mean * inv * scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * mul.view(shape) + add.view(shape)
