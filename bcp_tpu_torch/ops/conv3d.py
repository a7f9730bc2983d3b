"""3x3x3 stride-1 zero-padded SAME convolution, forward, no bias.

Counterpart of ``bcp_tpu/ops/conv3d.py::conv3x3x3_same``. Tensors are
logical NCDHW: x (B, Ci, X, Y, Z), w (Co, Ci, 3, 3, 3) as in ``nn.Conv3d``.
On a CUDA tensor :func:`conv3x3x3_same` launches the hand-written implicit
GEMM (``kernels/csrc/conv3x3x3.cu``: bf16 on tensor cores from a halo tile
in shared memory, boxed by :func:`halo_box`, or f32 on CUDA cores) on the
channels_last_3d layout, which keeps each voxel's channels
contiguous as the JAX package's NDHWC does; the result is channels_last_3d
too. On a CPU tensor it runs :func:`conv3x3x3_same_reference`: 27 shifted
tap matmuls with f32 accumulation, cast to the input dtype, as
``reference_conv3x3x3`` does. Shapes the kernel does not take
(:func:`kernel_takes`) are the caller's to route to ``F.conv3d``.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from bcp_tpu_torch import kernels

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: the bf16 kernel's limits: output voxels of one CTA, and their halo
BOX_VOXELS = 128
MAX_HALO = 640


def kernel_takes(ci: int, co: int) -> bool:
    """Channel counts the CUDA kernel handles: K steps of 16 input
    channels and N tiles of 16, 32 or 64 output channels."""
    return ci % 16 == 0 and co % 16 == 0


@functools.lru_cache(maxsize=None)
def halo_box(X: int, Y: int, Z: int) -> Tuple[int, int, int]:
    """Output box (tx, ty, tz) of one CTA of the bf16 kernel: at most
    ``BOX_VOXELS`` voxels with a halo of at most ``MAX_HALO``; the fewest
    boxes over the volume, then the smallest halo (the input voxels staged
    per box)."""
    best = None
    for tz in range(1, min(Z, 32) + 1):
        for ty in range(1, min(Y, 16) + 1):
            for tx in range(1, min(X, 16) + 1):
                if tx * ty * tz > BOX_VOXELS:
                    break
                halo = (tx + 2) * (ty + 2) * (tz + 2)
                if halo > MAX_HALO:
                    continue
                key = (math.ceil(X / tx) * math.ceil(Y / ty)
                       * math.ceil(Z / tz), halo)
                if best is None or key < best[0]:
                    best = (key, (tx, ty, tz))
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_tile(co: int, ctas: int, sms: int) -> int:
    """Output channels of one CTA: the widest of 64, 32, 16 dividing
    ``co`` that still gives one CTA per SM (``ctas`` = CTAs per channel
    tile)."""
    fits = [bn for bn in (64, 32, 16) if co % bn == 0]
    for bn in fits:
        if ctas * (co // bn) >= sms:
            return bn
    return fits[-1]


def conv3x3x3_same_reference(x: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """Plain version: out = sum over the 27 taps of shift(x) @ w[tap], in
    f32, in tap order, cast back to x's dtype. f64 stays f64."""
    acc_dtype = torch.promote_types(torch.float32, x.dtype)
    B, Ci, X, Y, Z = x.shape
    Co = w.shape[0]
    xp = F.pad(x, (1, 1, 1, 1, 1, 1)).to(acc_dtype).permute(0, 2, 3, 4, 1)
    wt = w.to(acc_dtype)
    out = torch.zeros((B, X, Y, Z, Co), dtype=acc_dtype, device=x.device)
    for i in range(3):
        for j in range(3):
            for k in range(3):
                out += xp[:, i:i + X, j:j + Y, k:k + Z] @ wt[:, :, i, j, k].T
    return out.permute(0, 4, 1, 2, 3).to(x.dtype)


def conv3x3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3x3 SAME conv of x (B,Ci,X,Y,Z) with w (Co,Ci,3,3,3), no bias."""
    if x.device.type == "cpu":
        return conv3x3x3_same_reference(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.dim() != 5 or tuple(w.shape[1:]) != (x.shape[1], 3, 3, 3):
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"kernel takes bf16 or f32 x and w of one dtype, got "
                        f"{x.dtype} and {w.dtype}")
    B, Ci, X, Y, Z = x.shape
    Co = w.shape[0]
    if not kernel_takes(Ci, Co):
        raise ValueError(f"kernel does not take Ci={Ci}, Co={Co}")
    x = x.contiguous(memory_format=torch.channels_last_3d)
    if x.data_ptr() % 16:
        raise ValueError("the kernel reads x in 16-byte vectors; x must "
                         "start on a 16-byte boundary")
    # (Co, Ci, 3, 3, 3) -> (27, Ci, Co): rows of K = (tap, ci), N = co
    wk = w.permute(2, 3, 4, 1, 0).contiguous()
    y = torch.empty((B, Co, X, Y, Z), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last_3d)
    lib = kernels.library("conv3x3x3")
    stream = kernels.stream_handle(x.device)
    if x.dtype == torch.bfloat16:
        tx, ty, tz = halo_box(X, Y, Z)
        boxes = B * math.ceil(X / tx) * math.ceil(Y / ty) * math.ceil(Z / tz)
        bn = n_tile(Co, boxes, _sm_count(x.device.index or 0))
        code = lib.conv3x3x3_bf16(x.data_ptr(), wk.data_ptr(), y.data_ptr(),
                                  B, X, Y, Z, Ci, Co, tx, ty, tz, bn, stream)
    else:
        code = lib.conv3x3x3_f32(x.data_ptr(), wk.data_ptr(), y.data_ptr(),
                                 B, X, Y, Z, Ci, Co, stream)
    kernels.check(code, "conv3x3x3_same")
    conv3x3x3_same.launches += 1
    return y


#: kernel launches; a caller sets it to 0 before the run it counts
conv3x3x3_same.launches = 0
