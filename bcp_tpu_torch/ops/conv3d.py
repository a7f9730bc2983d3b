"""3x3x3 stride-1 zero-padded SAME convolution: forward, input gradient
and weight gradient, no bias.

Counterpart of ``bcp_tpu/ops/conv3d.py``: ``conv3x3x3_same`` and its VJP
``_merged_bwd`` (dx re-enters the forward kernel with spatially flipped,
io-transposed weights; dW is the ``A^T @ dy`` kernel). Tensors are logical
NCDHW: x (B, Ci, X, Y, Z), w (Co, Ci, 3, 3, 3) as in ``nn.Conv3d``.

On a CUDA tensor:

- :func:`conv3x3x3_same` and :func:`conv3x3x3_dx` launch the hand-written
  implicit GEMM ``kernels/csrc/conv3x3x3.cu`` (kernel B: bf16 on tensor
  cores from a halo tile in shared memory, boxed by :func:`halo_box`, or
  f32 on CUDA cores) on the channels_last_3d layout, which keeps each
  voxel's channels contiguous as the JAX package's NDHWC does; the result
  is channels_last_3d too;
- :func:`conv3x3x3_dw` launches ``kernels/csrc/conv3x3x3_dw.cu`` (kernel
  C), whose voxel reduction is split over CTAs and summed in a fixed
  order (:func:`dw_splits`);
- :func:`conv3x3x3_dxdw` launches ``kernels/csrc/conv3x3x3_dxdw.cu``
  (kernel D, the counterpart of ``_conv3x3x3_dxdw_pallas``): dx and dW of
  a Ci == Co conv from one staging of each dy tile
  (:func:`fused_bwd_eligible`).

On a CPU tensor each runs its plain version: 27 shifted tap matmuls with
f32 accumulation (:func:`conv3x3x3_same_reference`,
:func:`conv3x3x3_dw_reference`, and the two composed,
:func:`conv3x3x3_dxdw_reference`). Shapes the kernels do not take
(:func:`kernel_takes`) are the caller's to route to ``F.conv3d``.
:class:`Conv3x3x3Function` ties forward and backward together for
autograd; its ``fused`` flag picks kernel D for the backward.
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
#: kernel C: CTAs to aim for (about two resident per SM) and the most bytes
#: of per-split partial sums
DW_CTAS_PER_SM = 2
DW_WORKSPACE_BYTES = 32 << 20


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


def _check_kernel_args(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{what}: x on {x.device}, w on {w.device}")
    if x.dim() != 5 or tuple(w.shape[1:]) != (x.shape[1], 3, 3, 3):
        raise ValueError(f"{what}: bad shapes x {tuple(x.shape)} "
                         f"w {tuple(w.shape)}")
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{what}: kernel takes bf16 or f32 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if not kernel_takes(x.shape[1], w.shape[0]):
        raise ValueError(f"{what}: kernel does not take Ci={x.shape[1]}, "
                         f"Co={w.shape[0]}")


def _channels_last(t: torch.Tensor, what: str) -> torch.Tensor:
    t = t.contiguous(memory_format=torch.channels_last_3d)
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: the kernels read in 16-byte vectors; the "
                         f"tensor must start on a 16-byte boundary")
    return t


def _launch_conv(x: torch.Tensor, w: torch.Tensor, what: str) -> torch.Tensor:
    """One launch of kernel B: y = conv(x, w), channels_last_3d."""
    _check_kernel_args(x, w, what)
    B, Ci, X, Y, Z = x.shape
    Co = w.shape[0]
    x = _channels_last(x, what)
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
    kernels.check(code, what)
    return y


def conv3x3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3x3 SAME conv of x (B,Ci,X,Y,Z) with w (Co,Ci,3,3,3), no bias."""
    if x.device.type == "cpu":
        return conv3x3x3_same_reference(x, w)
    y = _launch_conv(x, w, "conv3x3x3_same")
    kernels.count_launch(conv3x3x3_same)
    return y


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) -> (Ci, Co, 3, 3, 3), spatially flipped: the
    weights whose SAME conv of dy is dx (`conv3d.py:574,620`)."""
    return w.flip((2, 3, 4)).transpose(0, 1)


def conv3x3x3_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of the SAME conv: kernel B on dy (B,Co,X,Y,Z) with the flipped,
    io-transposed weights (`_merged_bwd`, `conv3d.py:574-583`)."""
    wt = flip_transpose(w)
    if dy.device.type == "cpu":
        return conv3x3x3_same_reference(dy, wt)
    dx = _launch_conv(dy, wt, "conv3x3x3_dx")
    kernels.count_launch(conv3x3x3_dx)
    return dx


def conv3x3x3_dw_reference(x: torch.Tensor,
                           dy: torch.Tensor) -> torch.Tensor:
    """Plain weight gradient: tap (i, j, k) is shift(x_pad)^T @ dy over all
    voxels, in f32 (f64 stays f64), taps in order; returns (Co, Ci, 3, 3, 3)
    in the accumulation dtype, as ``_conv3x3x3_dw_pallas`` returns f32."""
    acc_dtype = torch.promote_types(torch.float32, x.dtype)
    B, Ci, X, Y, Z = x.shape
    Co = dy.shape[1]
    xp = F.pad(x, (1, 1, 1, 1, 1, 1)).to(acc_dtype).permute(0, 2, 3, 4, 1)
    d = dy.to(acc_dtype).permute(0, 2, 3, 4, 1).reshape(-1, Co)
    out = torch.empty((3, 3, 3, Ci, Co), dtype=acc_dtype, device=x.device)
    for i in range(3):
        for j in range(3):
            for k in range(3):
                out[i, j, k] = (xp[:, i:i + X, j:j + Y, k:k + Z]
                                .reshape(-1, Ci).T @ d)
    return out.permute(4, 3, 0, 1, 2).contiguous()


def dw_splits(ci: int, co: int, bn: int, boxes: int, sms: int) -> int:
    """Kernel C's split of the voxel reduction: enough CTAs over the
    (ci tile, co tile, split) grid for about ``DW_CTAS_PER_SM`` per SM, at
    most one split per box, and the splits' partial sums (27*Ci*Co f32
    each) within ``DW_WORKSPACE_BYTES``."""
    tiles = (ci // 16) * (co // bn)
    want = math.ceil(DW_CTAS_PER_SM * sms / tiles)
    room = max(DW_WORKSPACE_BYTES // (27 * ci * co * 4), 1)
    return max(1, min(want, boxes, room))


def conv3x3x3_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the SAME conv, f32 (Co, Ci, 3, 3, 3), from x
    (B,Ci,X,Y,Z) and dy (B,Co,X,Y,Z) of one dtype."""
    if x.device.type == "cpu":
        return conv3x3x3_dw_reference(x, dy)
    B, Ci, X, Y, Z = x.shape
    Co = dy.shape[1]
    if dy.shape != (B, Co, X, Y, Z):
        raise ValueError(f"conv3x3x3_dw: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} differ")
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"conv3x3x3_dw: x on {x.device}, dy on {dy.device}")
    if x.dtype not in _KERNEL_DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"conv3x3x3_dw: kernel takes bf16 or f32 x and dy of "
                        f"one dtype, got {x.dtype} and {dy.dtype}")
    if not kernel_takes(Ci, Co):
        raise ValueError(f"conv3x3x3_dw: kernel does not take Ci={Ci}, "
                         f"Co={Co}")
    x = _channels_last(x, "conv3x3x3_dw")
    dy = _channels_last(dy, "conv3x3x3_dw")
    tx, ty, tz = halo_box(X, Y, Z)
    boxes = B * math.ceil(X / tx) * math.ceil(Y / ty) * math.ceil(Z / tz)
    bn = 32 if Co % 32 == 0 else 16
    splits = dw_splits(Ci, Co, bn, boxes, _sm_count(x.device.index or 0))
    out = torch.empty((27, Ci, Co), dtype=torch.float32, device=x.device)
    ws = (torch.empty((splits, 27, Ci, Co), dtype=torch.float32,
                      device=x.device) if splits > 1 else out)
    lib = kernels.library("conv3x3x3_dw")
    launch = (lib.conv3x3x3_dw_bf16 if x.dtype == torch.bfloat16
              else lib.conv3x3x3_dw_f32)
    code = launch(x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
                  B, X, Y, Z, Ci, Co, tx, ty, tz, bn, splits,
                  kernels.stream_handle(x.device))
    kernels.check(code, "conv3x3x3_dw")
    kernels.count_launch(conv3x3x3_dw)
    return out.view(3, 3, 3, Ci, Co).permute(4, 3, 0, 1, 2).contiguous()


def fused_bwd_eligible(ci: int, co: int) -> bool:
    """Whether kernel D takes the conv's backward: Ci == Co (dx's and dW's
    tiles then share one geometry, `conv3d.py:506-512`) on top of the
    channel counts every kernel takes."""
    return ci == co and kernel_takes(ci, co)


def conv3x3x3_dxdw_reference(x: torch.Tensor, dy: torch.Tensor,
                             w: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fused backward: the two plain versions composed, dx in x's
    dtype and dW (Co, Ci, 3, 3, 3) in the accumulation dtype."""
    dy = dy.to(x.dtype)
    return (conv3x3x3_same_reference(dy, flip_transpose(w).to(x.dtype)),
            conv3x3x3_dw_reference(x, dy))


def conv3x3x3_dxdw(x: torch.Tensor, dy: torch.Tensor,
                   w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dW) of the SAME conv with Ci == Co from x, dy (B,C,X,Y,Z) and
    w (C,C,3,3,3) of one dtype, in one launch of kernel D (plus its
    fixed-order second pass): exactly ``(conv3x3x3_dx(dy, w),
    conv3x3x3_dw(x, dy))``, dx channels_last_3d in x's dtype, dW f32."""
    if x.device.type == "cpu" and dy.device.type == "cpu" \
            and w.device.type == "cpu":
        return conv3x3x3_dxdw_reference(x, dy, w)
    what = "conv3x3x3_dxdw"
    if x.device.type != "cuda" or dy.device != x.device \
            or w.device != x.device:
        raise ValueError(f"{what}: x on {x.device}, dy on {dy.device}, w on "
                         f"{w.device}")
    B, C, X, Y, Z = x.shape
    if dy.shape != x.shape or tuple(w.shape) != (C, C, 3, 3, 3):
        raise ValueError(f"{what}: takes x and dy of one shape and w "
                         f"(C, C, 3, 3, 3), got x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, w {tuple(w.shape)}")
    if x.dtype not in _KERNEL_DTYPES or dy.dtype != x.dtype \
            or w.dtype != x.dtype:
        raise TypeError(f"{what}: kernel takes bf16 or f32 x, dy and w of "
                        f"one dtype, got {x.dtype}, {dy.dtype}, {w.dtype}")
    if not fused_bwd_eligible(C, C):
        raise ValueError(f"{what}: kernel does not take C={C}")
    x = _channels_last(x, what)
    dy = _channels_last(dy, what)
    # (Ci, Co, 3, 3, 3) -> (27, Co, Ci): rows of dx's K = (tap, co), N = ci
    wk = flip_transpose(w).permute(2, 3, 4, 1, 0).contiguous()
    tx, ty, tz = halo_box(X, Y, Z)
    boxes = B * math.ceil(X / tx) * math.ceil(Y / ty) * math.ceil(Z / tz)
    cg = 32 if C % 32 == 0 else 16      # output channels of one CTA
    splits = dw_splits(C, C, cg, boxes, _sm_count(x.device.index or 0))
    dev = x.device
    dx = torch.empty_like(x)    # channels_last_3d, as x
    dw = torch.empty((27, C, C), dtype=torch.float32, device=dev)
    dw_ws = (torch.empty((splits, 27, C, C), dtype=torch.float32, device=dev)
             if splits > 1 else dw)
    # dx's partial sums per channel group (the kernel reads neither
    # workspace when it has one split or one group)
    dx_ws = (torch.empty((C // cg, B, X, Y, Z, C), dtype=torch.float32,
                         device=dev) if C > cg else dw)
    lib = kernels.library("conv3x3x3_dxdw")
    launch = (lib.conv3x3x3_dxdw_bf16 if x.dtype == torch.bfloat16
              else lib.conv3x3x3_dxdw_f32)
    code = launch(x.data_ptr(), dy.data_ptr(), wk.data_ptr(), dx.data_ptr(),
                  dx_ws.data_ptr(), dw_ws.data_ptr(), dw.data_ptr(),
                  B, X, Y, Z, C, tx, ty, tz, cg, splits,
                  kernels.stream_handle(dev))
    kernels.check(code, what)
    kernels.count_launch(conv3x3x3_dxdw)
    return dx, dw.view(3, 3, 3, C, C).permute(4, 3, 0, 1, 2).contiguous()


class Conv3x3x3Function(torch.autograd.Function):
    """The SAME conv with the JAX package's backward. Unfused (`_merged_bwd`,
    `conv3d.py:570-586`): dx by kernel B on dy cast to x's dtype with the
    flipped, io-transposed weights; dW by kernel C in f32, cast to w's
    dtype. With ``fused``, when both gradients are needed and
    :func:`fused_bwd_eligible` (the gate of `layers.py:135-144`): both by
    kernel D."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor,
                fused: bool = False) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.fused = fused
        return conv3x3x3_same(x, w)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        if dy.is_cuda:     # one layout copy, shared by dx and dW
            dy = dy.contiguous(memory_format=torch.channels_last_3d)
        if ctx.fused and all(ctx.needs_input_grad[:2]) \
                and fused_bwd_eligible(x.shape[1], w.shape[0]):
            dx, dw = conv3x3x3_dxdw(x, dy, w)
            return dx, dw.to(w.dtype), None
        dx = conv3x3x3_dx(dy, w) if ctx.needs_input_grad[0] else None
        dw = (conv3x3x3_dw(x, dy).to(w.dtype) if ctx.needs_input_grad[1]
              else None)
        return dx, dw, None


#: kernel launches; a caller sets them to 0 before the run it counts
conv3x3x3_same.launches = 0
conv3x3x3_dx.launches = 0
conv3x3x3_dw.launches = 0
conv3x3x3_dxdw.launches = 0
