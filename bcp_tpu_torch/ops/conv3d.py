"""3x3x3 stride-1 zero-padded SAME convolution: forward, input gradient
and weight gradient, no bias.

Counterpart of ``bcp_tpu/ops/conv3d.py``: ``conv3x3x3_same`` and its VJP
``_merged_bwd`` (dx re-enters the forward kernel with spatially flipped,
io-transposed weights; dW is the ``A^T @ dy`` kernel). Tensors are logical
NCDHW: x (B, Ci, X, Y, Z), w (Co, Ci, 3, 3, 3) as in ``nn.Conv3d``.

On a CUDA tensor:

- :func:`conv3x3x3_same` and :func:`conv3x3x3_dx` launch the hand-written
  implicit GEMM ``kernels/csrc/conv3x3x3.cu`` (kernel B) on the
  channels_last_3d layout, which keeps each voxel's channels contiguous as
  the JAX package's NDHWC does; the result is channels_last_3d too. In
  bf16 it is a persistent ``wgmma`` kernel whose two operands are read from
  shared memory by descriptor: an m64 tile is 8 x 8 voxels of one z plane,
  laid out so that a tap is a shift of the descriptor's address; a ring of
  stages carries the halo tiles (``cp.async``) and, where they do not fit
  for good, the weight chunks (bulk copies on ``mbarrier``s) ahead of the
  tensor cores; the weights, packed by the launcher into the core-matrix
  order ``wgmma`` reads, are staged once per CTA where they fit and else
  shared by up to four warpgroups; small volumes split the input channels
  over CTAs whose f32 partial sums a second pass adds in a fixed order.
  What bounds it is the fetch of the A operand from shared memory (27 taps
  re-read every voxel), which four resident warpgroups per SM saturate:
  :func:`conv_variant` picks tiles per box, N tile, warpgroups, stages, K
  split and grid from the shape and the SM count alone. dx is the same
  kernel on dy with the io-transposed weights, read in reversed tap order
  (the spatial flip). f32 runs on CUDA cores;
- :func:`conv3x3x3_dw` launches ``kernels/csrc/conv3x3x3_dw.cu`` (kernel
  C). In bf16 it runs kernel D's dW engine on ``wgmma``: a CTA owns a
  (ci tile, co group) block of dW in registers and walks boxes of 8 x 8 x
  3 or 4 voxels, each staged once through a ``cp.async`` ring (the x halo
  and dy's centre, read by descriptor, a tap a shift of x's address);
  where the boxes are split over CTAs, clusters of two add their partial
  sums through distributed shared memory and a second pass adds the
  clusters' in a fixed order; the result comes out in the (Co, Ci, 3, 3,
  3) layout the wrapper returns. :func:`dw_variant` picks tiles, box
  depth, stages, splits and clusters from the shape and the SM count
  alone. f32 runs on CUDA cores over the boxes of :func:`halo_box`, split
  by :func:`dw_splits`;
- :func:`conv3x3x3_dxdw` launches ``kernels/csrc/conv3x3x3_dxdw.cu``
  (kernel D, the counterpart of ``_conv3x3x3_dxdw_pallas``): dx and dW of
  a Ci == Co conv from one staging of each dy box (:func:`fused_bwd_eligible`).
  In bf16 both products are ``wgmma`` from shared memory: dx as kernel B
  computes it, dW with the staged x box shifted by the tap and dy's centre
  as transposed operands (the dW engine of ``conv_common.cuh``, which B
  shares); a ring of stages carries the boxes, the weights are packed by a
  kernel and staged once per CTA, and dx's partial sums over output
  channel groups and dW's over box splits are added in a fixed order by a
  second pass. :func:`dxdw_variant` picks its tiles, stages and splits
  from the shape and the SM count alone.

On a CPU tensor each runs its plain version: 27 shifted tap matmuls with
f32 accumulation (:func:`conv3x3x3_same_reference`,
:func:`conv3x3x3_dw_reference`, and the two composed,
:func:`conv3x3x3_dxdw_reference`). Shapes the kernels do not take
(:func:`kernel_takes`) are the caller's to route to ``F.conv3d``.
:class:`Conv3x3x3Function` ties forward and backward together for
autograd; its ``fused`` flag picks kernel D for the backward.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from bcp_tpu_torch import kernels

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: the f32 paths of kernels C and D: a box's output voxels (one CTA's at a
#: time), and the limit on its halo
BOX_VOXELS = 128
MAX_HALO = 640
#: their CTAs to aim for (about two resident per SM); and the most bytes of
#: per-split dW partial sums of kernels C and D, bf16 and f32
DW_CTAS_PER_SM = 2
DW_WORKSPACE_BYTES = 32 << 20


def kernel_takes(ci: int, co: int) -> bool:
    """Channel counts the CUDA kernel handles: K steps of 16 input
    channels and N tiles of 16, 32 or 64 output channels."""
    return ci % 16 == 0 and co % 16 == 0


@functools.lru_cache(maxsize=None)
def halo_box(X: int, Y: int, Z: int) -> Tuple[int, int, int]:
    """Output box (tx, ty, tz) of one CTA of kernels C and D in f32: at most
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


#: kernel B (``conv3x3x3.cu``): an m64 tile is 8 x 8 voxels of one z
#: plane; the ring's depth; a CTA's dynamic shared memory; an H100 SM's
#: shared memory and what each resident CTA reserves of it
CONV_TILE = (8, 8)
CONV_MAX_STAGES = 4
CONV_SMEM_LIMIT = 232448
CONV_SM_SMEM = 233472
CONV_BAR_BYTES = 128        # the mbarriers' share of a CTA's shared memory
CONV_CTA_RESERVED = 1024


def halo_bytes(tiles: int) -> int:
    """Bytes of one box's halo (16 channels) in kernel B's shared memory
    (`Halo` in the source): two k halves of (tiles + 2) z planes of 10 x 10
    entries of 16 bytes, planes and halves padded against bank conflicts
    of the copies."""
    plane = 10 * 10 + 6                           # 16-byte units
    half = (tiles + 2) * plane
    half += (1 - half) % 8
    return 2 * half * 16


class ConvVariant(NamedTuple):
    """How kernel B runs one shape: the m64 tiles (z planes of 8 x 8
    voxels) of one warpgroup's box; the output channels of one CTA; its
    warpgroups (2 or 4 boxes that share a weight tile); the ring's stages;
    whether the weights are staged once per CTA; the split of the Ci chunks
    over CTAs; the CTAs per (co tile, split)."""
    tiles: int
    bn: int
    warpgroups: int
    stages: int
    persist_w: bool
    ksplit: int
    grid_x: int

    @property
    def box(self) -> Tuple[int, int, int]:
        """Output voxels of one warpgroup."""
        return (*CONV_TILE, self.tiles)

    def smem_bytes(self, ci: int) -> int:
        """Dynamic shared memory of one CTA (`launch_bf16` in the source)."""
        chunk = 27 * 16 * self.bn * 2
        slab = chunk * (ci // 16 // self.ksplit) if self.persist_w else 0
        stage = (self.warpgroups * halo_bytes(self.tiles)
                 + (0 if self.persist_w else chunk))
        return CONV_BAR_BYTES + slab + self.stages * stage

    def ctas(self, co: int) -> int:
        return self.grid_x * (co // self.bn) * self.ksplit


def _conv_ctas_per_sm(v: ConvVariant, ci: int) -> int:
    """CTAs of variant ``v`` that one SM holds: by shared memory (each CTA
    reserves ``CONV_CTA_RESERVED`` bytes more) and by the registers the
    kernel is compiled to (`__launch_bounds__` in the source). 0 when not
    even one fits."""
    by_regs = 2 if v.warpgroups == 2 and v.bn * v.tiles <= 64 else 1
    by_smem = CONV_SM_SMEM // (v.smem_bytes(ci) + CONV_CTA_RESERVED)
    return min(by_regs, by_smem)


def conv_tiles(Z: int) -> Tuple[int, ...]:
    """The m64 tiles (z planes) one warpgroup's box may have: those of 4
    and 2 that cover Z with the fewest planes."""
    planes = {t: math.ceil(Z / t) * t for t in (4, 2)}
    return tuple(t for t in (4, 2) if planes[t] == min(planes.values()))


def _conv_candidate(tiles: int, B: int, X: int, Y: int, Z: int, ci: int,
                    co: int, sms: int):
    """The best variant with boxes of ``tiles`` planes, and its resident
    warpgroups per SM."""
    boxes = B * math.prod(math.ceil(v / t) for v, t in zip(
        (X, Y, Z), (*CONV_TILE, tiles)))
    chunks = ci // 16
    bn = next(n for n in (64, 32, 16) if co % n == 0)
    cols = co // bn

    def slab_fits(ksplit: int) -> bool:
        v = ConvVariant(tiles, bn, 2, 2, True, ksplit, 1)
        return v.smem_bytes(ci) <= CONV_SMEM_LIMIT

    splits = [k for k in range(1, chunks + 1) if chunks % k == 0]
    ksplit = 1
    if not slab_fits(1) and math.ceil(boxes / 2) * cols < 2 * sms:
        ksplit = next(k for k in splits if slab_fits(k))
    for k in splits:
        if k > ksplit and boxes * cols * ksplit < sms:
            ksplit = k

    found = []
    for wg in (2, 4):
        if wg > 2 and boxes * cols * ksplit < wg * sms:
            continue        # not the boxes to give every SM such a CTA
        if wg == 4 and bn * tiles > 128:
            continue        # four warpgroups have 128 registers a thread
        groups = math.ceil(boxes / wg)
        for persist_w in (True, False):
            v = ConvVariant(tiles, bn, wg, 2, persist_w, ksplit, 1)
            per_sm = _conv_ctas_per_sm(v, ci)
            grid_x = min(groups, max(1, per_sm * sms // (cols * ksplit)))
            if per_sm and (groups > grid_x or not persist_w):
                found.append((min(wg * per_sm, 4), -wg,
                              v._replace(grid_x=grid_x), per_sm))
                break
    if not found:
        raise ValueError(f"conv_variant: {tiles} tiles with {bn} output "
                         f"channels do not fit in shared memory")
    resident, _, v, per_sm = max(found, key=lambda f: f[:2])
    room = CONV_SM_SMEM // per_sm - CONV_CTA_RESERVED
    stages = max(s for s in range(2, CONV_MAX_STAGES + 1)
                 if s == 2
                 or v._replace(stages=s).smem_bytes(ci) <= min(
                     room, CONV_SMEM_LIMIT))
    return resident, v._replace(stages=stages)


@functools.lru_cache(maxsize=None)
def conv_variant(B: int, X: int, Y: int, Z: int, ci: int, co: int,
                 sms: int) -> ConvVariant:
    """Kernel B's variant for one shape, from the shape and the SM count
    alone (the rules follow ``scripts/torch_conv_variants.py --sweep``).

    The N tile is the widest of 64, 32, 16 dividing ``co``. The Ci chunks
    stay whole when all their weights fit in shared memory beside a ring
    of two stages, or when the (two-box group, co tile) units already give
    every SM two; otherwise they are split until a split's weights fit,
    and further while the CTAs are fewer than the SMs. A CTA stages its
    weights once where they fit and it walks more than one group of boxes,
    else it streams them through the ring. Tiles per box, warpgroups per
    CTA (boxes sharing a weight tile) and CTAs per SM are chosen for the
    most resident warpgroups, up to the four that saturate the tensor
    cores' operand fetch; then for the larger box, then for the smaller
    CTA. The ring takes the stages that still fit."""
    found = [_conv_candidate(t, B, X, Y, Z, ci, co, sms)
             for t in conv_tiles(Z)]
    return max(found, key=lambda f: (f[0], f[1].tiles))[1]


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


class _ConvArgs(ctypes.Structure):
    """`ConvArgs` of ``conv3x3x3.cu``: one bf16 launch's shape, weight
    strides and variant."""
    _fields_ = ([(n, ctypes.c_int) for n in ("B", "X", "Y", "Z", "Ci", "Co")]
                + [("sco", ctypes.c_longlong), ("sci", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in (
                    "mt", "bn", "wg", "stages", "persist_w", "ksplit",
                    "flip", "gx")])


@functools.lru_cache(maxsize=None)
def _conv_args(shape: Tuple[int, ...], strides: Tuple[int, int],
               v: ConvVariant, flip: bool) -> Tuple[_ConvArgs, int]:
    """The launch's arguments and their address, built once per shape (the
    launch path is the host's, and a launch is short)."""
    args = _ConvArgs(*shape, *strides, v.tiles, v.bn, v.warpgroups, v.stages,
                     int(v.persist_w), v.ksplit, int(flip), v.grid_x)
    return args, ctypes.addressof(args)


def _launch_conv(x: torch.Tensor, w: torch.Tensor, what: str,
                 flip: bool = False,
                 variant: Optional[ConvVariant] = None) -> torch.Tensor:
    """One launch of kernel B: y = conv(x, w), channels_last_3d; with
    ``flip``, conv(x, w flipped along its three spatial axes). ``variant``
    overrides :func:`conv_variant` (the tuning script's sweep); the launcher
    refuses one that does not fit in shared memory."""
    _check_kernel_args(x, w, what)
    B, Ci, X, Y, Z = x.shape
    Co = w.shape[0]
    x = _channels_last(x, what)
    y = torch.empty((B, Co, X, Y, Z), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last_3d)
    lib = kernels.library("conv3x3x3")
    stream = kernels.stream_handle(x.device)
    if x.dtype == torch.bfloat16:
        v = variant or conv_variant(B, X, Y, Z, Ci, Co,
                                    _sm_count(x.device.index or 0))
        # the launcher packs w, read through its strides (dx passes a
        # transposed view), into the order wgmma reads it
        if w.stride()[2:] != (9, 3, 1):
            w = w.contiguous()
        wk = torch.empty(27 * Ci * Co, dtype=x.dtype, device=x.device)
        # f32 partial sums of the K splits, added in order by a second pass
        ws = (torch.empty((v.ksplit, B, X, Y, Z, Co), dtype=torch.float32,
                          device=x.device) if v.ksplit > 1 else None)
        _, args = _conv_args((B, X, Y, Z, Ci, Co), w.stride()[:2], v, flip)
        code = lib.conv3x3x3_bf16(
            x.data_ptr(), w.data_ptr(), wk.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None, args, stream)
    else:
        if flip:
            w = w.flip((2, 3, 4))
        # (Co, Ci, 3, 3, 3) -> (27, Ci, Co): rows of K = (tap, ci), N = co
        wk = w.permute(2, 3, 4, 1, 0).contiguous()
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
    io-transposed weights (`_merged_bwd`, `conv3d.py:574-583`); the kernel
    takes the flip as a reversed tap order."""
    if dy.device.type == "cpu":
        return conv3x3x3_same_reference(dy, flip_transpose(w))
    dx = _launch_conv(dy, w.transpose(0, 1), "conv3x3x3_dx", flip=True)
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
    """The f32 split of kernels C and D's voxel reduction: enough CTAs
    over the (ci tile, co tile, split) grid for about ``DW_CTAS_PER_SM``
    per SM, at most one split per box, and the splits' partial sums
    (27*Ci*Co f32 each) within ``DW_WORKSPACE_BYTES``."""
    tiles = (ci // 16) * (co // bn)
    want = math.ceil(DW_CTAS_PER_SM * sms / tiles)
    room = max(DW_WORKSPACE_BYTES // (27 * ci * co * 4), 1)
    return max(1, min(want, boxes, room))


#: kernel C's bf16 kernel (``conv3x3x3_dw.cu``): a box is 3 or 4 z planes
#: (tiles) of 8 x 8 voxels; the (ci tile, co group) pairs it is built for;
#: its threads (three warpgroups); one (plane, 8-channel group) of its dy
#: centre in shared memory (`Centre`)
DW_TILES = (3, 4)
DW_PAIRS = ((16, 16), (32, 32))
DW_MIN_STAGES = 3
#: CTAs of one thread-block cluster, which add their dW partial sums through
#: distributed shared memory before any reach the workspace
DW_CLUSTER = 2
DW_THREADS = 384
CENTRE_PLANE = (8 * 8 + 1) * 16


class DwVariant(NamedTuple):
    """How kernel C's bf16 kernel runs one shape: the input channels of one
    CTA (dW's rows), its output channels (dW's columns), the ring's stages,
    the CTAs that share the boxes of one (ci tile, co group), the z planes
    (tiles) of a box, and the splits of one thread-block cluster, which
    add their partial sums through distributed shared memory."""
    ci_tile: int
    co_group: int
    stages: int
    splits: int
    tiles: int = 3
    cluster: int = 1

    def sums(self) -> int:
        """dW sums a thread holds in registers (`DwEngine::run`'s acc):
        3 tap columns x the m64 row blocks of 64 / ci_tile z taps x
        co_group / 2."""
        passes = math.ceil(3 / (64 // self.ci_tile))
        return 3 * passes * self.co_group // 2

    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA (`DwShape` in the source): the
        larger of ``stages`` x (x slab of tiles + 3 halo planes, dy centre
        of tiles planes) and the epilogue's tile of 27 * ci_tile * co_group
        f32."""
        x = (self.tiles + 3) * (self.ci_tile // 8) * SLAB_PLANE
        d = self.tiles * (self.co_group // 8) * CENTRE_PLANE
        return max(self.stages * (x + d),
                   27 * self.ci_tile * self.co_group * 4)

    def ctas_per_sm(self) -> int:
        """By registers (`__launch_bounds__`: two CTAs only for (16, 16))
        and shared memory."""
        by_regs = 2 if (self.ci_tile, self.co_group) == (16, 16) else 1
        return min(by_regs, CONV_SM_SMEM // (self.smem_bytes()
                                             + CONV_CTA_RESERVED))


def dw_boxes(B: int, X: int, Y: int, Z: int, tiles: int) -> int:
    """Kernel C's (and D's) boxes of 8 x 8 x tiles voxels over the
    volumes."""
    return (B * math.ceil(X / CONV_TILE[0]) * math.ceil(Y / CONV_TILE[1])
            * math.ceil(Z / tiles))


def dw_candidates(B: int, X: int, Y: int, Z: int, ci: int, co: int,
                  sms: int) -> Tuple[DwVariant, ...]:
    """Every (ci tile, co group) pair that divides (ci, co) with boxes of
    each depth in ``DW_TILES``, each with the most stages that fit and the
    splits that fill the card: about one wave of resident CTAs, at most one
    split per box, and the splits' partial sums (27*ci*co f32 each) within
    ``DW_WORKSPACE_BYTES``; more than one split is rounded down to a
    multiple of ``DW_CLUSTER`` and taken in clusters of that many."""
    room = max(DW_WORKSPACE_BYTES // (27 * ci * co * 4), 1)
    found = []
    for (a, b), t in itertools.product(DW_PAIRS, DW_TILES):
        if ci % a or co % b:
            continue
        boxes = dw_boxes(B, X, Y, Z, t)
        v = DwVariant(a, b, DW_MIN_STAGES, 1, t)
        per_sm = v.ctas_per_sm()
        if not per_sm:
            continue
        limit = min(CONV_SM_SMEM // per_sm - CONV_CTA_RESERVED,
                    CONV_SMEM_LIMIT)
        stages = max(s for s in range(DW_MIN_STAGES, CONV_MAX_STAGES + 1)
                     if s == DW_MIN_STAGES
                     or v._replace(stages=s).smem_bytes() <= limit)
        blocks = (ci // a) * (co // b)
        splits = max(1, min(boxes, round(per_sm * sms / blocks), room))
        cluster = DW_CLUSTER if splits >= DW_CLUSTER else 1
        found.append(DwVariant(a, b, stages, splits - splits % cluster, t,
                               cluster))
    return tuple(found)


#: kernel C: the share of one CTA per SM at which a variant's grid counts
#: as a full wave
DW_WAVE = 0.9


@functools.lru_cache(maxsize=None)
def dw_variant(B: int, X: int, Y: int, Z: int, ci: int, co: int,
               sms: int) -> DwVariant:
    """Kernel C's bf16 variant for one shape, from the shape and the SM
    count alone (the rules follow ``scripts/torch_conv_variants.py --dw``).
    Of :func:`dw_candidates`: the most CTAs up to ``DW_WAVE`` of one per
    SM (a small volume has few boxes to split); then one whose partial
    sums, if any, stay inside one cluster (no workspace, no second pass);
    then (32, 32) over (16, 16) (N = 32 costs the tensor cores' operand
    fetch less per product than N = 16); then the box depth that covers Z
    with the fewest planes, then the deeper box (fewer halo planes a
    plane)."""
    found = dw_candidates(B, X, Y, Z, ci, co, sms)
    if not found:
        raise ValueError(f"dw_variant: no variant takes Ci={ci}, Co={co}")
    wave = int(DW_WAVE * sms)

    def key(v: DwVariant):
        ctas = v.splits * (ci // v.ci_tile) * (co // v.co_group)
        return (min(ctas, wave), v.splits == v.cluster, v.ci_tile,
                -math.ceil(Z / v.tiles) * v.tiles, v.tiles)
    return max(found, key=key)


class _DwArgs(ctypes.Structure):
    """`DwArgs` of ``conv3x3x3_dw.cu``: one bf16 launch's shape and
    variant."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "B", "X", "Y", "Z", "Ci", "Co", "ci_tile", "co_group", "stages",
        "splits", "tiles", "cluster")]


@functools.lru_cache(maxsize=None)
def _dw_args(shape: Tuple[int, ...], v: DwVariant) -> Tuple[_DwArgs, int]:
    args = _DwArgs(*shape, *v)
    return args, ctypes.addressof(args)


def conv3x3x3_dw(x: torch.Tensor, dy: torch.Tensor,
                 variant: Optional[DwVariant] = None) -> torch.Tensor:
    """Weight gradient of the SAME conv, f32 (Co, Ci, 3, 3, 3), from x
    (B,Ci,X,Y,Z) and dy (B,Co,X,Y,Z) of one dtype. ``variant`` overrides
    :func:`dw_variant` in bf16 (the tuning script's sweep); the launcher
    refuses one that does not fit."""
    if x.device.type == "cpu":
        return conv3x3x3_dw_reference(x, dy)
    B, Ci, X, Y, Z = x.shape
    Co = dy.shape[1]
    what = "conv3x3x3_dw"
    if dy.shape != (B, Co, X, Y, Z):
        raise ValueError(f"{what}: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} differ")
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"{what}: x on {x.device}, dy on {dy.device}")
    if x.dtype not in _KERNEL_DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"{what}: kernel takes bf16 or f32 x and dy of "
                        f"one dtype, got {x.dtype} and {dy.dtype}")
    if not kernel_takes(Ci, Co):
        raise ValueError(f"{what}: kernel does not take Ci={Ci}, Co={Co}")
    x = _channels_last(x, what)
    dy = _channels_last(dy, what)
    dev = x.device
    sms = _sm_count(dev.index or 0)
    lib = kernels.library("conv3x3x3_dw")
    stream = kernels.stream_handle(dev)
    if x.dtype == torch.bfloat16:
        v = variant or dw_variant(B, X, Y, Z, Ci, Co, sms)
        out = torch.empty((Co, Ci, 3, 3, 3), dtype=torch.float32, device=dev)
        # f32 partial sums of the clusters, added in order by a second pass
        parts = v.splits // v.cluster
        ws = (torch.empty((parts, Co, Ci, 27), dtype=torch.float32,
                          device=dev) if parts > 1 else None)
        _, args = _dw_args((B, X, Y, Z, Ci, Co), v)
        code = lib.conv3x3x3_dw_bf16(
            x.data_ptr(), dy.data_ptr(),
            ws.data_ptr() if ws is not None else None, out.data_ptr(), args,
            stream)
        kernels.check(code, what)
        kernels.count_launch(conv3x3x3_dw)
        return out
    tx, ty, tz = halo_box(X, Y, Z)
    boxes = B * math.ceil(X / tx) * math.ceil(Y / ty) * math.ceil(Z / tz)
    bn = 32 if Co % 32 == 0 else 16
    splits = dw_splits(Ci, Co, bn, boxes, sms)
    out = torch.empty((27, Ci, Co), dtype=torch.float32, device=dev)
    ws = (torch.empty((splits, 27, Ci, Co), dtype=torch.float32,
                      device=dev) if splits > 1 else out)
    code = lib.conv3x3x3_dw_f32(x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                                out.data_ptr(), B, X, Y, Z, Ci, Co, tx, ty,
                                tz, bn, splits, stream)
    kernels.check(code, what)
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


#: kernel D (``conv3x3x3_dxdw.cu``): a box is DXDW_TILES z planes of 8 x 8
#: voxels, one per warpgroup; the (ci tile, co group) pairs it is built for;
#: one (plane, 8-channel group) of its slabs in shared memory (`Slab`)
DXDW_TILES = 3
DXDW_PAIRS = ((16, 16), (32, 32), (16, 64))
SLAB_PLANE = (10 * 10 + 6) * 16


class DxdwVariant(NamedTuple):
    """How kernel D's bf16 kernel runs one shape: the input channels of one
    CTA (dx's columns, dW's rows), its group of output channels (dx's
    reduction slice, dW's columns), the ring's stages, and the CTAs that
    share the boxes of one (ci tile, co group)."""
    ci_tile: int
    co_group: int
    stages: int
    splits: int

    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA (`DxdwShape` in the source):
        its weights and ``stages`` x (x slab of DXDW_TILES + 3 planes, dy
        slab of DXDW_TILES + 2)."""
        x = (DXDW_TILES + 3) * (self.ci_tile // 8) * SLAB_PLANE
        d = (DXDW_TILES + 2) * (self.co_group // 8) * SLAB_PLANE
        w = 27 * self.ci_tile * self.co_group * 2
        return CONV_BAR_BYTES + w + self.stages * (x + d)

    def ctas_per_sm(self) -> int:
        """By registers (`__launch_bounds__`: two CTAs only for (16, 16))
        and shared memory."""
        by_regs = 2 if (self.ci_tile, self.co_group) == (16, 16) else 1
        return min(by_regs, CONV_SM_SMEM // (self.smem_bytes()
                                             + CONV_CTA_RESERVED))


def dxdw_boxes(B: int, X: int, Y: int, Z: int) -> int:
    """Kernel D's boxes (8 x 8 x DXDW_TILES voxels) over the volumes."""
    return dw_boxes(B, X, Y, Z, DXDW_TILES)


def dxdw_candidates(B: int, X: int, Y: int, Z: int, C: int,
                    sms: int) -> Tuple[DxdwVariant, ...]:
    """Every (ci tile, co group) pair that divides C, each with the most
    stages that fit and the splits that fill the card: about one wave of
    resident CTAs, at most one split per box, and the splits' dW partials
    (27*C*C f32 each) within ``DW_WORKSPACE_BYTES``."""
    boxes = dxdw_boxes(B, X, Y, Z)
    room = max(DW_WORKSPACE_BYTES // (27 * C * C * 4), 1)
    found = []
    for ci, cg in DXDW_PAIRS:
        if C % ci or C % cg:
            continue
        v = DxdwVariant(ci, cg, 2, 1)
        per_sm = v.ctas_per_sm()
        if not per_sm:
            continue
        limit = min(CONV_SM_SMEM // per_sm - CONV_CTA_RESERVED,
                    CONV_SMEM_LIMIT)
        stages = max(s for s in range(2, CONV_MAX_STAGES + 1)
                     if s == 2 or v._replace(stages=s).smem_bytes() <= limit)
        tiles = (C // ci) * (C // cg)
        splits = max(1, min(boxes, round(per_sm * sms / tiles), room))
        found.append(DxdwVariant(ci, cg, stages, splits))
    return tuple(found)


#: kernel D: the most bytes of f32 dx partial sums (C / 32 copies of dx) a
#: (32, 32) variant may cross CTAs with before (16, 64), which writes half
#: as many, is taken instead
DXDW_DX_PARTIALS_BYTES = 16 << 20


@functools.lru_cache(maxsize=None)
def dxdw_variant(B: int, X: int, Y: int, Z: int, C: int,
                 sms: int) -> DxdwVariant:
    """Kernel D's variant for one shape, from the shape and the SM count
    alone (the rules follow ``scripts/torch_conv_variants.py --dxdw``):
    (32, 32), N = 32 on both products, where 32 divides C, unless its f32
    dx partial sums (C / 32 copies of dx when C > 32) pass
    ``DXDW_DX_PARTIALS_BYTES`` and 64 divides C: then (16, 64), half the
    copies; (16, 16) where 32 does not divide C. Stages and splits as
    :func:`dxdw_candidates` gives them."""
    found = {(v.ci_tile, v.co_group): v
             for v in dxdw_candidates(B, X, Y, Z, C, sms)}
    if not found:
        raise ValueError(f"dxdw_variant: no variant takes C={C}")
    partials = 4 * B * X * Y * Z * C * (C // 32 if C > 32 else 0)
    if (16, 64) in found and partials > DXDW_DX_PARTIALS_BYTES:
        return found[(16, 64)]
    return found.get((32, 32), found[(16, 16)])


def dxdw_pack_reference(w: torch.Tensor, ci_tile: int) -> torch.Tensor:
    """Plain statement of the order kernel D's ``pack_weights`` writes the
    (C, C, 3, 3, 3) weights in: flat
    ``[ci tile][co chunk of 16][tap][half][ci of the tile][8 co]`` =
    ``w[16*chunk + 8*half + e, ci_tile*CI + n, 26 - tap]``."""
    C = w.shape[0]
    t = w.reshape(C // 16, 2, 8, C // ci_tile, ci_tile, 27).flip(5)
    return t.permute(3, 0, 5, 1, 4, 2).reshape(-1)


class _DxdwArgs(ctypes.Structure):
    """`DxdwArgs` of ``conv3x3x3_dxdw.cu``: one bf16 launch's shape and
    variant."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "B", "X", "Y", "Z", "C", "ci_tile", "co_group", "stages", "splits")]


@functools.lru_cache(maxsize=None)
def _dxdw_args(shape: Tuple[int, ...],
               v: DxdwVariant) -> Tuple[_DxdwArgs, int]:
    args = _DxdwArgs(*shape, v.ci_tile, v.co_group, v.stages, v.splits)
    return args, ctypes.addressof(args)


def conv3x3x3_dxdw(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                   variant: Optional[DxdwVariant] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dW) of the SAME conv with Ci == Co from x, dy (B,C,X,Y,Z) and
    w (C,C,3,3,3) of one dtype, in one launch of kernel D (after the launch
    that packs w, and before its fixed-order second pass when sums cross
    CTAs): exactly ``(conv3x3x3_dx(dy, w), conv3x3x3_dw(x, dy))``, dx
    channels_last_3d in x's dtype, dW f32. ``variant`` overrides
    :func:`dxdw_variant` (the tuning script's sweep)."""
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
    w = w.contiguous()          # (C, C, 27) as the kernels read it
    dev = x.device
    sms = _sm_count(dev.index or 0)
    dx = torch.empty_like(x)    # channels_last_3d, as x
    dw = torch.empty((27, C, C), dtype=torch.float32, device=dev)
    lib = kernels.library("conv3x3x3_dxdw")
    stream = kernels.stream_handle(dev)
    if x.dtype == torch.bfloat16:
        v = variant or dxdw_variant(B, X, Y, Z, C, sms)
        cg, splits = v.co_group, v.splits
        wpk = torch.empty(27 * C * C, dtype=x.dtype, device=dev)
        _, args = _dxdw_args((B, X, Y, Z, C), v)
        ptrs = [x, dy, w, wpk, dx]
    else:
        tx, ty, tz = halo_box(X, Y, Z)
        boxes = B * math.ceil(X / tx) * math.ceil(Y / ty) * math.ceil(Z / tz)
        cg = 32 if C % 32 == 0 else 16      # output channels of one CTA
        splits = dw_splits(C, C, cg, boxes, sms)
        ptrs = [x, dy, w, dx]
    # f32 workspaces of what crosses CTAs, added in order by a second pass:
    # dx's partial sums per channel group, dW's per split
    dx_ws = (torch.empty((C // cg, B, X, Y, Z, C), dtype=torch.float32,
                         device=dev) if C > cg else None)
    dw_ws = (torch.empty((splits, 27, C, C), dtype=torch.float32, device=dev)
             if splits > 1 else None)
    ptrs = [t.data_ptr() for t in ptrs] + [
        t.data_ptr() if t is not None else None for t in (dx_ws, dw_ws)] + [
        dw.data_ptr()]
    if x.dtype == torch.bfloat16:
        code = lib.conv3x3x3_dxdw_bf16(*ptrs, args, stream)
    else:
        code = lib.conv3x3x3_dxdw_f32(*ptrs, B, X, Y, Z, C, tx, ty, tz, cg,
                                      splits, stream)
    kernels.check(code, what)
    kernels.count_launch(conv3x3x3_dxdw)
    return dx, dw.view(3, 3, 3, C, C).permute(4, 3, 0, 1, 2).contiguous()


class Conv3x3x3Function(torch.autograd.Function):
    """The SAME conv with the JAX package's backward. Unfused (`_merged_bwd`,
    `conv3d.py:570-586`): dx by kernel B on dy cast to x's dtype with the
    flipped, io-transposed weights; dW by kernel C in f32, cast to w's
    dtype. With ``fused``, when both gradients are needed and
    :func:`fused_bwd_eligible` (the gate of `layers.py:135-144`): both by
    kernel D.

    With ``halo`` (a space split, ``parallel.mesh.halo``) x is a slab of
    X + 2 planes whose first and last are its neighbours' planes (or
    zeros): the kernels run on the padded slab and the output keeps its X
    inner planes, the whole volume's conv there. The backward pads dy with
    a zero plane on each side: B-as-dx (or D) then gives the gradient of
    the padded slab, whose two halo planes the exchange sends back to
    their owners, and C (or D's dW) on the padded x and dy gives this
    slab's share of dW, which the step's gradient all-reduce sums."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor,
                fused: bool = False, halo: bool = False) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.fused, ctx.halo = fused, halo
        y = conv3x3x3_same(x, w)
        return y[:, :, 1:-1] if halo else y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        if ctx.halo:
            dy = F.pad(dy, (0, 0, 0, 0, 1, 1))
        if dy.is_cuda:     # one layout copy, shared by dx and dW
            dy = dy.contiguous(memory_format=torch.channels_last_3d)
        if ctx.fused and all(ctx.needs_input_grad[:2]) \
                and fused_bwd_eligible(x.shape[1], w.shape[0]):
            dx, dw = conv3x3x3_dxdw(x, dy, w)
            return dx, dw.to(w.dtype), None, None
        dx = conv3x3x3_dx(dy, w) if ctx.needs_input_grad[0] else None
        dw = (conv3x3x3_dw(x, dy).to(w.dtype) if ctx.needs_input_grad[1]
              else None)
        return dx, dw, None, None


#: kernel launches; a caller sets them to 0 before the run it counts
conv3x3x3_same.launches = 0
conv3x3x3_dx.launches = 0
conv3x3x3_dw.launches = 0
conv3x3x3_dxdw.launches = 0
