"""Shifted-window attention with a relative position bias as one op with its
own backward: SwinUNETR's ``WindowAttention`` after its ``qkv`` layer.

For windows of N tokens (in (d, h, w) row-major order) and H heads of 16
channels, with q, k, v split from the ``qkv`` layer's output as
(3, heads, 16):

    A = (q / sqrt(16)) k^T + T[idx[n, m], h] + M[n, m],   O = softmax(A) v

``T`` is the block's (13^3, H) table (a parameter, f32), ``idx`` the 7^3
window's relative index ``((dd + 6) * 13 + dh + 6) * 13 + dw + 6`` (for a
window clipped below 7^3, N < 343, its ``[:N, :N]``, as MONAI's
``WindowAttention`` takes it), and ``M`` the shift mask: 0 where two
tokens of a shifted window lie in the same region of the padded grid, -100
elsewhere (MONAI's ``compute_mask``: per axis ``[0, P - w)``, ``[P - w, P -
s)``, ``[P - s, P)``); an unshifted window has none.

Replaces no Pallas kernel (the JAX package has no SwinUNETR). On the card,
a bf16 ``qkv`` takes the hand-written kernels of
``kernels/csrc/window_attn.cu``: the forward keeps K and V of a window in
shared memory, computes the scores with tensor-core MMAs in f32, gathers
the bias from the tokens' coordinates and the mask from their region ids,
runs an online f32 softmax and writes O (bf16) and each row's
log-sum-exp (f32), nothing N x N. The backward recomputes P from q, k and
the log-sum-exp (one kernel for dQ and the table's gradient, one for dK
and dV) and sums the table's gradient over windows and batch through
per-block partials and a fixed-order finalize: no atomics, so two calls
agree bit for bit. A CPU or f64 ``qkv`` takes the plain composition
(:func:`plain_window_attn`) and autograd's backward of it; a call on the
card that the kernels do not take (f32, heads not 16 wide, more than 343
tokens a window) is refused with a ``ValueError``, never given to the
plain composition. :func:`kernel_refusal` says why.

Rounding on the kernel route: the scores, softmax and log-sum-exp are f32;
P is rounded to bf16 for P v, O once to bf16; the backward's dS is f32
for the table's gradient and bf16 for dQ and dK.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bcp_tpu_torch import kernels
from bcp_tpu_torch.ops.conv3d import _sm_count

#: the head width the kernels take
HEAD_DIM = 16
#: the window the relative position table is built for (13^3 entries)
TABLE_WINDOW = 7
#: the most tokens a window holds
MAX_TOKENS = TABLE_WINDOW ** 3
#: the mask's value between tokens of different regions (MONAI's)
MASKED = -100.0
#: the backward's blocks a launch aims for on each SM
BWD_BLOCKS_PER_SM = 2


def table_size(window: int = TABLE_WINDOW) -> int:
    return (2 * window - 1) ** 3


def token_codes(n: int, window: int = TABLE_WINDOW) -> np.ndarray:
    """Each token ordinal's code ``(d * (2w - 1) + h) * (2w - 1) + w`` by
    its coordinates in the full window (so a clipped window takes the
    first N ordinals, as ``idx[:N, :N]`` does): ``idx[n, m] = code[n] -
    code[m] + code[-1]``."""
    t = np.arange(n)
    s = 2 * window - 1
    return (t // window ** 2) * s * s + (t // window) % window * s \
        + t % window


def relative_index(n: int, window: int = TABLE_WINDOW) -> np.ndarray:
    """The (n, n) relative position index (MONAI's
    ``relative_position_index[:n, :n]``)."""
    c = token_codes(n, window)
    return c[:, None] - c[None, :] + int(token_codes(window ** 3,
                                                     window)[-1])


def window_count(padded: Sequence[int], window: Sequence[int]) -> int:
    return math.prod(p // w for p, w in zip(padded, window))


def region_ids(padded: Sequence[int], window: Sequence[int],
               shift: Sequence[int]) -> np.ndarray:
    """The (windows, N) region id of each token of each window of the
    shifted, padded grid (MONAI's ``compute_mask`` regions, partitioned as
    the windows are)."""
    ids = []
    for p, w, s in zip(padded, window, shift):
        pos = np.arange(p)
        ids.append(np.where(pos < p - w, 0, np.where(pos < p - s, 1, 2)))
    grid = (ids[0][:, None, None] * 9 + ids[1][None, :, None] * 3
            + ids[2][None, None, :])
    (p0, p1, p2), (w0, w1, w2) = padded, window
    grid = grid.reshape(p0 // w0, w0, p1 // w1, w1, p2 // w2, w2)
    return grid.transpose(0, 2, 4, 1, 3, 5).reshape(-1, w0 * w1 * w2)


@functools.lru_cache(maxsize=None)
def _device_regions(padded: tuple, window: tuple, shift: tuple,
                    device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(region_ids(padded, window, shift).astype(
        np.uint8)).to(device)
    if t.is_cuda and not torch.cuda.is_current_stream_capturing():
        torch.cuda.current_stream(device).synchronize()
    return t


@functools.lru_cache(maxsize=None)
def _plain_tables(n: int, padded: tuple, window: tuple, shift: tuple,
                  device: torch.device):
    idx = torch.from_numpy(relative_index(n)).to(device)
    mask = None
    if any(shift):
        r = torch.from_numpy(region_ids(padded, window, shift)).to(device)
        mask = (r[:, :, None] != r[:, None, :])
    return idx, mask


def plain_window_attn(qkv: torch.Tensor, table: torch.Tensor,
                      padded: Sequence[int], window: Sequence[int],
                      shift: Sequence[int]) -> torch.Tensor:
    """The plain composition: O (B * windows, N, C) of ``qkv`` (B *
    windows, N, 3C) in qkv's dtype, the scores and softmax in f32 (f64
    for f64), P rounded to qkv's dtype for P v."""
    bw, n, c3 = qkv.shape
    heads = table.shape[1]
    c = c3 // 3
    hd = c // heads
    acc = torch.promote_types(torch.float32, qkv.dtype)
    q, k, v = qkv.view(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    idx, mask = _plain_tables(n, tuple(padded), tuple(window), tuple(shift),
                              qkv.device)
    s = torch.matmul(q.to(acc) * hd ** -0.5, k.to(acc).transpose(-1, -2))
    s = s + table.to(acc)[idx].permute(2, 0, 1)
    if mask is not None:
        nw = mask.shape[0]
        s = (s.view(-1, nw, heads, n, n)
             + torch.where(mask, MASKED, 0.0).to(acc)[:, None]).view(
            bw, heads, n, n)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(qkv.dtype).to(acc), v.to(acc))
    return o.transpose(1, 2).reshape(bw, n, c).to(qkv.dtype)


def kernel_refusal(qkv: torch.Tensor, table: torch.Tensor
                   ) -> Optional[str]:
    """Why the kernels cannot take a call on the card, or None: they take
    ``qkv`` (B * windows, N, 3 * 16 * H) bf16, dense on a 16-byte
    boundary, 0 < N <= 343, and the table (13^3, H) f32 on its device."""
    if qkv.dim() != 3 or table.dim() != 2:
        return (f"qkv {tuple(qkv.shape)} and table {tuple(table.shape)} "
                f"are not (windows, N, 3C) and (13^3, heads)")
    heads = table.shape[1]
    if qkv.dtype != torch.bfloat16 or table.dtype != torch.float32:
        return (f"the kernels take bf16 qkv and an f32 table, not "
                f"{qkv.dtype} and {table.dtype}")
    if qkv.shape[2] != 3 * HEAD_DIM * heads:
        return (f"the kernels take heads of {HEAD_DIM} channels, not "
                f"{qkv.shape[2] // 3} channels in {heads} heads")
    if not (0 < qkv.shape[1] <= MAX_TOKENS and qkv.shape[0] > 0):
        return (f"the kernels take 1 to {MAX_TOKENS} tokens a window, not "
                f"{tuple(qkv.shape[:2])} windows and tokens")
    if table.shape[0] != table_size() or table.device != qkv.device:
        return (f"the table is {tuple(table.shape)} on {table.device}, not "
                f"({table_size()}, {heads}) on {qkv.device}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        return "qkv is not dense on a 16-byte boundary"
    return None


def _regions_ptr(regions: Optional[torch.Tensor]) -> Optional[int]:
    return None if regions is None else regions.data_ptr()


def window_attn_fwd(qkv: torch.Tensor, table_t: torch.Tensor,
                    regions: Optional[torch.Tensor], windows: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O (bf16, (B * windows, N, C)) and the log-sum-exp of each row (f32,
    (B * windows, H, N)) on the card (kernel ``window_attn_fwd``);
    ``table_t`` is the table transposed, (H, 13^3), and ``regions`` the
    (windows, N) uint8 region ids of a shifted block or None."""
    bw, n, c3 = qkv.shape
    heads = table_t.shape[0]
    out = torch.empty((bw, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((bw, heads, n), dtype=torch.float32,
                      device=qkv.device)
    code = kernels.library("window_attn").window_attn_fwd_bf16(
        qkv.data_ptr(), table_t.data_ptr(), _regions_ptr(regions),
        out.data_ptr(), lse.data_ptr(), bw, n, heads, windows,
        kernels.stream_handle(qkv.device))
    kernels.check(code, "window_attn_fwd")
    kernels.count_launch(window_attn_fwd)
    return out, lse


def bwd_slots(bw: int, heads: int, sms: int) -> int:
    """The window slots of the dQ kernel's grid (heads x slots blocks,
    each looping over its windows): about ``BWD_BLOCKS_PER_SM`` blocks an
    SM, at most one a window."""
    return max(1, min(bw, -(-BWD_BLOCKS_PER_SM * sms // heads)))


def window_attn_bwd(dout: torch.Tensor, qkv: torch.Tensor,
                    table_t: torch.Tensor, regions: Optional[torch.Tensor],
                    out: torch.Tensor, lse: torch.Tensor, windows: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of qkv (bf16, qkv's layout) and of the table (f32,
    (13^3, H)) on the card (kernels ``window_attn_bwd_dq``,
    ``window_attn_bwd_dkdv`` and ``window_attn_dt_sum``)."""
    bw, n, _ = qkv.shape
    heads = table_t.shape[0]
    dev = qkv.device
    dout = dout.contiguous()
    slots = bwd_slots(bw, heads, _sm_count(dev.index or 0))
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)
    part = torch.empty((slots, heads, table_size()), dtype=torch.float32,
                       device=dev)
    dtable = torch.empty((table_size(), heads), dtype=torch.float32,
                         device=dev)
    code = kernels.library("window_attn").window_attn_bwd_bf16(
        qkv.data_ptr(), table_t.data_ptr(), _regions_ptr(regions),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), part.data_ptr(), dtable.data_ptr(), bw, n, heads,
        windows, slots, kernels.stream_handle(dev))
    kernels.check(code, "window_attn_bwd")
    kernels.count_launch(window_attn_bwd)
    return dqkv, dtable


#: kernel launches; a caller sets them to 0 before the run it counts
window_attn_fwd.launches = 0
window_attn_bwd.launches = 0


class WindowAttnFunction(torch.autograd.Function):
    """The kernels' forward and backward; saves qkv, the transposed table,
    O and the log-sum-exp."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, table: torch.Tensor,
                regions: Optional[torch.Tensor], windows: int
                ) -> torch.Tensor:
        table_t = table.t().contiguous()
        out, lse = window_attn_fwd(qkv, table_t, regions, windows)
        ctx.save_for_backward(qkv, table_t, out, lse)
        ctx.regions, ctx.windows = regions, windows
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, table_t, out, lse = ctx.saved_tensors
        dqkv, dtable = window_attn_bwd(dout, qkv, table_t, ctx.regions, out,
                                       lse, ctx.windows)
        return dqkv, dtable, None, None


def window_attention(qkv: torch.Tensor, table: torch.Tensor,
                     padded: Sequence[int], window: Sequence[int],
                     shift: Sequence[int]) -> torch.Tensor:
    """O (B * windows, N, C) of the windowed ``qkv`` (B * windows, N, 3C:
    the ``qkv`` layer's output, windows in row-major order of the padded
    grid ``padded``, each sample's in turn) with the block's table (13^3,
    H), its window and its shift (all zero: no mask). The plain
    composition for a CPU or f64 ``qkv``; else the kernels, or a
    ``ValueError`` naming what they do not take."""
    padded, window, shift = tuple(padded), tuple(window), tuple(shift)
    if not qkv.is_cuda or qkv.dtype == torch.float64:
        return plain_window_attn(qkv, table, padded, window, shift)
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        qkv = qkv.clone(memory_format=torch.contiguous_format)
    why = kernel_refusal(qkv, table)
    if why is not None:
        raise ValueError(f"window attention on the card: {why}")
    regions = (_device_regions(padded, window, shift, qkv.device)
               if any(shift) else None)
    return WindowAttnFunction.apply(qkv, table, regions,
                                    window_count(padded, window))
