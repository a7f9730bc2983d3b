"""The operations and bytes behind ``mfu.*`` and ``conv_roofline.*``, and
the table of peaks they are held against.

A conv is counted from its shapes alone: 2 * N * Co * Ci * k^3
operations per output voxel of a conv (per input voxel of a transposed
conv, whose kernel scatters), the same for dx and again for dW. A
linear layer: 2 * rows * in * out, the same for dx and again for dW.
The matrix products no module call shows (attention's) come from the
reference architecture's file (``nets.extra_flops``). Bytes: each input
read once and each output written once, in the compute dtype (bf16),
whatever the kernel reads again. Only the matrix products are counted:
the norms, activations and losses add operations no peak is quoted for,
so ``mfu`` is the share of the chip's matrix peak that the matrix
products alone would fill.
"""

from __future__ import annotations

from math import prod
from typing import Dict, Optional, Sequence, Tuple

#: device name -> (bf16 dense FLOP/s, HBM bytes/s) at the data sheet's
#: power limit (NVIDIA H100 data sheet, dense rates without sparsity)
PEAKS: Dict[str, Tuple[float, float]] = {
    "H100 80GB HBM3": (989e12, 3.35e12),      # SXM5, 700 W
}


def peaks(device_name: str) -> Optional[Tuple[float, float]]:
    """(FLOP/s, bytes/s) of a card by its ``torch.cuda.get_device_name``;
    None for a card the table does not hold (the share is then not
    reported, never guessed)."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


def conv_flops(x_shape: Sequence[int], w_shape: Sequence[int],
               y_shape: Sequence[int], transposed: bool) -> int:
    """Operations of one conv forward (a multiply and an add each)."""
    n = x_shape[0]
    ci, co = (w_shape[0], w_shape[1]) if transposed else (w_shape[1],
                                                          w_shape[0])
    k = prod(w_shape[2:])
    voxels = prod(x_shape[2:]) if transposed else prod(y_shape[2:])
    return 2 * n * ci * co * k * voxels


def linear_flops(x_shape: Sequence[int], w_shape: Sequence[int]) -> int:
    """Operations of one linear layer's forward: every row of x times the
    (out, in) weight."""
    return 2 * prod(x_shape[:-1]) * w_shape[0] * w_shape[1]


def conv_bytes(x_shape, w_shape, y_shape, bias: bool, itemsize: int = 2
               ) -> int:
    """Bytes of one conv forward: x and w (and the bias) read, y
    written."""
    n = prod(x_shape) + prod(w_shape) + prod(y_shape)
    if bias:
        n += y_shape[1]
    return n * itemsize


def backward_flops(x_shape, w_shape, y_shape, transposed: bool,
                   dx: bool) -> int:
    """dW, and dx when the input needs a gradient: each costs a
    forward."""
    f = conv_flops(x_shape, w_shape, y_shape, transposed)
    return f * (2 if dx else 1)


def backward_bytes(x_shape, w_shape, y_shape, bias: bool, dx: bool,
                   itemsize: int = 2) -> int:
    """dy, x and w read; dW (and dbias) and, with ``dx``, dx written."""
    n = prod(y_shape) + prod(x_shape) + 2 * prod(w_shape)
    if bias:
        n += y_shape[1]
    if dx:
        n += prod(x_shape)
    return n * itemsize


def bound_s(flops: float, nbytes: float, peak: Tuple[float, float]
            ) -> float:
    """The least time the chip could take: operations or bytes, whichever
    binds."""
    return max(flops / peak[0], nbytes / peak[1])


def roofline_percent(ctx) -> Optional[float]:
    """100 * (sum of the timed calls' bounds) / (sum of their times), each
    call weighted by its count in the step or forward; None off the card
    or without timings."""
    calls, peak = ctx.get("conv_times"), ctx.get("peaks")
    if not calls or peak is None:
        return None
    bound = sum(c["count"] * bound_s(c["flops"], c["bytes"], peak)
                for c in calls)
    spent = sum(c["count"] * c["seconds"] for c in calls)
    return 100.0 * bound / spent
