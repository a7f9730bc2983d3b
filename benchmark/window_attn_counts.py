"""The window attention's kernels in a traced train run: their device time,
and the least time the card could take for the same work, from the
configuration's shapes alone.

The attention of one SwinUNETR block over ``B`` samples is one forward
launch (O and each row's log-sum-exp) and, where the block is trained,
one backward (dQ, dK, dV and the table's gradient). With ``W`` windows of
``N`` tokens a sample, ``C`` channels and ``H`` heads:

- operations: q k^T and P v, 4 W N^2 C a sample forward; the backward
  recomputes P and forms dP, dQ, dK and dV, 10 W N^2 C;
- bytes: q, k, v and O in bf16 and the log-sum-exp in f32 forward; those
  and dO, dQ, dK and dV backward, with the table's gradient (f32) written
  once. Bias tables read, region ids and any per-block partials of the
  table's gradient are left out (a few MB a step beside GBs), so the bound
  stays a least time.

A step is the teacher's forward on the unlabelled samples and the
student's forward and backward on the mixed ones (``labeled_bs``), as
``mfu.train`` counts the step's other products.
"""

from __future__ import annotations

import re
from math import ceil, prod
from typing import Iterator, Optional, Tuple

from benchmark import counts, trace

#: the kernels' names in a device trace
KERNEL = re.compile(r"^(void )?window_attn_")


def blocks(widths: dict, patch) -> Iterator[Tuple[int, int, int, int]]:
    """(windows a sample, tokens a window, channels, heads) of each block:
    the window clipped to the grid, the grid padded to whole windows."""
    for s, (depth, heads) in enumerate(zip(widths["depths"],
                                           widths["num_heads"])):
        grid = [int(p) // (widths["patch_size"] * 2 ** s) for p in patch]
        ws = [min(widths["window_size"], g) for g in grid]
        windows = prod(ceil(g / w) for g, w in zip(grid, ws))
        for _ in range(depth):
            yield windows, prod(ws), widths["feature_size"] * 2 ** s, heads


def launch(windows: int, n: int, c: int, heads: int, samples: int,
           backward: bool, table: int) -> Tuple[int, int]:
    """(operations, bytes) of one launch over ``samples`` samples, with a
    bias table of ``table`` entries a head."""
    tokens = samples * windows * n
    fwd_bytes = tokens * (3 * c * 2 + c * 2 + heads * 4)
    if not backward:
        return 4 * samples * windows * n * n * c, fwd_bytes
    return (10 * samples * windows * n * n * c,
            fwd_bytes + tokens * (c * 2 + 3 * c * 2)
            + table * heads * 4)


def step_bound_s(cfg: dict, peak: Tuple[float, float]) -> float:
    """The sum of each launch's least time in one step."""
    teacher = int(cfg["batch_size"]) - int(cfg["labeled_bs"])
    student = int(cfg["labeled_bs"])
    table = (2 * cfg["widths"]["window_size"] - 1) ** 3
    total = 0.0
    for w, n, c, h in blocks(cfg["widths"], cfg["patch_size"]):
        for samples, backward in ((teacher, False), (student, False),
                                  (student, True)):
            total += counts.bound_s(
                *launch(w, n, c, h, samples, backward, table), peak)
    return total


def kernel_seconds(ctx) -> Optional[float]:
    """Device seconds of the ``window_attn_*`` kernels in the traced
    groups; None without a device trace or where no such kernel ran."""
    spans = trace.device_spans_of(ctx)
    if not spans:
        return None
    got = [s for name, (s, _) in trace.by_name(spans).items()
           if KERNEL.match(name)]
    return sum(got) if got else None
