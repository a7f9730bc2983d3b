"""Device ms a step of the window attention's kernels (``window_attn_*``:
the forward, the backward's dQ and dK dV kernels and the table's sum) in
the device-traced dispatch groups; nothing where no such kernel ran."""

from benchmark import window_attn_counts

LAYER = "window attention (ops/window_attn.py, kernels/csrc/window_attn.cu)"
MOVES = "train_patches_per_s"


def read(ctx):
    s = window_attn_counts.kernel_seconds(ctx)
    if s is None:
        return None
    return 1e3 * s / ctx["traces"]["device"]["steps"]
