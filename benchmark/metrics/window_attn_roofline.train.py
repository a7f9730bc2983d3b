"""The window attention's kernels against their roofline: the least time
of a step's launches (``benchmark/window_attn_counts.py``: the larger of
operations at the bf16 peak and bytes at the HBM rate, a launch) times
the traced steps, over the ``window_attn_*`` kernels' device time in the
traced groups, in %; nothing where no such kernel ran."""

from benchmark import window_attn_counts

LAYER = "window attention (ops/window_attn.py, kernels/csrc/window_attn.cu)"
MOVES = "train_patches_per_s"


def read(ctx):
    s = window_attn_counts.kernel_seconds(ctx)
    if s is None or ctx["peaks"] is None:
        return None
    bound = window_attn_counts.step_bound_s(ctx["config"], ctx["peaks"])
    return 100.0 * bound * ctx["traces"]["device"]["steps"] / s
