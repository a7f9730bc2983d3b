"""Kernel launches the host issued a step in the host-traced dispatch
groups, a CUDA graph's replay counted as one (train/graphs.py)."""

from benchmark import trace

LAYER = "dispatch groups (train/graphs.py)"
MOVES = "train_patches_per_s"


def read(ctx):
    counts = trace.host_counts_of(ctx)
    if counts is None:
        return None
    return counts["launches"] / ctx["traces"]["host"]["steps"]
