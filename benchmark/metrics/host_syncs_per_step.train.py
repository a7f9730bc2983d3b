"""Host synchronisations a step in the host-traced dispatch groups (CUDA
stream, event and device synchronisations): what a graph step still
waits for on the host, the NMS's flag read each round (ops/cc.py) among
them."""

from benchmark import trace

LAYER = "steps (train/steps.py)"
MOVES = "train_patches_per_s"


def read(ctx):
    counts = trace.host_counts_of(ctx)
    if counts is None:
        return None
    return counts["syncs"] / ctx["traces"]["host"]["steps"]
