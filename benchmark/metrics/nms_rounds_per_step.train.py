"""NMS fixpoint rounds a step in the host-traced dispatch groups: the
``nms.round`` spans (each ends in a flag read, a host synchronisation)
over the traced steps."""

from benchmark import spans

LAYER = "steps: NMS (ops/cc.py)"
MOVES = "train_patches_per_s"


def read(ctx):
    got = spans.of(ctx, ("nms.round",))
    if got is None:
        return None
    att, steps = got
    return att.counts["nms.round"] / steps
