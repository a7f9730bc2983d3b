"""Device ms a step of the student's update in the host-traced dispatch
groups: the operations launched inside ``step.update`` (graph S's
replay: mix, forward, losses, backward, SGD, EMA)."""

from benchmark import spans

LAYER = "steps (train/steps.py)"
MOVES = "train_patches_per_s"


def read(ctx):
    got = spans.of(ctx, ("step.update",))
    if got is None:
        return None
    att, steps = got
    return 1e3 * att.busy_s("step.update") / steps
