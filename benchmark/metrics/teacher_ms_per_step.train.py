"""Device ms a step of the teacher's forward and threshold in the
host-traced dispatch groups: the operations launched inside
``step.teacher`` (graph T's replay)."""

from benchmark import spans

LAYER = "steps (train/steps.py)"
MOVES = "train_patches_per_s"


def read(ctx):
    got = spans.of(ctx, ("step.teacher",))
    if got is None:
        return None
    att, steps = got
    return 1e3 * att.busy_s("step.teacher") / steps
