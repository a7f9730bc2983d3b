"""Device ms a step of the pseudo-labels' NMS in the host-traced dispatch
groups: the operations launched inside ``step.nms``, its ``nms.round``
spans included. Each program span's device and idle ms a step (by the
innermost span), and what no span covers, are printed on standard
error."""

from benchmark import spans

LAYER = "steps: NMS (ops/cc.py)"
MOVES = "train_patches_per_s"


def read(ctx):
    got = spans.of(ctx, ("step.nms",))
    if got is None:
        return None
    att, steps = got
    spans.print_table(att, steps, "step")
    return 1e3 * att.busy_s("step.nms") / steps
