"""Share of the traced dispatch groups in which the device ran nothing:
1 - busy / window, busy from the device trace, window the host time
between the synchronisations around the traced groups."""

from benchmark import trace

LAYER = "device (H100)"
MOVES = "train_patches_per_s"


def read(ctx):
    return trace.idle_percent(ctx)
