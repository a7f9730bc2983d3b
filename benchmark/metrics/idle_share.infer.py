"""Share of the traced volumes in which the device ran nothing: 1 -
busy / window, busy from the device trace, window the host time between
the synchronisations around the traced volumes."""

from benchmark import trace

LAYER = "device (H100)"
MOVES = "infer_s_per_volume"


def read(ctx):
    return trace.idle_percent(ctx)
