"""Host ms a step of the feed's batches in the host-traced dispatch groups:
the ``feed.batch`` spans (the device store's draws and crop launches, a
K-stacked batch a group) over the traced steps."""

from benchmark import spans

LAYER = "feed (data/feed.py, data/device_store.py)"
MOVES = "train_patches_per_s"


def read(ctx):
    got = spans.of(ctx, ("feed.batch",))
    if got is None:
        return None
    att, steps = got
    return 1e3 * att.host_s["feed.batch"] / steps
