"""The evaluator's share of the card's bf16 peak: the matrix products'
operations of a volume's real windows (padding windows not counted),
counted from the shapes the forward's convs and linear layers were called
at, with the products the architecture's file adds, over the window's
time a volume, over the peak."""

LAYER = "evaluator (eval/sliding_window.py)"
MOVES = "infer_s_per_volume"


def read(ctx):
    if ctx["peaks"] is None:
        return None
    rate = ctx["volume_flops"] * ctx["volumes"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"][0]
