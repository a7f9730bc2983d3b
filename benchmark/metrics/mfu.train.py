"""The whole step's share of the card's bf16 peak: the convolutions' operations
a step requires (the teacher's forward on the unlabelled half, the
student's forward and backward on the mixed patches, counted from the
shapes the step's convs were called at; no recomputation) times the
window's steps, over the window's time, over the peak."""

LAYER = "steps (train/steps.py)"
MOVES = "train_patches_per_s"


def read(ctx):
    if ctx["peaks"] is None:
        return None
    rate = ctx["step_flops"] * ctx["steps"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"][0]
