"""The evaluator's convolutions against their roofline: each conv module
the eval forward called, timed alone at the eval batch's shapes with CUDA
events; the sum of each call's bound over the sum of their times."""

from benchmark import counts

LAYER = "kernels (ops/conv3d.py, kernels/csrc)"
MOVES = "infer_s_per_volume"


def read(ctx):
    return counts.roofline_percent(ctx)
