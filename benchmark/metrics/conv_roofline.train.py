"""The step's convolutions against their roofline: each conv module the
step called (kernel B and its dx, kernel C, the library's strided,
transposed and 1^3 convs), timed alone at its recorded shapes with CUDA
events, forward, and for the student the backward through autograd; the
sum of each call's bound over the sum of their times."""

from benchmark import counts

LAYER = "kernels (ops/conv3d.py, kernels/csrc)"
MOVES = "train_patches_per_s"


def read(ctx):
    return counts.roofline_percent(ctx)
