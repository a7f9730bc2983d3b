"""Device ms a step of the model's norm, activation, cast, add and
optimizer passes in the device-traced dispatch groups: the kernels of the
families below (by name). The kernels no family matches are printed on
standard error as ``other`` beside each family's ms, so that a renamed
kernel shows."""

import sys

from benchmark import trace

LAYER = "model (models/vnet3d.py, models/unet3d.py, models/layers.py)"
MOVES = "train_patches_per_s"

#: family -> name fragments (lower case); the first family that matches
#: takes the kernel
FAMILIES = (
    ("conv", ("conv3x3x3", "dw_bf16", "dw_reduce", "pack_weights",
              "reduce_splits", "xmma", "cudnn", "implicit_conv", "sm90_",
              "cutlass", "conv", "gemm", "wgrad", "dgrad")),
    ("norm_act", ("elementwise", "foreach", "batch_norm", "reduce",
                  "catarray", "where", "relu", "cast", "copy_kernel")),
    ("nms", ("max_pool", "pool", "bincount", "index", "gather",
             "argmax")),
    ("memory", ("memcpy", "memset")),
)


def split(spans):
    """device seconds by family, and the unmatched as ``other``."""
    out = {}
    for name, (s, _) in trace.by_name(spans).items():
        low = name.lower()
        fam = next((f for f, keys in FAMILIES
                    if any(k in low for k in keys)), "other")
        out[fam] = out.get(fam, 0.0) + s
    return out


def read(ctx):
    spans = trace.device_spans_of(ctx)
    if not spans:
        return None
    fams = split(spans)
    steps = ctx["traces"]["device"]["steps"]
    print("norm_act families (ms a step): " + ", ".join(
        f"{k} {1e3 * v / steps!r}" for k, v in sorted(fams.items())),
        file=sys.stderr)
    return 1e3 * fams.get("norm_act", 0.0) / steps
