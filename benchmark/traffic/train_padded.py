"""The ``train`` driver for volumes shorter than the patch along an axis:
the self-train stage exactly as ``train.py`` runs and checks it, with the
plain reference's feed padding each volume first, as LA's ``RandomCrop``
does (BCP's ``dataset.py:190-196``): once some
axis of a volume is no longer than the patch, every axis is padded with
zeros by ``max((patch - dim) // 2 + 3, 0)`` a side, and the crops are
drawn and cut from the padded volume. ``train.py``'s reference feed cuts
the volumes as they are, which is right only where every axis is longer
than the patch.

    python3 benchmark/traffic/train_padded.py --workload <cell> --seeds <n> [<n> ...]

prints a cell's control and fault readings as ``benchmark/control.py``
prints a ``train`` cell's, with the same padded feed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from benchmark import control, harness  # noqa: E402
from benchmark.reference import bcp  # noqa: E402

#: ``RandomCrop``'s pad beyond half the shortfall
PAD_EXTRA = 3

train = harness.load_module(os.path.join(HERE, "train.py"),
                            "bench_traffic_train")


def padded(volumes, patch):
    """The (image, label) pairs, each padded as ``RandomCrop`` pads it."""
    out = []
    for img, lab in volumes:
        if all(int(s) > int(p) for s, p in zip(img.shape, patch)):
            out.append((img, lab))
            continue
        pads = [(max((int(p) - int(s)) // 2 + PAD_EXTRA, 0),) * 2
                for s, p in zip(img.shape, patch)]
        out.append((np.pad(img, pads, mode="constant"),
                    np.pad(lab, pads, mode="constant")))
    return out


class PaddedFeed(bcp.Feed):
    """:class:`bcp.Feed` over the padded volumes."""

    def __init__(self, volumes, n_lab, batch, unlab_bs, patch, seed):
        super().__init__(padded(volumes, patch), n_lab, batch, unlab_bs,
                         patch, seed)


@contextlib.contextmanager
def padded_feed():
    """The reference's feed pads while the block runs."""
    plain = bcp.Feed
    bcp.Feed = PaddedFeed
    try:
        yield
    finally:
        bcp.Feed = plain


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, shrink=None) -> dict:
    with padded_feed():
        return train.run(cell, seed, seconds, trace, device, t0, shrink)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control and fault "
                                "readings of a train_padded cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = harness.Registry(os.path.dirname(os.path.dirname(HERE))).cell(
        args.workload)
    cfg = harness.merged_config(cell)
    with padded_feed():
        for seed in args.seeds:
            got = control.train_readings(
                cfg, seed, torch.device("cuda"),
                int(cell.workload["checked_steps"]),
                control.warm_group(cell.workload))
            for kind, nums in got.items():
                print(json.dumps({"seed": seed, "kind": kind, **nums}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
