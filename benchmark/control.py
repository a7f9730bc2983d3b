"""The correctness check's control and planted faults, read on the card at
a cell's own size (the benchmark's runs never run them):

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

prints, for each seed, the numbers the cell's check compares when the
plain reference stands in the program's place computed in fp8 (the
control: the next precision below the bf16 the configurations state),
(``bf16``: the same reference rounded to the bf16 the configurations
state, a second witness of what rounding alone does), and with each
fault a cell of its kind can have planted in the reference:

- train cells: ``half_batch`` (the losses over the first sample of each
  mixed pair), ``plab`` (a pseudo-label inverted where the NMS produces
  it); a step that leaves its state unchanged reads 1 on the change by
  the check's own measure and needs no run;
- infer cells: ``half_windows`` (half the windows of each chunk left
  out, the mean taken over the rest), ``altered`` (a window's labels
  inverted where the label is produced).

Each line is JSON: {"seed", "kind", <number>: <reading>, ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Sequence

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import compare, data, harness  # noqa: E402
from benchmark.reference import bcp, nets, sliding  # noqa: E402

TRAIN_KINDS = ("fp8", "bf16", "half_batch", "plab")
INFER_KINDS = ("fp8", "bf16", "half_windows", "altered")


def train_readings(cfg: dict, seed: int, device, checked: int,
                   group: Sequence[int], kinds=TRAIN_KINDS):
    """{kind: the train check's numbers} of the reference run as each
    kind against the plain f32 reference, on the cell's volumes and
    weights for ``seed``, through the last warm-up group ``group`` (its
    iterations)."""
    d = cfg["data"]
    nets.strict_f32()
    volumes = data.blob_volumes(seed, 0, d["train_volumes"],
                                d["volume_shape"], device)
    weights = data.seeded_weights(cfg["reference_net"], cfg["widths"], seed,
                                  device)
    keep = (checked, group[0] - 1, group[-1])

    def one(**kw):
        feed = bcp.Feed(volumes, d["labelled"], cfg["batch_size"],
                        cfg["batch_size"] - cfg["labeled_bs"],
                        cfg["patch_size"], seed)
        stage = bcp.SelfTrain(cfg, weights, device, **kw)
        losses, g1, kept = stage.run(feed, group[-1], seed, keep)
        return {"losses": dict(enumerate(losses, 1)), "g1": g1,
                "states": {0: (weights, weights), **kept}}

    base = one()
    out = {}
    for kind in kinds:
        got = (one(quantize=kind) if kind in nets.ROUNDING
               else one(faults=(kind,)))
        out[kind] = compare.train_numbers(got, base, checked, group)
    return out


def warm_group(workload: dict) -> range:
    """The iterations of a train cell's last warm-up group."""
    K, warm = int(workload["steps_per_dispatch"]), int(
        workload["warm_groups"])
    return range((warm - 1) * K + 1, warm * K + 1)


def half_window_scores(model, image, patch, sxy, sz, n_classes, device,
                       batch):
    """The reference's scores with the second half of each chunk's
    windows left out and the mean taken over the rest."""
    pads = [(max(p - d, 0) // 2, max(p - d, 0) - max(p - d, 0) // 2)
            for d, p in zip(image.shape, patch)]
    vol = torch.from_numpy(np.pad(image, pads)).to(device).float()
    origins = sliding.window_origins(vol.shape, patch, sxy, sz)
    kept = [o for i, o in enumerate(origins) if i % batch < batch // 2]
    score = torch.zeros((n_classes, *vol.shape), device=device)
    cnt = torch.zeros(vol.shape, device=device)
    px, py, pz = patch
    with torch.no_grad():
        for a, b, c in kept:
            x = vol[a:a + px, b:b + py, c:c + pz][None, None]
            score[:, a:a + px, b:b + py, c:c + pz] += torch.softmax(
                model(x), 1)[0]
            cnt[a:a + px, b:b + py, c:c + pz] += 1
    score /= cnt.clamp(min=1)
    sl = tuple(slice(lo, lo + d) for (lo, _), d in zip(pads, image.shape))
    return score[(slice(None),) + sl]


def infer_readings(cfg: dict, seed: int, device, volumes: int,
                   kinds=INFER_KINDS):
    """{kind: the infer check's numbers} of each kind's labels against the
    plain f32 reference's scores, on ``volumes`` of the cell's test
    volumes for ``seed``."""
    d, ev = cfg["data"], cfg["eval"]
    patch = tuple(cfg["patch_size"])
    nets.strict_f32()
    vols = data.blob_volumes(seed, 4, d["test_volumes"], d["volume_shape"],
                             device)
    images = [v[0] for v in vols][:volumes]
    calib = torch.from_numpy(np.ascontiguousarray(
        images[0][:patch[0], :patch[1], :patch[2]]))[None, None]
    weights = data.seeded_weights(cfg["reference_net"], cfg["widths"], seed,
                                  device, calibrate=calib)
    args = (patch, ev["stride_xy"], ev["stride_z"],
            cfg["widths"]["n_classes"], device, ev["eval_batch"])

    def model_of(**kw):
        m = nets.build(cfg["reference_net"], cfg["widths"], **kw).to(device)
        m.load_state_dict(weights)
        return m.eval()

    f32 = model_of()
    base = [sliding.scores(f32, img, *args)[1] for img in images]
    out = {}
    for kind in kinds:
        if kind in nets.ROUNDING:
            m = model_of(quantize=kind)
            p1 = [sliding.scores(m, img, *args)[1] for img in images]
        elif kind == "half_windows":
            p1 = [half_window_scores(f32, img, *args)[1] for img in images]
        else:
            p1 = [b.clone() for b in base]
            for p in p1:
                px, py, pz = patch
                p[:px, :py, :pz] = 1.0 - p[:px, :py, :pz]
        labels = [(p > 0.5).cpu().numpy().astype(np.uint8) for p in p1]
        out[kind] = compare.label_numbers(labels, base)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--volumes", type=int, default=3,
                   help="test volumes an infer cell's readings take")
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cell = harness.Registry(root).cell(args.workload)
    cfg = harness.merged_config(cell)
    device = torch.device("cuda")
    for seed in args.seeds:
        if cell.workload["driver"] == "train":
            got = train_readings(cfg, seed, device,
                                 int(cell.workload["checked_steps"]),
                                 warm_group(cell.workload))
        else:
            got = infer_readings(cfg, seed, device, args.volumes)
        for kind, nums in got.items():
            print(json.dumps({"seed": seed, "kind": kind, **nums}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
