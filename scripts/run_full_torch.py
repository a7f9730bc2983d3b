"""Full-schedule training runs of the PyTorch/CUDA port on synthetic data:
the port's counterpart of ``scripts/run_full_la.py`` and
``scripts/run_full_variants.py``.

    PYTHONPATH=. python3 scripts/run_full_torch.py --variant la \\
        [--pre 2000] [--self 15000] [--k 10] [--out RUN_TORCH_LA.json]

It runs the port's train CLI core (``cli.train_{la,acdc,pancreas}.train``)
in this process, at the CLI's defaults (the card, bf16, the device data
store, background validation) and the reference's schedules, on synthetic
volumes made in memory at the split sizes and shapes the JAX scripts use
(the card's machine has no h5py, so nothing is written as h5):

- ``la``: 2000 + 15000 iterations, validation every 200; 80 train volumes
  of 180x150x88, the first 8 labelled, and 20 validation volumes
  (`run_full_la.py:86-112`, `LA_BCP_train.py:351-371`);
- ``acdc``: 10000 + 30000 iterations, validation every 200; 1312 train
  slices of 256x216 (7 patients, 136 slices, labelled) and 20 validation
  volumes of 10x256x216 (`run_full_variants.py:48-52,86-95`);
- ``pancreas``: 60 + 200 epochs (1800 + 5000 iterations), validation every
  20 epochs; 12 labelled and 50 unlabelled volumes of 160x144x112 and 18
  test volumes (`run_full_variants.py:53-56,96-103`).

``--pre`` / ``--self`` cut a schedule (iterations for LA and ACDC, epochs
for pancreas, as the CLIs count them); ``--k`` is ``--steps_per_dispatch``
and must divide the validation cadence and both stages' iterations.

It writes one JSON (``RUN_TORCH_<VARIANT>.json`` by default): per stage
the wall clock, the validation and checkpoint pauses and the best Dice,
parsed from the trainer's ``stage ... done:`` log line, and the
distribution of its per-100-iteration block times from the log's time
stamps; each stage's CUDA graph captures and replays; the validations
run; the peak device memory; the data's set-up time; the card's name and
power limit (``nvidia-smi``). For pancreas also the largest magnitude of
the 29 conv biases in front of an instance norm, at the seeded start and
in each stage's last checkpoint: the forward cancels them, so their
gradient is rounding noise that Adam turns into moves of about the
learning rate a step.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: the trainer's end-of-stage line (``train.trainer``), as the JAX
#: script's ``STAGE_RE`` reads it (`run_full_la.py:30-34`)
STAGE_RE = re.compile(
    r"stage (?P<stage>\w+) done: (?P<steps>\d+) steps in "
    r"(?P<wall>[\d.]+)s \((?P<per>[\d.]+) s/step\), "
    r"validation\+ckpt pauses (?P<val>[\d.]+)s \((?P<valpct>[\d.]+)%\), "
    r"best dice (?P<dice>[\d.]+)")
#: one line an iteration: LA's and ACDC's ``iteration N :``, pancreas'
#: meter line ``Epoch : E, ...``
ITER_RE = re.compile(
    r"\[(\d+:\d+:\d+)\.(\d+)\] (?:iteration (\d+) |Epoch : )")

#: the JAX scripts' split sizes and shapes
DATA = {
    "la": dict(n_train=80, labelnum=8, n_val=20, shape=(180, 150, 88)),
    "acdc": dict(n_slices=1312, labelnum=7, n_val=20, shape=(256, 216),
                 depth=10),
    "pancreas": dict(n_lab=12, n_unlab=50, n_test=18, shape=(160, 144, 112)),
}
#: the reference's full schedules (iterations; pancreas' in epochs)
SCHEDULE = {"la": (2000, 15000), "acdc": (10000, 30000),
            "pancreas": (60, 200)}


def parse_stage_log(path: str) -> dict:
    """A stage's summary line and the distribution of its per-iteration
    time over blocks of about 100 iterations, from the log's own time
    stamps (with K steps a dispatch K lines are written at once, so block
    averages are the stable measure)."""
    out: dict = {}
    ts = []
    with open(path) as f:
        for line in f:
            m = STAGE_RE.search(line)
            if m:
                out = {k: (v if k == "stage" else float(v))
                       for k, v in m.groupdict().items()}
            m2 = ITER_RE.match(line)
            if m2:
                h, mi, s = m2.group(1).split(":")
                it = int(m2.group(3)) if m2.group(3) else len(ts) + 1
                ts.append((it, int(h) * 3600 + int(mi) * 60 + int(s)
                           + int(m2.group(2)) / 1000.0))
    ts = ts[::100] + ts[-1:] if len(ts) > 100 else ts
    blocks = []
    for (i0, t0), (i1, t1) in zip(ts, ts[1:]):
        if t1 < t0:          # %H:%M:%S wraps at midnight
            t1 += 86400.0
        if i1 > i0:
            blocks.append((t1 - t0) / (i1 - i0))
    dist = {}
    if blocks:
        a = np.asarray(blocks)
        dist = {"blocks": len(blocks),
                "s_per_iter_p10": float(np.percentile(a, 10)),
                "s_per_iter_p50": float(np.percentile(a, 50)),
                "s_per_iter_p90": float(np.percentile(a, 90)),
                "s_per_iter_max": float(a.max())}
    out["block_time_distribution"] = dist
    return out


def make_data(variant: str, sizes: dict = None, seed: int = 0):
    """(train dataset, validation cases) of ``variant`` in memory, at
    :data:`DATA`'s sizes unless ``sizes`` overrides them."""
    from bcp_tpu_torch.data.datasets import (PancreasList, SliceList,
                                             VolumeList)
    from bcp_tpu_torch.data.synthetic import (acdc_cases, la_cases,
                                              pancreas_cases)
    d = dict(DATA[variant], **(sizes or {}))
    if variant == "la":
        cases = la_cases(d["n_train"] + d["n_val"], d["shape"], seed=seed)
        return VolumeList(cases[:d["n_train"]]), cases[d["n_train"]:]
    if variant == "acdc":
        slices, vols = acdc_cases(d["n_slices"], (d["shape"],), d["n_val"],
                                  (d["depth"], *d["shape"]), seed=seed)
        return SliceList(slices), vols
    lab, unlab, test = pancreas_cases(d["n_lab"], d["n_unlab"], d["n_test"],
                                      (d["shape"],), seed=seed)
    return (PancreasList(lab), PancreasList(unlab, "train_unlab")), test


def cli_args(variant: str, pre: int, self_: int, k: int, snap: str,
             device: str):
    """(CLI module, its parsed flags) of the run: the CLI's defaults but
    the schedule, the labelled split, K, the snapshot root and the
    device."""
    if variant == "la":
        from bcp_tpu_torch.cli import train_la as cli
        flags = ["--labelnum", str(DATA["la"]["labelnum"]),
                 "--max_samples", str(DATA["la"]["n_train"]),
                 "--pre_max_iteration", str(pre),
                 "--self_max_iteration", str(self_)]
    elif variant == "acdc":
        from bcp_tpu_torch.cli import train_acdc as cli
        flags = ["--labelnum", str(DATA["acdc"]["labelnum"]),
                 "--pre_iterations", str(pre), "--max_iterations",
                 str(self_)]
    else:
        from bcp_tpu_torch.cli import train_pancreas as cli
        flags = ["--pretraining_epochs", str(pre),
                 "--self_training_epochs", str(self_)]
    return cli, cli.build_parser().parse_args(
        flags + ["--steps_per_dispatch", str(k), "--snapshot_root", snap,
                 "--device", device])


def norm_biases(model) -> list:
    """The names of the conv biases that an instance norm follows: the
    pancreas V-Net's 29 (every conv of a block but the head)."""
    from torch import nn
    from bcp_tpu_torch.models.layers import InstanceNorm
    names = []
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Sequential):
            continue
        kids = list(mod.named_children())
        for (i, a), (_, b) in zip(kids, kids[1:]):
            if isinstance(b, InstanceNorm) and getattr(a, "bias", None) \
                    is not None:
                names.append(f"{name}.{i}.bias")
    return names


def bias_drift(trainer) -> dict:
    """The largest |bias| of the conv biases an instance norm follows: at
    the seeded start of the pre-train stage and in each stage's last
    checkpoint (``last.pth``, the state of its last validation or its
    end)."""
    from bcp_tpu_torch.convert import load_checkpoint
    from bcp_tpu_torch.train.state import build_model
    model = build_model(trainer.cfg, "train", "cpu")
    names = norm_biases(model)
    start = model.state_dict()
    out = {"biases": len(names),
           "start_max_abs": max(float(start[n].abs().max()) for n in names)}
    for stage, d in (("pre_train", trainer.pre_dir),
                     ("self_train", trainer.self_dir)):
        sd = load_checkpoint(os.path.join(d, "last.pth"),
                             trainer.cfg.net_type)
        out[f"{stage}_last_max_abs"] = max(float(sd[n].abs().max())
                                           for n in names)
        out[f"{stage}_last_max_abs_moved"] = max(
            float((sd[n] - start[n]).abs().max()) for n in names)
    return out


def card(device: str) -> dict:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    if not device.startswith("cuda"):
        return {"platform": "cpu"}
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "nvidia_smi": smi[0]}


def run(variant: str, pre: int, self_: int, k: int, snap: str,
        device: str = "cuda", sizes: dict = None, **overrides) -> dict:
    """One run of ``variant``'s train CLI core; returns the record that
    :func:`main` writes. ``sizes`` and ``overrides`` (config fields) shrink
    a run for a test."""
    import torch
    if os.path.isdir(snap) and os.listdir(snap):
        raise SystemExit(f"error: the snapshot root {snap} is not empty: a "
                         f"run starts from a fresh one")
    cli, args = cli_args(variant, pre, self_, k, snap, device)
    t0 = time.time()
    train_dataset, val_cases = make_data(variant, sizes)
    data_s = time.time() - t0
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    trainer, stages = cli.train(args, train_dataset=train_dataset,
                                val_cases=val_cases, **overrides)
    wall = time.time() - t0
    cfg = trainer.cfg
    logs = {"pre_train": trainer.pre_dir, "self_train": trainer.self_dir}
    parsed = {}
    for stage, d in logs.items():
        parsed[stage] = parse_stage_log(os.path.join(d, "log.txt"))
        if "steps" not in parsed[stage]:
            raise RuntimeError(f"no 'stage ... done:' line in {d}/log.txt")
    unit = "epochs" if variant == "pancreas" else "iterations"
    full = SCHEDULE[variant]
    out = {
        "variant": variant,
        "schedule": {"pre": pre, "self": self_, "unit": unit,
                     "iterations": [cfg.pre_iterations,
                                    cfg.self_iterations],
                     "eval_every": cfg.eval_every,
                     "full_schedule": list(full),
                     "cut": (pre, self_) != full},
        "data": dict(DATA[variant], **(sizes or {})),
        "data_setup_s": data_s,
        "steps_per_dispatch": cfg.steps_per_dispatch,
        "net_type": cfg.net_type, "compute_dtype": cfg.compute_dtype,
        "device_data_cache": cfg.device_data_cache,
        "async_val": cfg.async_val,
        "device": card(device),
        "total_wall_s": wall,
        "stages": parsed,
        "best_dice": {s: d for s, (d, _) in stages.items()},
        "validations": trainer.validations,
        "graph_counts": trainer.graph_counts,
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if device.startswith("cuda") else None),
        "command": " ".join(sys.argv),
    }
    if variant == "pancreas":
        out["instance_norm_biases"] = bias_drift(trainer)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=sorted(DATA), required=True)
    ap.add_argument("--pre", type=int, default=None,
                    help="pre-train iterations (pancreas: epochs); default "
                         "the reference's")
    ap.add_argument("--self", dest="self_", type=int, default=None,
                    help="self-train iterations (pancreas: epochs)")
    ap.add_argument("--k", type=int, default=10,
                    help="steps_per_dispatch (must divide the validation "
                         "cadence and both stages' iterations)")
    ap.add_argument("--out", default=None,
                    help="the JSON written (default RUN_TORCH_<VARIANT>"
                         ".json in the repository)")
    ap.add_argument("--snap", default=None,
                    help="snapshot root (default _work/run_full_torch/"
                         "<variant> in the repository)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    v = args.variant
    pre = SCHEDULE[v][0] if args.pre is None else args.pre
    self_ = SCHEDULE[v][1] if args.self_ is None else args.self_
    out = args.out or os.path.join(REPO, f"RUN_TORCH_{v.upper()}.json")
    snap = args.snap or os.path.join(REPO, "_work", "run_full_torch", v)
    record = run(v, pre, self_, args.k, snap, args.device)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
