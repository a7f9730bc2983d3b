"""Shared pieces of the benchmark's CPU tests: a cell run through its
driver at a tiny size on the port's plain CPU path (the harness's look
for a card skipped), and the sizes that make it tiny."""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

torch.set_num_threads(2)

#: a tiny V-Net cell: 32^3 patches (the bottom level 2^3), n_filters 4,
#: f32, ten volumes
SHRINK = {
    "train": {"patch_size": [32, 32, 32], "widths": {"n_filters": 4},
              "compute_dtype": "float32",
              "program_config": {"n_filters": 4},
              "data": {"volume_shape": [40, 36, 34], "train_volumes": 10,
                       "labelled": 4, "validation_volumes": 1}},
    "infer": {"patch_size": [32, 32, 32], "widths": {"n_filters": 4},
              "data": {"volume_shape": [40, 36, 34], "test_volumes": 4},
              "eval": {"eval_batch": 4},
              "test_flags": ["--n_filters", "4"]},
}

#: warm-up and traced groups or volumes of a dry run
FEWER = {"warm_groups": 2, "trace_groups": 1, "warm_volumes": 1,
         "trace_volumes": 1}

SEED = 2**31 + 11

#: a V-Net train cell for the CPU dry runs, defined here and not in the
#: benchmark: the benchmark's train cell is the UNet3D's, whose widths the
#: port's config cannot shrink to a CPU size; its limits sit above the
#: dry size's clean readings and below its faults'
VNET_TRAIN = {"name": "vnet_la.self_k4", "config": "vnet_la",
              "driver": "train", "traffic": "self_k4",
              "steps_per_dispatch": 4, "warm_groups": 3, "trace_groups": 2,
              "stage_iterations": 2496, "checked_steps": 3,
              "limits": {"loss_gap": 0.003, "change_gap": 0.3,
                         "replay_loss_gap": 0.01}}


def root_with_vnet_train(tmp) -> str:
    """A copy of the benchmark under ``tmp`` with :data:`VNET_TRAIN` added
    as files and entries alone."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    work = {k: v for k, v in VNET_TRAIN.items() if k != "name"}
    with open(os.path.join(root, "benchmark", "workloads",
                           VNET_TRAIN["name"] + ".json"), "w") as f:
        json.dump(work, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    name = VNET_TRAIN["name"]
    spec["workloads"].append({"name": name, "config": "vnet_la",
                              "traffic": "self_k4", "chips": 1,
                              "why": "a dry-run cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "unet3d_la.self_k4" in m.get("workloads", []):
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def dry_run(name: str, trace: bool = False, root: str = ROOT,
            seconds: float = 1.0, seed: int = SEED):
    """(cell, result line) of one run of cell ``name`` on the CPU at the
    driver's tiny size."""
    cell = harness.Registry(root).cell(name)
    shrink = SHRINK[cell.workload["driver"]]
    # fewer groups and volumes around the window than on the card
    cell.workload.update({k: v for k, v in FEWER.items()
                          if k in cell.workload})
    out = cell.driver.run(cell, seed, seconds, trace, "cpu",
                          time.perf_counter(), shrink)
    return cell, harness.result_line(cell, out, trace)
