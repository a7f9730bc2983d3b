"""The ``train_padded`` driver: its reference feed pads volumes shorter
than the patch as the port's feed does (``RandomCrop``'s rule), so its
batches equal the trainer's, and a cell on such volumes runs through it
at a tiny size on the CPU and passes its check."""

from __future__ import annotations

import json
import os
import time

import numpy as np

from bench_helpers import ROOT, SEED, SHRINK, VNET_TRAIN, \
    root_with_vnet_train
from benchmark import data, harness

from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.data.datasets import VolumeList
from bcp_tpu_torch.data.feed import BCPBatchFeeder

PATCH = (32, 32, 32)
#: the last axis shorter than the patch, the first two longer
SHORT = (40, 36, 26)

padded_driver = harness.load_module(
    os.path.join(ROOT, "benchmark", "traffic", "train_padded.py"),
    "bench_traffic_train_padded")


def test_padding_rule():
    img = np.ones((40, 36, 26), np.float32)
    lab = np.ones((40, 36, 26), np.uint8)
    (pi, pl), = padded_driver.padded([(img, lab)], PATCH)
    # (32 - 40) // 2 + 3 < 0, (32 - 36) // 2 + 3 = 1, (32 - 26) // 2 + 3 = 6
    assert pi.shape == pl.shape == (40, 38, 38)
    assert pi[:, 1:-1, 6:-6].all() and pi.sum() == img.sum()
    long = np.ones((40, 36, 34), np.float32)
    (same, _), = padded_driver.padded([(long, long)], PATCH)
    assert same is long


def test_feed_matches_the_trainers_on_short_volumes():
    vols = data.blob_volumes(SEED, 0, 10, SHORT, "cpu")
    cfg = la_config(labelnum=4).replace(
        patch_size=PATCH, n_filters=4, compute_dtype="float32",
        max_samples=10, seed=SEED, device_data_cache=True)
    feeder = BCPBatchFeeder(cfg, "self", VolumeList(vols), "cpu")
    feed = padded_driver.PaddedFeed(vols, 4, 8, 4, PATCH, SEED)
    for _ in range(3):
        got, want = next(feeder), feed.next()
        for k, v in want.items():
            assert v.shape[-3:] == PATCH
            np.testing.assert_array_equal(got[k].numpy(), v.astype(
                got[k].numpy().dtype))


def test_dry_run_on_short_volumes(tmp_path):
    root = root_with_vnet_train(tmp_path)
    path = os.path.join(root, "benchmark", "workloads",
                        VNET_TRAIN["name"] + ".json")
    with open(path) as f:
        work = json.load(f)
    work.update(driver="train_padded", warm_groups=2, trace_groups=1)
    with open(path, "w") as f:
        json.dump(work, f)
    cell = harness.Registry(root).cell(VNET_TRAIN["name"])
    assert cell.driver.__name__ == "bench_traffic_train_padded"
    shrink = dict(SHRINK["train"], data=dict(SHRINK["train"]["data"],
                                             volume_shape=list(SHORT)))
    out = cell.driver.run(cell, SEED, 1.0, False, "cpu",
                          time.perf_counter(), shrink)
    line = harness.result_line(cell, out, False)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
