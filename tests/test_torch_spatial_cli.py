"""``train_la --num_devices 2 --sp_devices 2 --device cpu`` on the CPU: the
CLI spawns its two gloo ranks itself, lays them out as one data index by
two space indices and trains both stages (two iterations each, n_filters
4, 16^3 patches) with each volume's x extent split over the ranks,
validating with the split off: rank 0's files, the JAX trainer's mesh line,
strict loads and the hand-off between the stages. And the trainer's image
snapshots under the split, against one process's."""

import os

import numpy as np

import torch

from bcp_tpu_torch.cli import train_la
from bcp_tpu_torch.data.datasets import VolumeList
from bcp_tpu_torch.data.synthetic import la_cases
from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train.checkpoints import STATE_FILE

import torch_spatial_ranks as sr
import torch_port_helpers  # noqa: F401  (one torch thread a process)


def test_train_la_on_two_ranks_splitting_each_volume(tmp_path):
    args = train_la.build_parser().parse_args(
        ["--labelnum", "4", "--pre_max_iteration", "2",
         "--self_max_iteration", "2", "--snapshot_root", str(tmp_path),
         "--device", "cpu", "--num_devices", "2", "--sp_devices", "2"])
    assert train_la.config_from_args(args).sp_devices == 2
    trainer, out = train_la.train(
        args, train_dataset=VolumeList(la_cases(8, (20, 20, 18), seed=11)),
        val_cases=la_cases(1, (24, 22, 20), seed=12),
        patch_size=(16, 16, 16), n_filters=4, eval_every=2, eval_batch=2,
        compute_dtype="float32")
    assert trainer is None and set(out) == {"pre", "self"}
    run = tmp_path / "LA_BCP_4_labeled"
    for stage, (dice, path) in out.items():
        d = run / f"{stage}_train"
        assert 0.0 <= dice <= 1.0
        assert path == str(d / "VNet_best_model.pth")
        model = create_model("VNet", 2, device="cpu", n_filters=4)
        model.load_state_dict(torch.load(path), strict=True)
        assert torch.load(d / STATE_FILE)["step"] == 2
        log = (d / "log.txt").read_text()
        assert log.count("config: ") == 1
        assert log.count("mesh over 2 devices: data=1 space=2 (global "
                         "batch 8)") == 1
        assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    log = (run / "self_train" / "log.txt").read_text()
    assert f"loaded from {out['pre'][1]}" in log


def test_image_snapshots_under_a_split_are_the_whole_volumes(tmp_path):
    """``log_images`` at N = S = 2: every rank gathers its rows' whole
    volumes for a due iteration and rank 0 makes LA's panels with the
    split off. From the seeded state (no pre-train iteration: the stage
    hands on its start), self-train iteration 1's panels equal one
    process's on the same batch bit for bit: the mixed images, the
    targets with the teacher's gathered pseudo-labels, the pre-update
    student's probabilities."""
    train = la_cases(8, (20, 20, 18), seed=11)
    val = la_cases(1, (24, 22, 20), seed=12)
    got = mesh.launch(sr.run_tasks, 2, "cpu", {"snap": (
        "snapshot_panels", 2, (str(tmp_path / "two"), train, val, 2))})
    got = got["snap"][0]
    want = sr.snapshot_panels(str(tmp_path / "one"), train, val, 1)
    assert [(s, i) for s, i, _ in got] == [(s, i) for s, i, _ in want] \
        == [("self", 1)]
    for k, v in want[0][2].items():
        np.testing.assert_array_equal(got[0][2][k], v, err_msg=k)
