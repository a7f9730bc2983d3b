"""Zoo nets through the train CLIs' cores on the CPU: ``train_acdc --model
unet_2d_bcp`` (a bare-tensor net, the tuple rule) and ``train_la --model
unet_3D`` (one-group BatchNorm, channel dropout), both stages with
validations, at ``ZOO``'s small widths (the factory's ``create_model``
wrapped to them); each at ``--steps_per_dispatch 2`` ends every stage in
the state of the K = 1 run, bit for bit (student, teacher, momentum
buffers, step), with the same losses logged and the same step hook
calls."""

import numpy as np
import pytest
import torch

from bcp_tpu_torch.cli import train_acdc, train_la
from bcp_tpu_torch.cli.common import run_stages
from bcp_tpu_torch.convert import load_checkpoint
from bcp_tpu_torch.data import feed
from bcp_tpu_torch.data.datasets import SliceList, VolumeList
from bcp_tpu_torch.data.synthetic import acdc_cases, la_cases
from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.train import state as port_state
from bcp_tpu_torch.train.checkpoints import STATE_FILE
from torch_port_helpers import ZOO

#: (CLI, net type, its small widths, run directory, config overrides)
RUNS = {
    "unet_2d_bcp": (train_acdc, ZOO["unet_2d_bcp"][0], "ACDC_BCP_1_labeled",
                    dict(patch_size=(32, 32), eval_every=2,
                         compute_dtype="float32")),
    "unet_3D": (train_la, ZOO["unet_3D_narrow"][0], "LA_BCP_4_labeled",
                dict(patch_size=(16, 16, 16), eval_every=2,
                     compute_dtype="float32")),
}


def _data(net):
    if net == "unet_2d_bcp":
        slices, vols = acdc_cases(16, ((40, 36), (36, 44), (30, 30)), 2,
                                  (3, 40, 36), seed=1)
        return SliceList(slices), vols
    return (VolumeList(la_cases(8, (20, 20, 18), seed=11)),
            la_cases(1, (24, 22, 20), seed=12))


def _train(net, root, K):
    cli, _, _, over = RUNS[net]
    if cli is train_acdc:
        flags = ["--labelnum", "1", "--pre_iterations", "4",
                 "--max_iterations", "4", "--batch_size", "8",
                 "--labeled_bs", "4"]
    else:
        flags = ["--labelnum", "4", "--pre_max_iteration", "4",
                 "--self_max_iteration", "4"]
    args = cli.build_parser().parse_args(
        flags + ["--model", net, "--snapshot_root", str(root), "--device",
                 "cpu", "--steps_per_dispatch", str(K)])
    train, val = _data(net)
    trainer = cli.build_trainer(args, train_dataset=train, val_cases=val,
                                **over)
    logged, steps = [], []
    trainer.on_metrics = lambda *a: logged.append(a)
    trainer.on_step = lambda *a: steps.append(a)
    out = run_stages(trainer, args)
    return trainer, out, logged, steps


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    make = port_state.create_model
    net = request.param
    mp.setattr(port_state, "create_model", lambda t, *a, **k: make(
        t, *a, **({**RUNS[t][1], **k} if t in RUNS else k)))
    mp.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    root = tmp_path_factory.mktemp(net)
    try:
        out = {K: _train(net, root / f"k{K}", K) for K in (1, 2)}
    finally:
        mp.undo()
    return net, root, out


def test_zoo_net_trains_both_stages(runs):
    """Finite losses every step, a validation's best checkpoint a stage
    that loads strictly into the net, the self stage started from the
    pre-train best."""
    net, root, out = runs
    trainer, stages, logged, steps = out[1]
    assert trainer.cfg.net_type == net
    assert steps == [(s, i) for s in ("pre", "self") for i in range(1, 5)]
    assert [(s, i) for s, i, _ in logged] == steps
    assert all(np.isfinite(v) for *_, m in logged for v in m.values())
    for stage, (dice, path) in stages.items():
        assert 0.0 <= dice <= 1.0
        model = create_model(net, trainer.cfg.num_classes, device="cpu",
                             **RUNS[net][1])
        model.load_state_dict(load_checkpoint(path, net), strict=True)


def test_zoo_net_k2_equals_k1(runs):
    net, root, out = runs
    assert out[2][0].cfg.steps_per_dispatch == 2
    assert out[2][0].graph_counts == {
        "pre": {"captures": 0, "replays": 0},
        "self": {"captures": 0, "replays": 0}}
    assert out[1][2] == out[2][2] and len(out[1][2]) == 8
    assert out[1][3] == out[2][3]
    run_dir = RUNS[net][2]
    for stage in ("pre_train", "self_train"):
        want = torch.load(root / "k1" / run_dir / stage / STATE_FILE,
                          weights_only=False)
        got = torch.load(root / "k2" / run_dir / stage / STATE_FILE,
                         weights_only=False)
        assert got["step"] == want["step"] == 4
        for part in ("model", "teacher"):
            for k, v in want[part].items():
                assert torch.equal(got[part][k], v), (stage, part, k)
        for i, st in want["optimizer"]["state"].items():
            assert torch.equal(got["optimizer"]["state"][i][
                "momentum_buffer"], st["momentum_buffer"]), (stage, i)
