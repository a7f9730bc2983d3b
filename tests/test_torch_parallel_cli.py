"""``--num_devices`` and ``--remat`` on the port's six CLIs, on the CPU at a
tiny size (n_filters 4, 16^3 or 32x32 patches).

- ``train_la --num_devices 2 --device cpu`` spawns its two gloo ranks
  itself and runs both stages: only rank 0 writes (one ``log.txt`` with
  the mesh line, the checkpoints and ``last_state.pt``), every checkpoint
  loads strictly, and the stages hand off.
- In one more world of two ranks the other five CLIs run with
  ``--num_devices 2``: ``test_la`` from the two-rank best file,
  ``train_acdc`` then ``test_acdc``, ``train_pancreas`` then
  ``test_pancreas``. Each test CLI's metrics equal its ``--num_devices 1``
  run's, as ``tests/test_parallel.py::test_eval_cli_sharded_matches_single``
  holds the JAX CLI's.
- ``--sp_devices 2`` reaches the config of every train CLI, and
  ``--sp_devices 3 --num_devices 2`` is refused (S must divide N); the
  test CLIs have no ``--sp_devices``, as the JAX package's; more cards
  than are visible are refused, nothing runs on fewer; ``--remat 1``
  reaches the train model of ``train_la`` and ``train_pancreas`` only."""

import os

import numpy as np
import pytest
import torch

from bcp_tpu_torch.cli import (test_acdc, test_la, test_pancreas, train_acdc,
                               train_la, train_pancreas)
from bcp_tpu_torch.data import feed
from bcp_tpu_torch.data.datasets import PancreasList, VolumeList
from bcp_tpu_torch.data.synthetic import acdc_cases, la_cases, pancreas_cases
from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.models.vnet3d import ConvBlock
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train.checkpoints import STATE_FILE
from bcp_tpu_torch.train.state import build_model

import torch_parallel_ranks as ranks
import torch_port_helpers  # noqa: F401  (one torch thread a process)

TINY = dict(patch_size=(16, 16, 16), n_filters=4, eval_every=2,
            eval_batch=2, compute_dtype="float32")


def _la_args(root, *extra):
    return train_la.build_parser().parse_args(
        ["--labelnum", "4", "--pre_max_iteration", "2",
         "--self_max_iteration", "2", "--snapshot_root", str(root),
         "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def la_two(tmp_path_factory):
    """train_la with --num_devices 2: the CLI spawns the ranks."""
    root = tmp_path_factory.mktemp("la_two")
    trainer, out = train_la.train(
        _la_args(root, "--num_devices", "2"),
        train_dataset=VolumeList(la_cases(8, (20, 20, 18), seed=11)),
        val_cases=la_cases(1, (24, 22, 20), seed=12), **TINY)
    return root, trainer, out


def test_train_la_on_two_ranks_writes_once_and_hands_off(la_two):
    root, trainer, out = la_two
    assert trainer is None and set(out) == {"pre", "self"}
    run = root / "LA_BCP_4_labeled"
    for stage, (dice, path) in out.items():
        d = run / f"{stage}_train"
        assert 0.0 <= dice <= 1.0
        assert path == str(d / "VNet_best_model.pth")
        names = set(os.listdir(d))
        assert {"log.txt", "VNet_best_model.pth", "last.pth",
                STATE_FILE} <= names
        assert not [n for n in names if n.endswith(".tmp")]
        # log/ is rank 0's metric writer
        assert all(n in ("log", "log.txt", "VNet_best_model.pth",
                         "last.pth", STATE_FILE) or n.startswith("iter_")
                   for n in names), names
        model = create_model("VNet", 2, device="cpu", n_filters=4)
        model.load_state_dict(torch.load(path), strict=True)
        assert torch.load(d / STATE_FILE)["step"] == 2
        log = (d / "log.txt").read_text()
        # one writer: the config line once, the mesh line once
        assert log.count("config: ") == 1
        assert log.count("mesh over 2 devices: data=2 space=1 (global "
                         "batch 16)") == 1
    log = (run / "self_train" / "log.txt").read_text()
    assert f"loaded from {out['pre'][1]}" in log


@pytest.fixture(scope="module")
def world_clis(tmp_path_factory):
    """The other five CLIs with --num_devices 2 in one world of two;
    test_la from a seeded V-Net, whose labels are not empty."""
    root = tmp_path_factory.mktemp("clis_two")
    torch.manual_seed(0)
    pth = str(root / "VNet_seeded.pth")
    torch.save(create_model("VNet", 2, device="cpu",
                            n_filters=4).state_dict(), pth)
    la_test = la_cases(2, (26, 24, 20), seed=13)
    acdc = acdc_cases(16, ((40, 36), (36, 44), (30, 30)), 2, (3, 40, 36),
                      seed=1)
    panc = pancreas_cases(2, 4, 2, ((20, 18, 22),), seed=3)
    got = mesh.launch(ranks.cli_runs, 2, "cpu", str(root), pth, la_test,
                      acdc, panc)
    return root, pth, la_test, acdc, panc, got


def test_test_la_two_ranks_equal_one(world_clis):
    root, pth, la_test, _, _, got = world_clis
    args = test_la.build_parser().parse_args(
        ranks.la_test_flags(str(root), pth) + ["--device", "cpu"])
    want = test_la.test_calculate_metric(args, dataset=VolumeList(la_test))
    assert np.isfinite(want).all() and want[0] > 0
    np.testing.assert_allclose(got["test_la"], want, rtol=1e-6, atol=1e-8)


def test_acdc_clis_on_two_ranks(world_clis, monkeypatch):
    """train_acdc's best file loads strictly; test_acdc's per-class
    metrics from it equal the one-rank run's."""
    root, _, _, (_, vols), _, got = world_clis
    monkeypatch.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    for stage in ("pre", "self"):
        _, path = got["train_acdc"][stage]
        blob = torch.load(path)
        model = create_model("unet", 4, device="cpu", n_filters=4)
        model.load_state_dict(blob["net"], strict=True)
    args = test_acdc.build_parser().parse_args(
        ranks.acdc_test_flags(str(root / "acdc"),
                              got["train_acdc"]["self"][1])
        + ["--device", "cpu"])
    want = test_acdc.test_calculate_metric(args, dataset=VolumeList(vols))
    assert want[:, 0].max() > 0
    np.testing.assert_allclose(got["test_acdc"], want, rtol=1e-6, atol=1e-8)


def test_pancreas_clis_on_two_ranks(world_clis, monkeypatch):
    root, _, _, _, (_, _, test), got = world_clis
    for stage in ("pre", "self"):
        model = create_model("VNet_pancreas", 2, device="cpu", n_filters=4)
        model.load_state_dict(torch.load(got["train_pancreas"][stage][1])[
            "net"], strict=True)
    monkeypatch.setattr(test_pancreas, "pancreas_config",
                        ranks._tiny_pancreas(test_pancreas.pancreas_config,
                                             (16, 16, 16)))
    args = test_pancreas.build_parser().parse_args(
        ["--torch_ckpt", got["train_pancreas"]["self"][1],
         "--snapshot_root", str(root / "pancreas"), "--device", "cpu"])
    want = test_pancreas.test_calculate_metric(args,
                                               dataset=VolumeList(test))
    assert want[0] > 0
    np.testing.assert_allclose(got["test_pancreas"], want, rtol=1e-6,
                               atol=1e-8)


def _pancreas_lists():
    lab, unlab, _ = pancreas_cases(2, 4, 0, ((20, 18, 22),), seed=3)
    return PancreasList(lab), PancreasList(unlab, "train_unlab")


PARSERS = {"train_la": train_la, "train_acdc": train_acdc,
           "train_pancreas": train_pancreas, "test_la": test_la,
           "test_acdc": test_acdc, "test_pancreas": test_pancreas}


@pytest.mark.parametrize("cli", sorted(PARSERS))
def test_every_cli_refuses_spatial_partitioning_and_missing_cards(cli,
                                                                  tmp_path):
    """``--sp_devices`` where the CLI has it (the train CLIs, as in the JAX
    package): 2 of two ranks reaches the config, 3 of two is refused; and
    more cards than are visible: SystemExit before anything runs."""
    mod = PARSERS[cli]
    base = ["--snapshot_root", str(tmp_path)]
    parser = mod.build_parser()
    has_sp = any(a.dest == "sp_devices" for a in parser._actions)
    assert has_sp == cli.startswith("train")
    if has_sp:
        args = parser.parse_args(base + ["--sp_devices", "2", "--num_devices",
                                         "2", "--device", "cpu"])
        assert args.sp_devices == 2
        assert mod.config_from_args(args, **(
            {"train_dataset": _pancreas_lists()} if cli == "train_pancreas"
            else {})).sp_devices == 2
        args = parser.parse_args(base + ["--sp_devices", "3", "--num_devices",
                                         "2", "--device", "cpu"])
        with pytest.raises(SystemExit, match="sp_devices=3 must divide the "
                                             "mesh size 2"):
            mod.train(args)
    n = torch.cuda.device_count() + 2
    args = parser.parse_args(base + ["--num_devices", str(n), "--device",
                                     "cuda"])
    with pytest.raises(SystemExit, match=f"num_devices={n} but only"):
        (mod.train if cli.startswith("train") else
         mod.test_calculate_metric)(args)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("cli", ["train_la", "train_pancreas"])
def test_remat_flag_reaches_the_train_model_only(cli, tmp_path):
    mod = PARSERS[cli]
    args = mod.build_parser().parse_args(
        ["--snapshot_root", str(tmp_path), "--device", "cpu", "--remat",
         "1"])
    lists = _pancreas_lists() if cli == "train_pancreas" else None
    trainer = mod.build_trainer(args, train_dataset=lists, val_cases=[],
                                **TINY)
    assert trainer.cfg.remat
    train_model = build_model(trainer.cfg, "train", "cpu")
    blocks = [m for m in train_model.modules() if isinstance(m, ConvBlock)]
    assert blocks and all(m.remat for m in blocks)
    assert not any(getattr(m, "remat", False)
                   for m in trainer.eval_model.modules())
