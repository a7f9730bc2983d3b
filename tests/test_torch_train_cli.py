"""The port's train_la CLI core on the CPU at a tiny size: both stages run
through the trainer with the CLI's defaults (device store, background
validation), call its per-iteration hook, hand off through the pre-train
stage's best .pth and write reference-layout checkpoints that load
strictly into the eval model, also in groups of ``--steps_per_dispatch``;
the ported flags reach the config, and what the CLI cannot run is refused
before anything runs."""

import os
import re

import numpy as np
import pytest
import torch

from bcp_tpu.cli import train_la as jax_train_la
from bcp_tpu_torch.cli import train_la
from bcp_tpu_torch.data.datasets import VolumeList
from bcp_tpu_torch.data.synthetic import la_cases
from bcp_tpu_torch.models import create_model

TINY = dict(patch_size=(16, 16, 16), n_filters=4, eval_every=2,
            compute_dtype="float32")


def _args(tmp_path, *extra):
    return train_la.build_parser().parse_args(
        ["--labelnum", "4", "--pre_max_iteration", "2",
         "--self_max_iteration", "2", "--snapshot_root", str(tmp_path),
         "--device", "cpu", *extra])


def test_two_stages_hand_off_and_write_strict_checkpoints(tmp_path):
    train = VolumeList(la_cases(8, (20, 20, 18), seed=11))
    val = la_cases(1, (24, 22, 20), seed=12)
    calls = []
    trainer, out = train_la.train(_args(tmp_path), train_dataset=train,
                                  val_cases=val,
                                  on_step=lambda *a: calls.append(a), **TINY)
    assert set(out) == {"pre", "self"}
    assert calls == [("pre", 1), ("pre", 2), ("self", 1), ("self", 2)]
    # one validation per stage at eval_every, and another at the end of a
    # stage whose validations never beat a dice of 0 (`trainer.py:570`)
    assert trainer.validations >= 2
    run = tmp_path / "LA_BCP_4_labeled"
    for stage, (dice, path) in out.items():
        assert 0.0 <= dice <= 1.0
        assert path == str(run / f"{stage}_train" / "VNet_best_model.pth")
        assert os.path.exists(run / f"{stage}_train" / "last.pth")
        assert os.path.exists(run / f"{stage}_train" / "last_state.pt")
        model = create_model("VNet", 2, device="cpu", n_filters=4)
        model.load_state_dict(torch.load(path), strict=True)
    log = (run / "self_train" / "log.txt").read_text()
    assert f"loaded from {out['pre'][1]}" in log
    losses = [float(v) for v in re.findall(r"loss: (\S+)", log)]
    assert len(losses) == 2 and np.isfinite(losses).all()


#: more cards than this host has
TOO_MANY = str(torch.cuda.device_count() + 2)


@pytest.mark.parametrize("flag,item", [
    (["--num_devices", TOO_MANY, "--device", "cuda"], "multi-GPU"),
    (["--sp_devices", "2"], "multi-GPU"), (["--remat", "1"], "remat")])
def test_refuses_what_the_port_lacks(tmp_path, flag, item):
    """``--num_devices`` runs on that many cards
    (``tests/test_torch_parallel_cli.py``) and is refused when fewer are
    visible: it never runs on fewer. ``--sp_devices 2`` with two ranks
    reaches the config (``tests/test_torch_spatial_cli.py`` runs it), and
    ``--sp_devices 3 --num_devices 2`` is refused: S must divide N.
    ``--remat 1`` reaches the config."""
    if item == "remat":
        assert train_la.config_from_args(_args(tmp_path, *flag)).remat
        return
    if flag[0] == "--sp_devices":
        cfg = train_la.config_from_args(
            _args(tmp_path, *flag, "--num_devices", "2"))
        assert (cfg.sp_devices, cfg.num_devices) == (2, 2)
        with pytest.raises(SystemExit, match="error: --sp_devices: "
                                             "sp_devices=3 must divide"):
            train_la.train(_args(tmp_path, "--sp_devices", "3",
                                 "--num_devices", "2"))
        assert not os.listdir(tmp_path)
        return
    with pytest.raises(SystemExit, match=f"error: .*ROADMAP.*{item}"):
        train_la.train(_args(tmp_path, *flag))


def test_steps_per_dispatch_two_runs_both_stages(tmp_path):
    """``--steps_per_dispatch 2`` reaches the config and runs both stages
    in groups of two (K eager steps a group on the CPU): the hook sees
    every iteration, every step logs a finite loss and the checkpoints
    load strictly."""
    calls = []
    trainer, out = train_la.train(
        _args(tmp_path, "--steps_per_dispatch", "2"),
        train_dataset=VolumeList(la_cases(8, (20, 20, 18), seed=11)),
        val_cases=la_cases(1, (24, 22, 20), seed=12),
        on_step=lambda *a: calls.append(a), **TINY)
    assert trainer.cfg.steps_per_dispatch == 2
    assert calls == [("pre", 1), ("pre", 2), ("self", 1), ("self", 2)]
    run = tmp_path / "LA_BCP_4_labeled"
    for stage, (dice, path) in out.items():
        model = create_model("VNet", 2, device="cpu", n_filters=4)
        model.load_state_dict(torch.load(path), strict=True)
        assert torch.load(run / f"{stage}_train" / "last_state.pt")[
            "step"] == 2
        log = (run / f"{stage}_train" / "log.txt").read_text()
        losses = [float(v) for v in re.findall(r"loss: (\S+)", log)]
        assert len(losses) == 2 and np.isfinite(losses).all()


@pytest.mark.parametrize("flag,field,want", [
    ([], "device_data_cache", True), (["--device_data_cache", "0"],
                                      "device_data_cache", False),
    ([], "async_val", True), ([], "async_val_depth", 2),
    ([], "fused_bwd", False), (["--fused_bwd", "1"], "fused_bwd", True)])
def test_ported_flags_reach_the_config(tmp_path, flag, field, want):
    """The JAX CLI's defaults: device store and background validation on;
    the fused backward off unless asked for."""
    args = _args(tmp_path, *flag)
    train_la.ranks(args)
    assert getattr(train_la.config_from_args(args), field) is want \
        or getattr(train_la.config_from_args(args), field) == want


def test_fused_bwd_flag_reaches_the_train_model_only(tmp_path):
    trainer = train_la.build_trainer(
        _args(tmp_path, "--fused_bwd", "1"),
        train_dataset=VolumeList(la_cases(8, (20, 20, 18), seed=11)),
        val_cases=[], **TINY)
    from bcp_tpu_torch.models.layers import Conv3x3x3
    from bcp_tpu_torch.train.state import build_model
    train_model = build_model(trainer.cfg, "train", "cpu")
    convs = [m for m in train_model.modules() if isinstance(m, Conv3x3x3)]
    assert len(convs) == 21 and all(m.fused_bwd for m in convs)
    assert not any(m.fused_bwd for m in trainer.eval_model.modules()
                   if isinstance(m, Conv3x3x3))


def test_flags_are_the_jax_clis():
    """Same flags and defaults as the JAX CLI (the device store on), plus
    the port's own ``--device``, ``--fused_bwd`` and ``--patch_size``
    (None: LA's patch, for the port's SwinUNETR)."""
    def flags(parser):
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}
    port = flags(train_la.build_parser())
    ref = flags(jax_train_la.build_parser())
    assert ref["device_data_cache"] == 1 and port["device_data_cache"] == 1
    assert port.pop("device") == "cuda"
    assert port.pop("fused_bwd") == 0
    assert port.pop("patch_size") is None
    assert port == ref
