"""The port's pancreas evaluation and CLIs on the CPU at a tiny size
(n_filters 4, 32^3 patches, batch 8): the single-window argmax evaluation
against the JAX evaluator (labels equal, scores to 1e-4) with kernel A's
fused entry given one real window of the chunk; ``train_pancreas``' core
runs both stages (2 + 2 iterations) on a synthetic h5 set, logs through the
per-epoch meters, validates on the centre-cropped test list, writes best
files that load strictly, and starts the self-train stage from the
pre-train best's weights and Adam state; ``test_pancreas`` reads that best
file; epochs become the JAX CLI's iterations; the flags are the JAX CLIs'
and the ones the port lacks are refused."""

import copy
import re

import numpy as np
import pytest
import torch

from bcp_tpu.cli import test_pancreas as jax_test_pancreas
from bcp_tpu.cli import train_pancreas as jax_train_pancreas
from bcp_tpu.config import pancreas_config as jax_pancreas_config
from bcp_tpu.data.feed import BCPBatchFeeder as JaxFeeder
from bcp_tpu.eval.sliding_window import \
    SlidingWindowEvaluator as JaxEvaluator
from bcp_tpu_torch.cli import test_pancreas, train_pancreas
from bcp_tpu_torch.convert import load_reference_checkpoint
from bcp_tpu_torch.data.datasets import (PancreasDataset, PancreasList,
                                         VolumeList)
from bcp_tpu_torch.data.synthetic import make_pancreas_dataset
from bcp_tpu_torch.data.transforms import pancreas_test_transform
from bcp_tpu_torch.eval import sliding_window
from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator
from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.train import trainer as trainer_mod
from bcp_tpu_torch.train.checkpoints import (STATE_FILE,
                                             load_optimizer_state)
from bcp_tpu_torch.utils.logging import MetricWriter
from test_torch_cli import assert_same_dumps
from test_torch_pancreas_model import flax_pancreas, port_pancreas

PATCH = (32, 32, 32)
TINY = dict(patch_size=PATCH, n_filters=4, mask_patch=16, eval_every=2,
            eval_batch=2, compute_dtype="float32", pre_iterations=2,
            self_iterations=2)


@pytest.mark.parametrize("batch", [1, 4])
def test_single_window_argmax_matches_jax(monkeypatch, batch):
    """A centre-cropped volume is one window: the chunk holds it and
    ``batch - 1`` padded windows, and kernel A's fused entry is told that
    one is real."""
    model, variables = flax_pancreas(seed=1)
    image = np.random.default_rng(2).normal(size=PATCH).astype(np.float32)
    ref = JaxEvaluator(model, PATCH, 2, 16, 4, batch=batch)
    want_label, want_score = ref.infer(variables, image, rule="argmax")
    seen = []
    fused = sliding_window.softmax_scatter_add_windows
    monkeypatch.setattr(sliding_window, "softmax_scatter_add_windows",
                        lambda score, logits, starts, n_valid: (
                            seen.append((logits.shape[0], n_valid)),
                            fused(score, logits, starts, n_valid))[1])
    ev = SlidingWindowEvaluator(port_pancreas(variables).eval(), PATCH, 2,
                                16, 4, batch=batch, device="cpu")
    label, score = ev.infer(image, rule="argmax")
    assert seen == [(batch, 1)]
    np.testing.assert_array_equal(label, np.asarray(want_label))
    np.testing.assert_allclose(score, np.asarray(want_score), rtol=1e-4,
                               atol=1e-4)
    assert 0 < label.sum() < label.size


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """2 labelled, 4 unlabelled and 2 test volumes; one train volume has
    a side below the patch (the +1 padding)."""
    return make_pancreas_dataset(str(tmp_path_factory.mktemp("pancreas")),
                                 n_lab=2, n_unlab=4, n_test=2,
                                 shape=(36, 30, 38), seed=3)


def _args(root, snap, *extra):
    return train_pancreas.build_parser().parse_args(
        ["--data_root", root, "--snapshot_root", str(snap), "--device",
         "cpu", *extra])


@pytest.fixture(scope="module")
def run(tmp_path_factory, root):
    """Both stages on the h5 lists, recording the step hook, the scalars
    and the state the self-train stage's first step starts from."""
    mp = pytest.MonkeyPatch()
    tags, first = [], {}
    scalar = MetricWriter.scalar
    mp.setattr(MetricWriter, "scalar", lambda self, tag, v, it: (
        tags.append((tag, it)), scalar(self, tag, v, it)))
    step = trainer_mod.selftrain_step

    def spy(state, *a, **k):
        if not first:
            first.update(step=state.step,
                         model={k: v.clone() for k, v in
                                state.model.state_dict().items()},
                         opt=copy.deepcopy(state.optimizer.state_dict()))
        return step(state, *a, **k)
    mp.setattr(trainer_mod, "selftrain_step", spy)
    snap = tmp_path_factory.mktemp("pancreas_snap")
    calls = []
    try:
        trainer, out = train_pancreas.train(
            _args(root, snap), on_step=lambda *a: calls.append(a), **TINY)
    finally:
        mp.undo()
    return snap, trainer, out, calls, tags, first


def test_two_stages_write_strict_checkpoints(run):
    snap, trainer, out, calls, _, _ = run
    cfg = trainer.cfg
    assert cfg.device_data_cache and cfg.async_val and cfg.load_opt_state
    assert cfg.optimizer == "adam" and cfg.mask_kind == "fixed"
    assert not cfg.ema_full_state and cfg.cc_connectivity == 2
    assert calls == [("pre", 1), ("pre", 2), ("self", 1), ("self", 2)]
    assert trainer.validations >= 2
    d = snap / "pancreas_BCP_20_labeled"
    for stage, (dice, path) in out.items():
        assert 0.0 <= dice <= 1.0
        assert path == str(d / f"{stage}_train" /
                           "VNet_pancreas_best_model.pth")
        assert set(torch.load(path)) == {"net", "opt"}
        model = create_model("VNet_pancreas", 2, device="cpu", n_filters=4)
        model.load_state_dict(load_reference_checkpoint(path,
                                                        "VNet_pancreas"),
                              strict=True)
        log = (d / f"{stage}_train" / "log.txt").read_text()
        lines = re.findall(r"Epoch : 1, (.*)", log)
        assert len(lines) == 2
        keys = ("ce_loss", "dice_loss", "loss_all", "train_dice") \
            if stage == "pre" else ("mix_loss_lab", "mix_loss_unlab",
                                    "loss_all")
        for line in lines:
            vals = dict(kv.split(": ") for kv in line.split(", "))
            assert tuple(vals) == keys
            assert np.isfinite([float(v) for v in vals.values()]).all()
    # validation ran on the centre-cropped test volumes
    assert [img.shape for img, _ in trainer._load_val_cases()] == [PATCH] * 2


def test_scalars_are_the_references_meter_and_dice_tags(run):
    _, _, _, _, tags, _ = run
    names = {t for t, _ in tags}
    assert {f"pretrain/{k}" for k in ("ce_loss", "dice_loss", "loss_all",
                                      "train_dice", "mix_loss_lab",
                                      "mix_loss_unlab")} <= names
    assert {"test_dice", "val_dice", "Self/consistency"} <= names
    assert not any(t.startswith(("pre/", "Self/loss", "4_Var", "info/"))
                   for t in names)


def test_self_stage_starts_from_the_pre_train_best_with_adam(run):
    """`load_net_opt`: the pre-train best's weights and Adam state (its
    moments and step count, so bias correction goes on), the stage's own
    step at 0."""
    _, _, out, _, _, first = run
    best = torch.load(out["pre"][1])
    assert first["step"] == 0
    for k, v in best["net"].items():
        assert torch.equal(first["model"][k], v), k
    want = load_optimizer_state(out["pre"][1])
    assert len(first["opt"]["state"]) == len(want["state"]) == 60
    for i, s in want["state"].items():
        got = first["opt"]["state"][i]
        assert int(got["step"]) == int(s["step"]) == 2
        assert torch.equal(got["exp_avg"], s["exp_avg"])
        assert torch.equal(got["exp_avg_sq"], s["exp_avg_sq"])
    assert first["opt"]["param_groups"][0]["lr"] == 1e-3


def test_test_pancreas_reads_the_self_train_best(run, root, monkeypatch,
                                                 capsys):
    snap, _, out, _, _, _ = run
    small = test_pancreas.pancreas_config
    monkeypatch.setattr(test_pancreas, "pancreas_config",
                        lambda **kw: small(**kw).replace(
                            n_filters=4, patch_size=PATCH, eval_batch=2))
    args = test_pancreas.build_parser().parse_args(
        ["--data_root", root, "--snapshot_root", str(snap), "--device",
         "cpu"])
    avg = test_pancreas.test_calculate_metric(args)
    assert avg.shape == (4,) and np.isfinite(avg).all()
    printed = capsys.readouterr().out
    assert f"init weight from {out['self'][1]}" in printed
    assert len(re.findall(r"^0[01],\t", printed, re.M)) == 2
    # the same from in-memory volumes, and from the .pth named directly
    args = test_pancreas.build_parser().parse_args(
        ["--torch_ckpt", out["self"][1], "--device", "cpu"])
    from bcp_tpu_torch.data.datasets import PancreasDataset
    ds = PancreasDataset(root, "test")
    again = test_pancreas.test_calculate_metric(
        args, dataset=VolumeList([ds.load(i) for i in range(len(ds))]))
    np.testing.assert_array_equal(again, avg)


@pytest.mark.parametrize("percent", [10, 20])
def test_epochs_become_the_jax_clis_iterations(root, tmp_path, percent):
    args = _args(root, tmp_path, "--label_percent", str(percent),
                 "--pretraining_epochs", "3", "--self_training_epochs", "4")
    cfg = train_pancreas.config_from_args(args, patch_size=PATCH)
    jcfg = jax_pancreas_config(percent, root_path=root, patch_size=PATCH)
    per = {}
    for stage in ("pre", "self"):
        f = JaxFeeder(jcfg, stage)
        per[stage] = f.steps_per_epoch
        f.close()
    assert (cfg.pre_iterations, cfg.self_iterations) == (
        3 * per["pre"], 4 * per["self"]) == (
        3 * (2 * (5 if percent == 20 else 10) // 2), 4 * 2)
    assert cfg.batch_size == 8 and cfg.labeled_bs == 4
    # in-memory lists give the same epochs
    lists = (PancreasList([None] * 2), PancreasList([None] * 4,
                                                     "train_unlab"))
    assert train_pancreas.config_from_args(
        args, lists, patch_size=PATCH).pre_iterations == cfg.pre_iterations


def _flags(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_flags_are_the_jax_clis():
    for port, jax_cli in ((train_pancreas, jax_train_pancreas),
                          (test_pancreas, jax_test_pancreas)):
        flags = _flags(port.build_parser())
        assert flags.pop("device") == "cuda"
        assert flags == _flags(jax_cli.build_parser())


#: more cards than this host has
TOO_MANY = str(torch.cuda.device_count() + 2)


@pytest.mark.parametrize("flag,item", [
    (["--num_devices", TOO_MANY, "--device", "cuda"], "A4, multi-GPU"),
    (["--sp_devices", "2"], "A4, multi-GPU"),
    (["--remat", "1"], "A4, remat")])
def test_train_pancreas_refuses_what_the_port_lacks(root, tmp_path, flag,
                                                    item):
    """``--num_devices`` is refused when fewer cards are visible, never run
    on fewer; ``--sp_devices 2`` with two ranks reaches the config, and
    ``--sp_devices 3 --num_devices 2`` is refused (S must divide N);
    ``--remat 1`` reaches the config."""
    if item.endswith("remat"):
        assert train_pancreas.config_from_args(
            _args(root, tmp_path, *flag)).remat
        return
    if flag[0] == "--sp_devices":
        cfg = train_pancreas.config_from_args(
            _args(root, tmp_path, *flag, "--num_devices", "2"))
        assert (cfg.sp_devices, cfg.num_devices) == (2, 2)
        with pytest.raises(SystemExit, match="error: --sp_devices: "
                                             "sp_devices=3 must divide"):
            train_pancreas.train(_args(root, tmp_path, "--sp_devices", "3",
                                       "--num_devices", "2"))
        return
    with pytest.raises(SystemExit, match=f"error: .*ROADMAP {item}"):
        train_pancreas.train(_args(root, tmp_path, *flag))


def test_steps_per_dispatch_two_equals_one(run, root, tmp_path):
    """``--steps_per_dispatch 2`` runs both stages in one group each (K
    eager steps a group on the CPU) and ends each stage in the module
    run's state (K = 1, the same flags), bit for bit: student, teacher,
    Adam's moments and step count."""
    calls = []
    trainer, out = train_pancreas.train(
        _args(root, tmp_path, "--steps_per_dispatch", "2"),
        on_step=lambda *a: calls.append(a), **TINY)
    assert trainer.cfg.steps_per_dispatch == 2
    assert calls == run[3]
    for stage in ("pre_train", "self_train"):
        want = torch.load(next(run[0].glob(f"*/{stage}/{STATE_FILE}")))
        got = torch.load(next(tmp_path.glob(f"*/{stage}/{STATE_FILE}")))
        assert got["step"] == want["step"] == 2
        for part in ("model", "teacher"):
            for k, v in want[part].items():
                assert torch.equal(got[part][k], v), (stage, part, k)
        for i, st in want["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(got["optimizer"]["state"][i][k], v), (
                    stage, i, k)


@pytest.mark.parametrize("flag,item", [
    (["--save_result", "1"], "A5"),
    (["--num_devices", TOO_MANY, "--device", "cuda"], "A4")])
def test_test_pancreas_refuses_what_the_port_lacks(root, tmp_path,
                                                   monkeypatch, flag, item):
    """``--num_devices`` evaluates on that many cards
    (``tests/test_torch_parallel_cli.py``) and is refused when fewer are
    visible, never run on fewer (ROADMAP A4). ``--save_result 1``
    writes the JAX CLI's
    ``predictions/%02d_{pred,img,gt}.nii.gz`` of the centre-cropped test
    volumes with the same decompressed contents, from one .pth, both CLIs
    at 32^3, n_filters 4, f32."""
    if item == "A4":
        args = test_pancreas.build_parser().parse_args(
            ["--snapshot_root", str(tmp_path), "--device", "cpu", *flag])
        with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
            test_pancreas.test_calculate_metric(args)
        return
    pth = tmp_path / "VNet_pancreas.pth"
    # seeded weights: the test must not depend on what ran before it
    torch.save(port_pancreas(flax_pancreas(4, seed=0)[1]).state_dict(), pth)
    for mod in (test_pancreas, jax_test_pancreas):
        monkeypatch.setattr(mod, "pancreas_config", lambda *a,
                            _c=mod.pancreas_config, **k: _c(*a, **k).replace(
                                patch_size=PATCH, n_filters=4,
                                compute_dtype="float32"))
    common = ["--data_root", root, "--torch_ckpt", str(pth), *flag]
    jax_test_pancreas.main(common + ["--snapshot_root",
                                     str(tmp_path / "jax")])
    test_pancreas.main(common + ["--snapshot_root", str(tmp_path / "port"),
                                 "--device", "cpu"])
    sub = next((tmp_path / "jax").glob("*/self_train/predictions"))
    # at random weights the two classes' scores sit near 0.5 and a few are
    # equal to rounding (0.49999997 against 0.5 in volume 1): there the
    # argmax may differ, each side summing in its own order
    args = test_pancreas.build_parser().parse_args(common + [
        "--snapshot_root", str(tmp_path / "port"), "--device", "cpu"])
    cfg, evaluator = test_pancreas.build_evaluator(args)
    ties = {}
    for i in range(2):
        image = pancreas_test_transform(
            *PancreasDataset(root, "test", cache=False).load(i),
            cfg.patch_size)[0]
        score = np.asarray(evaluator.infer(image, rule="argmax",
                                           return_score=True)[1])
        ties["%02d_pred.nii.gz" % i] = np.abs(score[1] - score[0]) <= 2.4e-7
    assert_same_dumps(sub, tmp_path / "port" / sub.relative_to(
        tmp_path / "jax"), ["%02d_%s.nii.gz" % (i, t) for i in range(2)
                            for t in ("gt", "img", "pred")], ties)


def test_clis_run_on_the_card_by_default(root, tmp_path):
    """Without ``--device cpu`` both CLIs ask for the card, and a host
    without one raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    args = train_pancreas.build_parser().parse_args(
        ["--data_root", root, "--snapshot_root", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA device"):
        train_pancreas.build_trainer(args)
    pth = tmp_path / "VNet_pancreas.pth"
    torch.save(create_model("VNet_pancreas", 2, device="cpu").state_dict(),
               pth)
    args = test_pancreas.build_parser().parse_args(["--torch_ckpt",
                                                    str(pth)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA device"):
        test_pancreas.build_evaluator(args)
