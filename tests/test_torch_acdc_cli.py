"""The port's ACDC CLIs on the CPU at a tiny size (n_filters 4, 32x32
slices, batch 8): ``train_acdc``'s core runs both stages with one
validation each on the device store, writes checkpoints that load
strictly, and starts the self-train stage from the pre-train best's
weights and optimizer; ``--resume`` goes on from the saved step, and a
resumed stage repeats none of its draws; ``test_acdc`` reads the best file
and writes ``performance.txt``; the flags the port lacks are refused and
the rest are the JAX CLIs'; ``test_acdc --save_result 1`` writes the JAX
CLI's files; the core trains with ``fuse_subbatches=False``."""

import re
import shutil

import numpy as np
import pytest
import torch

from bcp_tpu.cli import test_acdc as jax_test_acdc
from bcp_tpu.cli import train_acdc as jax_train_acdc
from bcp_tpu.data import synthetic as jax_synthetic
from bcp_tpu_torch.cli import test_acdc, train_acdc
from bcp_tpu_torch.config import acdc_config
from bcp_tpu_torch.convert import load_reference_checkpoint
from bcp_tpu_torch.data import feed
from bcp_tpu_torch.data.datasets import SliceList, VolumeList
from bcp_tpu_torch.data.synthetic import acdc_cases
from bcp_tpu_torch.eval.slice2d import Slice2DEvaluator
from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.models.layers import Dropout
from bcp_tpu_torch.train import trainer as trainer_mod
from bcp_tpu_torch.train.checkpoints import STATE_FILE, load_optimizer_state
from bcp_tpu_torch.train.state import init_state
from bcp_tpu_torch.train.steps import pretrain_step
from bcp_tpu_torch.utils.logging import MetricWriter
from test_torch_cli import assert_same_dumps

TINY = dict(patch_size=(32, 32), n_filters=4, eval_every=2,
            compute_dtype="float32")


@pytest.fixture(scope="module")
def data():
    slices, vols = acdc_cases(16, ((40, 36), (36, 44), (30, 30)), 2,
                              (3, 40, 36), seed=1)
    return SliceList(slices), vols


@pytest.fixture(autouse=True)
def eight_labelled(monkeypatch):
    """labelnum 1 means the first 8 of the 16 slices."""
    monkeypatch.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)


def _args(root, *extra, pre=2, self_=2):
    return train_acdc.build_parser().parse_args(
        ["--labelnum", "1", "--pre_iterations", str(pre),
         "--max_iterations", str(self_), "--batch_size", "8",
         "--labeled_bs", "4", "--snapshot_root", str(root), "--device",
         "cpu", *extra])


@pytest.fixture(scope="module")
def run(tmp_path_factory, data):
    """Both stages, recording the step hook, the scalars, and the state the
    self-train stage's first step starts from."""
    mp = pytest.MonkeyPatch()
    mp.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    tags, first = [], {}
    scalar = MetricWriter.scalar
    mp.setattr(MetricWriter, "scalar", lambda self, tag, v, it: (
        tags.append((tag, it)), scalar(self, tag, v, it)))
    step = trainer_mod.selftrain_step

    def spy(state, *a, **k):
        if not first:
            first.update(
                step=state.step, model=_copy(state.model.state_dict()),
                teacher=_copy(state.teacher.state_dict()),
                opt=_copy(state.optimizer.state_dict()))
        return step(state, *a, **k)
    mp.setattr(trainer_mod, "selftrain_step", spy)
    root = tmp_path_factory.mktemp("acdc_cli")
    calls = []
    try:
        trainer, out = train_acdc.train(
            _args(root), train_dataset=data[0], val_cases=data[1],
            on_step=lambda *a: calls.append(a), **TINY)
    finally:
        mp.undo()
    return root, trainer, out, calls, tags, first


def _copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree


def test_two_stages_write_strict_checkpoints(run):
    root, trainer, out, calls, tags, _ = run
    cfg = trainer.cfg
    assert cfg.device_data_cache and cfg.async_val and cfg.ema_full_state
    assert cfg.load_opt_state and cfg.pseudo_label == "argmax"
    assert calls == [("pre", 1), ("pre", 2), ("self", 1), ("self", 2)]
    assert isinstance(trainer.evaluator, Slice2DEvaluator)
    assert trainer.validations >= 2
    d = root / "ACDC_BCP_1_labeled"
    for stage, (dice, path) in out.items():
        assert 0.0 <= dice <= 1.0
        assert path == str(d / f"{stage}_train" / "unet_best_model.pth")
        model = create_model("unet", 4, device="cpu", n_filters=4)
        model.load_state_dict(load_reference_checkpoint(path), strict=True)
        assert set(torch.load(path)) == {"net", "opt"}
        saved = torch.load(d / f"{stage}_train" / STATE_FILE)
        model.load_state_dict(saved["teacher"], strict=True)
        log = (d / f"{stage}_train" / "log.txt").read_text()
        losses = [float(v) for v in re.findall(r"loss: (\S+)", log)]
        assert len(losses) == 2 and np.isfinite(losses).all()
    assert f"loaded from {out['pre'][1]}" in (
        d / "self_train" / "log.txt").read_text()


def test_scalars_are_the_references_info_tags(run):
    _, _, _, _, tags, _ = run
    names = {t for t, _ in tags}
    assert {"info/total_loss", "info/mix_dice", "info/mix_ce",
            "info/consistency_weight", "info/val_mean_dice"} <= names
    assert {f"info/val_{c}_{m}" for c in (1, 2, 3)
            for m in ("dice", "hd95")} <= names
    assert not any(t.startswith(("pre/", "Self/", "4_Var")) for t in names)
    assert ("info/consistency_weight", 1) in tags


def test_self_stage_starts_from_the_pre_train_best_with_its_optimizer(run):
    """`load_net_opt` (`checkpoints.py:116-130`): the student and the
    momentum buffers of the pre-train best, the teacher equal to the
    student, the step fresh."""
    _, _, out, _, _, first = run
    best = torch.load(out["pre"][1])
    assert first["step"] == 0
    for k, v in best["net"].items():
        assert torch.equal(first["model"][k], v), k
        assert torch.equal(first["teacher"][k], v), k
    want = load_optimizer_state(out["pre"][1])
    assert len(first["opt"]["state"]) == len(want["state"]) == 82
    for i, s in want["state"].items():
        assert torch.equal(first["opt"]["state"][i]["momentum_buffer"],
                           s["momentum_buffer"])
    assert first["opt"]["param_groups"][0]["momentum"] == 0.9


def test_load_with_opt_hands_over_the_optimizer(tmp_path):
    """The hand-off alone: a pre-train step's state saved with its
    optimizer and loaded by ``load_with_opt``."""
    from bcp_tpu_torch.train.checkpoints import save_many, snapshot
    from bcp_tpu_torch.train.state import load_with_opt
    cfg = acdc_config(**TINY)
    state = init_state(cfg, "cpu")
    x = torch.randn(2, 1, 32, 32)
    lab = torch.randint(0, 4, (2, 32, 32))
    batch = {"img_a": x[:1], "img_b": x[1:], "lab_a": lab[:1],
             "lab_b": lab[1:]}
    pretrain_step(state, batch, torch.ones(32, 32, dtype=torch.int32), cfg)
    path = str(tmp_path / "best.pth")
    save_many([path], snapshot(state), with_opt=True)
    fresh = load_with_opt(init_state(cfg, "cpu", seed=3),
                          load_reference_checkpoint(path),
                          load_optimizer_state(path))
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"],
                           fresh.optimizer.state[q]["momentum_buffer"])
    assert fresh.step == 0
    save_many([str(tmp_path / "weights.pth")], snapshot(state))
    with pytest.raises(ValueError, match="no optimizer state"):
        load_optimizer_state(str(tmp_path / "weights.pth"))


def test_resume_goes_on_from_the_saved_step(run, data, tmp_path):
    root = tmp_path / "resume"
    shutil.copytree(run[0], root)
    calls = []
    train_acdc.train(_args(root, "--stage", "pre", "--resume", pre=3),
                     train_dataset=data[0], val_cases=data[1],
                     on_step=lambda *a: calls.append(a), **TINY)
    log = (root / "ACDC_BCP_1_labeled" / "pre_train" / "log.txt").read_text()
    assert re.findall(r"resumed from \S+ at step (\d+)", log) == ["2"]
    assert calls == [("pre", 3)]


def _recorded_draws(monkeypatch, trainer, resume=False):
    """One self-train stage's draws per iteration: [(mask starts, [keep
    mask of each dropout draw, in order]), ...]."""
    draws = []
    starts = trainer_mod.cuboid_starts

    def rec_starts(*a, **k):
        out = starts(*a, **k)
        draws.append((out, []))
        return out
    forward = Dropout.forward

    def rec_forward(self, x):
        if not self.training or self.keep is not None:
            return forward(self, x)
        self.keep = torch.rand(self.mask_shape(x), generator=self.generator,
                               device=x.device) < 1.0 - self.p
        draws[-1][1].append(self.keep.clone())
        try:
            return forward(self, x)
        finally:
            self.keep = None
    monkeypatch.setattr(trainer_mod, "cuboid_starts", rec_starts)
    monkeypatch.setattr(Dropout, "forward", rec_forward)
    trainer.selftrain(resume=resume)
    monkeypatch.undo()
    monkeypatch.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    return draws


def test_resumed_stage_repeats_no_draws(run, data, tmp_path, monkeypatch):
    """The element-wise dropouts' keep masks come from the per-iteration
    generator (`iteration_draws`): a self-train stage stopped at step 2
    and resumed draws at 3 and 4 what the uninterrupted stage draws."""
    whole_root, cut_root = tmp_path / "whole", tmp_path / "cut"
    for r in (whole_root, cut_root):
        shutil.copytree(run[0] / "ACDC_BCP_1_labeled" / "pre_train",
                        r / "ACDC_BCP_1_labeled" / "pre_train")

    def trainer(root, n):
        return train_acdc.build_trainer(
            _args(root, self_=n), train_dataset=data[0], val_cases=data[1],
            **TINY)
    whole = _recorded_draws(monkeypatch, trainer(whole_root, 4))
    first = _recorded_draws(monkeypatch, trainer(cut_root, 2))
    resumed = _recorded_draws(monkeypatch, trainer(cut_root, 4), True)
    assert len(whole) == 4 and len(first) == len(resumed) == 2
    for a, b in ((first, whole[:2]), (resumed, whole[2:])):
        for (sa, ka), (sb, kb) in zip(a, b):
            assert sa == sb
            # teacher and student: five encoder dropouts each
            assert len(ka) == len(kb) == 10
            assert all(torch.equal(x, y) for x, y in zip(ka, kb))
    assert len({s for s, _ in whole}) > 1


def test_test_acdc_reads_the_best_file_and_writes_performance(run, data,
                                                              capsys):
    root, _, out, _, _, _ = run
    args = test_acdc.build_parser().parse_args(
        ["--labelnum", "1", "--snapshot_root", str(root), "--device", "cpu",
         "--n_filters", "4", "--patch_size", "32", "32"])
    avg = test_acdc.test_calculate_metric(args, dataset=VolumeList(data[1]))
    assert avg.shape == (3, 4) and np.isfinite(avg).all()
    assert f"init weight from {out['self'][1]}" in capsys.readouterr().out
    text = (root / "ACDC_BCP_1_labeled" / "performance.txt").read_text()
    assert text.startswith("metric is [[") and "average metric is" in text
    # the same numbers as the evaluator on the best file's weights, in the
    # CLI's compute dtype (bf16, as the JAX CLI's)
    model = create_model("unet", 4, device="cpu", n_filters=4,
                         compute_dtype=torch.bfloat16)
    model.load_state_dict(load_reference_checkpoint(out["self"][1]))
    ev = Slice2DEvaluator(model, (32, 32), 4, device="cpu")
    want = np.mean([ev.metrics_for(ev.predict_volume(img), lab)
                    for img, lab in data[1]], axis=0)
    np.testing.assert_allclose(avg, want, rtol=1e-12)


#: more cards than this host has
TOO_MANY = str(torch.cuda.device_count() + 2)


@pytest.mark.parametrize("flag,item", [
    (["--num_devices", TOO_MANY, "--device", "cuda"], "multi-GPU"),
    (["--sp_devices", "2"], "multi-GPU")])
def test_train_acdc_refuses_what_the_port_lacks(tmp_path, flag, item):
    """``--num_devices`` is refused when fewer cards are visible, never run
    on fewer. ``--sp_devices 2`` with two ranks reaches the config, and
    ``--sp_devices 3 --num_devices 2`` is refused: S must divide N."""
    if flag[0] == "--sp_devices":
        cfg = train_acdc.config_from_args(
            _args(tmp_path, *flag, "--num_devices", "2"))
        assert (cfg.sp_devices, cfg.num_devices) == (2, 2)
        with pytest.raises(SystemExit, match="error: --sp_devices: "
                                             "sp_devices=3 must divide"):
            train_acdc.train(_args(tmp_path, "--sp_devices", "3",
                                   "--num_devices", "2"))
        return
    with pytest.raises(SystemExit, match=f"error: .*ROADMAP.*{item}"):
        train_acdc.train(_args(tmp_path, *flag))


def test_steps_per_dispatch_two_equals_one(run, data, tmp_path):
    """``--steps_per_dispatch 2`` runs both stages in one group each (K
    eager steps a group on the CPU) and ends each stage in the module
    run's state (K = 1, the same flags), bit for bit: student, teacher,
    momentum buffers and step."""
    calls = []
    trainer, out = train_acdc.train(
        _args(tmp_path, "--steps_per_dispatch", "2"),
        train_dataset=data[0], val_cases=data[1],
        on_step=lambda *a: calls.append(a), **TINY)
    assert trainer.cfg.steps_per_dispatch == 2
    assert calls == run[3]
    for stage in ("pre_train", "self_train"):
        want = torch.load(run[0] / "ACDC_BCP_1_labeled" / stage / STATE_FILE)
        got = torch.load(tmp_path / "ACDC_BCP_1_labeled" / stage / STATE_FILE)
        assert got["step"] == want["step"] == 2
        for part in ("model", "teacher"):
            for k, v in want[part].items():
                assert torch.equal(got[part][k], v), (stage, part, k)
        for i, st in want["optimizer"]["state"].items():
            assert torch.equal(got["optimizer"]["state"][i][
                "momentum_buffer"], st["momentum_buffer"]), (stage, i)


@pytest.mark.parametrize("flag,what", [
    (["--save_result", "1"], "NIfTI"),
    (["--num_devices", TOO_MANY, "--device", "cuda"], "one device")])
def test_test_acdc_refuses_what_the_port_lacks(tmp_path, monkeypatch, flag,
                                               what):
    """``--num_devices`` runs on that many cards
    (``tests/test_torch_parallel_cli.py``) and is refused when fewer are
    visible: the CLI never runs on fewer (ROADMAP A4). ``--save_result 1``
    writes the JAX CLI's ``{case}_{pred,img,gt}.nii.gz`` (spacing (1, 1,
    10)) with the same decompressed contents, from one .pth on one
    synthetic test list, both CLIs at n_filters 4, 32x32, f32."""
    if what == "one device":
        args = test_acdc.build_parser().parse_args(
            ["--snapshot_root", str(tmp_path), "--device", "cpu", *flag])
        with pytest.raises(SystemExit, match="but only .* visible .*ROADMAP "
                                             "A4"):
            test_acdc.test_calculate_metric(args)
        return
    root = jax_synthetic.make_acdc_dataset(
        str(tmp_path / "data"), n_train_slices=1, n_val=2,
        slice_shape=(40, 36), vol_depth=3, seed=2)
    pth = tmp_path / "unet.pth"
    # seeded weights: the test must not depend on what ran before it
    with torch.random.fork_rng():
        torch.manual_seed(0)
        torch.save(create_model("unet", 4, device="cpu",
                                n_filters=4).state_dict(), pth)
    for mod in (test_acdc, jax_test_acdc):
        monkeypatch.setattr(mod, "acdc_config", lambda *a, _c=mod.acdc_config,
                            **k: _c(*a, **k).replace(
                                n_filters=4, patch_size=(32, 32),
                                compute_dtype="float32"))
    common = ["--root_path", root, "--torch_ckpt", str(pth), *flag]
    jax_test_acdc.main(common + ["--snapshot_root", str(tmp_path / "jax")])
    test_acdc.main(common + ["--snapshot_root", str(tmp_path / "port"),
                             "--device", "cpu", "--n_filters", "4",
                             "--patch_size", "32", "32"])
    assert_same_dumps(tmp_path / "jax" / "ACDC_BCP_3_labeled" /
                      "unet_predictions", tmp_path / "port" /
                      "ACDC_BCP_3_labeled" / "unet_predictions",
                      [f"synth_val_{i:03d}_{t}.nii.gz" for i in range(2)
                       for t in ("gt", "img", "pred")])


def test_clis_run_on_the_card_by_default(tmp_path):
    """Without ``--device cpu`` both CLIs ask for the card, and a host
    without one raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    args = train_acdc.build_parser().parse_args(
        ["--snapshot_root", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA device"):
        train_acdc.build_trainer(args, train_dataset=SliceList([]),
                                 val_cases=[])
    pth = tmp_path / "unet.pth"
    torch.save(create_model("unet", 4, device="cpu").state_dict(), pth)
    args = test_acdc.build_parser().parse_args(["--torch_ckpt", str(pth)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA device"):
        test_acdc.build_evaluator(args)


def _flags(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_flags_are_the_jax_clis():
    """The JAX CLIs' flags and defaults (the device store on), plus the
    port's ``--device`` and, for a checkpoint of another size,
    ``test_acdc``'s ``--n_filters`` / ``--patch_size``."""
    port = _flags(train_acdc.build_parser())
    assert port.pop("device") == "cuda"
    assert port == _flags(jax_train_acdc.build_parser())
    assert port["device_data_cache"] == 1
    port = _flags(test_acdc.build_parser())
    assert port.pop("device") == "cuda"
    assert port.pop("n_filters") is None
    assert port.pop("patch_size") == [256, 256]
    assert port == _flags(jax_test_acdc.build_parser())


@pytest.mark.parametrize("what", ["steps"])
def test_refusals_name_what_is_still_missing(tmp_path, data, what):
    """What was refused before it was ported, ``fuse_subbatches=False``,
    now trains: both stages through the CLI's core, finite losses, strict
    checkpoints."""
    logged = []
    trainer, out = train_acdc.train(
        _args(tmp_path), train_dataset=data[0], val_cases=data[1],
        fuse_subbatches=False, **TINY)
    assert trainer.cfg.fuse_subbatches is False
    for stage in ("pre", "self"):
        model = create_model("unet", 4, device="cpu", n_filters=4)
        model.load_state_dict(load_reference_checkpoint(out[stage][1]),
                              strict=True)
    text = (tmp_path / "ACDC_BCP_1_labeled" / "self_train" /
            "log.txt").read_text()
    losses = [float(v) for v in re.findall(r"loss: (\S+)", text)]
    assert len(losses) == 2 and np.isfinite(losses).all()
