"""Resume and the ordered background validation of the port's trainer, on
the CPU at a tiny size. The models are the JAX package's own tests
(`tests/test_trainer.py:56-167`): ``test_resume_from_last``,
``test_scan_best_dice``, ``test_resume_cannot_clobber_historical_best``,
``test_async_val_matches_serialized`` and
``test_async_val_worker_error_surfaces``."""

import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bcp_tpu.train.checkpoints import scan_best_dice as jax_scan_best_dice
from bcp_tpu_torch import kernels
from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.data.datasets import VolumeList
from bcp_tpu_torch.data.synthetic import la_cases
from bcp_tpu_torch.ops.masks import cuboid_mask, cuboid_starts
from bcp_tpu_torch.train.checkpoints import (STATE_FILE, restore_state,
                                             save_many, scan_best_dice,
                                             snapshot)
from bcp_tpu_torch.train.state import init_state
from bcp_tpu_torch.train.steps import selftrain_step
from bcp_tpu_torch.train.trainer import BCPTrainer, _ValWorker

PATCH = (16, 16, 16)


def _cfg(root, **kw):
    base = dict(patch_size=PATCH, n_filters=4, eval_every=2,
                compute_dtype="float32", pre_iterations=4, self_iterations=2,
                snapshot_root=str(root))
    base.update(kw)
    return la_config(labelnum=4, **base)


@pytest.fixture(scope="module")
def data():
    return (VolumeList(la_cases(8, (20, 20, 18), seed=11)),
            la_cases(1, (24, 22, 20), seed=12))


def _trainer(cfg, data, **kw):
    return BCPTrainer(cfg, device="cpu", train_dataset=data[0],
                      val_cases=data[1], **kw)


def _tensors_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_scan_best_dice_on_the_jax_tests_names(tmp_path):
    assert scan_best_dice(str(tmp_path / "missing")) == 0.0
    os.makedirs(tmp_path / "iter_200_dice_0.61")
    os.makedirs(tmp_path / "iter_400_dice_0.9012")
    os.makedirs(tmp_path / "VNet_best_model")
    os.makedirs(tmp_path / "iter_bad_dice_zzz")
    assert scan_best_dice(str(tmp_path)) == pytest.approx(0.9012)
    assert scan_best_dice(str(tmp_path)) == jax_scan_best_dice(str(tmp_path))
    # the port's own files carry the reference's .pth suffix
    (tmp_path / "iter_600_dice_0.93.pth").touch()
    (tmp_path / "VNet_best_model.pth").touch()
    (tmp_path / "last.pth").touch()
    assert scan_best_dice(str(tmp_path)) == pytest.approx(0.93)


def test_saved_state_restores_student_teacher_momentum_and_step(tmp_path):
    """Two self-train updates, save, restore into a fresh state: every
    tensor equal, and a third update gives the same bits on both."""
    cfg = _cfg(tmp_path)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.normal(size=(2, 1, *PATCH)).astype(
        np.float32)) for k in ("img_a", "img_b", "uimg_a", "uimg_b")}
    for k in ("lab_a", "lab_b"):
        batch[k] = torch.from_numpy(
            (rng.random((2, *PATCH)) > 0.6).astype(np.uint8))
    mask = cuboid_mask(PATCH, cuboid_starts(rng, PATCH))
    keeps = [torch.ones(4, 64, dtype=torch.bool),
             torch.ones(4, 4, dtype=torch.bool)]
    state = init_state(cfg, "cpu")
    for _ in range(2):
        selftrain_step(state, batch, mask, cfg, keeps, keeps)
    last = str(tmp_path / "last.pth")
    save_many([str(tmp_path / "iter_2_dice_0.5.pth"), last], snapshot(state))
    fresh = restore_state(str(tmp_path / STATE_FILE),
                          init_state(cfg, "cpu", seed=99))
    assert fresh.step == state.step == 2
    _tensors_equal(fresh.model.state_dict(), state.model.state_dict())
    _tensors_equal(fresh.teacher.state_dict(), state.teacher.state_dict())
    assert not torch.equal(fresh.teacher.state_dict()[
        "decoder.out_conv.weight"], fresh.model.state_dict()[
        "decoder.out_conv.weight"])
    _tensors_equal(torch.load(last), state.model.state_dict())
    for p, q in zip(fresh.model.parameters(), state.model.parameters()):
        assert torch.equal(fresh.optimizer.state[p]["momentum_buffer"],
                           state.optimizer.state[q]["momentum_buffer"])
    for s in (fresh, state):
        selftrain_step(s, batch, mask, cfg, keeps, keeps)
    assert fresh.step == 3
    _tensors_equal(fresh.model.state_dict(), state.model.state_dict())
    _tensors_equal(fresh.teacher.state_dict(), state.teacher.state_dict())


def test_snapshot_does_not_follow_later_updates(tmp_path):
    cfg = _cfg(tmp_path)
    state = init_state(cfg, "cpu")
    snap = snapshot(state)
    before = snap["model"]["decoder.out_conv.weight"].clone()
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    state.step += 1
    assert torch.equal(snap["model"]["decoder.out_conv.weight"], before)
    assert snap["step"] == 0


@pytest.fixture(scope="module")
def pre_run(tmp_path_factory, data):
    """Four pre-train steps with the default background validation."""
    root = tmp_path_factory.mktemp("pre_run")
    calls = []
    trainer = _trainer(_cfg(root), data, on_step=lambda *a: calls.append(a))
    dice, best = trainer.pretrain()
    return root, trainer, dice, best, calls


def test_resume_goes_on_from_the_saved_step(pre_run, data, tmp_path):
    root, first, _, _, first_calls = pre_run
    assert first_calls == [("pre", i) for i in range(1, 5)]
    import shutil
    new_root = tmp_path / "resume"
    shutil.copytree(root, new_root)
    saved = torch.load(os.path.join(
        new_root, "LA_BCP_4_labeled", "pre_train", STATE_FILE))
    assert saved["step"] == 4
    calls = []
    trainer = _trainer(_cfg(new_root, pre_iterations=7), data,
                       on_step=lambda *a: calls.append(a))
    dice, _ = trainer.pretrain(resume=True)
    assert calls == [("pre", 5), ("pre", 6), ("pre", 7)]
    assert 0.0 <= dice <= 1.0
    log = open(os.path.join(trainer.pre_dir, "log.txt")).read()
    assert re.search(r"resumed from \S+last_state.pt at step 4 ", log)
    assert "stage pre done: 3 steps" in log
    # the state saved at the validation of step 6 is the newest
    assert torch.load(os.path.join(trainer.pre_dir, STATE_FILE))["step"] == 6
    # nothing to do: no step, no crash (`test_resume_from_last`)
    calls.clear()
    again = _trainer(_cfg(new_root, pre_iterations=6), data,
                     on_step=lambda *a: calls.append(a))
    again.pretrain(resume=True)
    assert calls == []
    # without a saved state --resume starts from step 1
    fresh = _trainer(_cfg(tmp_path / "fresh", pre_iterations=1), data,
                     on_step=lambda *a: calls.append(a))
    fresh.pretrain(resume=True)
    assert calls == [("pre", 1)]


def test_resume_cannot_clobber_historical_best(pre_run, data, tmp_path):
    import shutil
    root = tmp_path / "clobber"
    shutil.copytree(pre_run[0], root)
    pre_dir = os.path.join(root, "LA_BCP_4_labeled", "pre_train")
    # a historical best far above anything two more steps can reach
    open(os.path.join(pre_dir, "iter_2_dice_0.99.pth"), "wb").close()
    best = os.path.join(pre_dir, "VNet_best_model.pth")
    mtime = os.path.getmtime(best)
    last_mtime = os.path.getmtime(os.path.join(pre_dir, "last.pth"))
    time.sleep(0.05)
    trainer = _trainer(_cfg(root, pre_iterations=6), data)
    dice, _ = trainer.pretrain(resume=True)
    assert dice >= 0.99                      # historical best carried over
    assert os.path.getmtime(best) == mtime   # best model not saved again
    # the validation at step 6 still refreshed the rolling files
    assert os.path.getmtime(os.path.join(pre_dir, "last.pth")) > last_mtime
    assert torch.load(os.path.join(pre_dir, STATE_FILE))["step"] == 6


def test_background_validation_matches_inline(pre_run, data, tmp_path):
    """Same validations, best-dice sequence, file names and bytes of
    weights as the inline loop (`test_async_val_matches_serialized`)."""
    _, bg, bg_dice, _, _ = pre_run
    assert bg.cfg.async_val and bg.cfg.async_val_depth == 2
    inline = _trainer(_cfg(tmp_path, async_val=False), data)
    dice, _ = inline.pretrain()
    assert dice == bg_dice
    # the background run validates once more: its warm-up
    assert bg.validations == inline.validations + 1

    def files(d):
        return sorted(n for n in os.listdir(d) if n.endswith((".pth", ".pt")))

    def validations(d):
        return re.findall(r"validation@(\d+): dice (\S+)",
                          open(os.path.join(d, "log.txt")).read())
    assert files(inline.pre_dir) == files(bg.pre_dir)
    assert "last.pth" in files(bg.pre_dir) and STATE_FILE in files(bg.pre_dir)
    assert validations(inline.pre_dir) == validations(bg.pre_dir)
    assert [it for it, _ in validations(bg.pre_dir)] == ["2", "4"]
    for name in files(bg.pre_dir):
        a = torch.load(os.path.join(bg.pre_dir, name))
        b = torch.load(os.path.join(inline.pre_dir, name))
        if name == STATE_FILE:
            assert a["step"] == b["step"] == 4
            _tensors_equal(a["teacher"], b["teacher"])
            a, b = a["model"], b["model"]
        _tensors_equal(a, b)


def test_validation_error_surfaces_in_the_training_thread(data, tmp_path):
    trainer = _trainer(_cfg(tmp_path), data)

    def boom(*a, **k):
        raise RuntimeError("validation exploded")
    trainer.evaluator.validate_dice = boom
    with pytest.raises(RuntimeError, match="validation exploded"):
        trainer.pretrain()
    assert trainer._workers == []        # closed on the way out
    assert not [t for t in threading.enumerate()
                if t is not threading.main_thread() and not t.daemon]


def test_val_worker_error_surfaces():
    """`test_async_val_worker_error_surfaces`: a job's exception is raised
    again in the submitting thread, and the worker goes on serving."""
    w = _ValWorker()

    def boom():
        raise RuntimeError("validation exploded")
    w.submit(boom)
    with pytest.raises(RuntimeError, match="validation exploded"):
        w.drain()
    w.submit(lambda: None)
    w.drain()
    w.submit(boom)
    w._q.join()
    with pytest.raises(RuntimeError, match="validation exploded"):
        w.submit(lambda: None)           # not queued onto a failed job
    w.close()


@pytest.mark.parametrize("depth", [1, 2])
def test_val_worker_runs_in_order_and_bounds_jobs_in_flight(depth):
    w = _ValWorker(depth)
    gate, done, submitted = threading.Event(), [], []

    def job(i):
        gate.wait(5)
        done.append(i)

    def feed():
        for i in range(depth + 2):
            w.submit(lambda i=i: job(i))
            submitted.append(i)
    t = threading.Thread(target=feed)
    t.start()
    time.sleep(0.2)
    assert len(submitted) == depth       # the next submit waits for a slot
    gate.set()
    t.join(5)
    w.drain()
    assert done == list(range(depth + 2))
    w.close()


def test_launch_counts_survive_two_launching_threads():
    """The training thread and the validation thread count launches of the
    same wrappers: no update may be lost."""
    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            kernels.count_launch(wrapper) for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * n_each


def _recorded_draws(monkeypatch, trainer, stage, resume=False):
    """Run one stage of ``trainer`` and return its draws per iteration:
    [(mask starts, [keep mask of each dropout draw, in order]), ...]."""
    from bcp_tpu_torch.models.layers import ChannelDropout
    from bcp_tpu_torch.train import trainer as trainer_mod
    draws = []
    starts = trainer_mod.cuboid_starts

    def rec_starts(*a, **k):
        out = starts(*a, **k)
        draws.append((out, []))
        return out
    forward = ChannelDropout.forward

    def rec_forward(self, x):
        if not self.training or self.keep is not None:
            return forward(self, x)
        self.keep = torch.rand(x.shape[:2], generator=self.generator,
                               device=x.device) < 1.0 - self.p
        draws[-1][1].append(self.keep.clone())
        try:
            return forward(self, x)
        finally:
            self.keep = None
    monkeypatch.setattr(trainer_mod, "cuboid_starts", rec_starts)
    monkeypatch.setattr(ChannelDropout, "forward", rec_forward)
    run = trainer.pretrain if stage == "pre" else trainer.selftrain
    run(resume=resume)
    monkeypatch.undo()
    return draws


def _assert_same_draws(a, b):
    assert len(a) == len(b)
    for (sa, ka), (sb, kb) in zip(a, b):
        assert sa == sb
        assert len(ka) == len(kb) > 0
        for x, y in zip(ka, kb):
            assert torch.equal(x, y)


def test_resumed_selftrain_draws_what_the_uninterrupted_stage_draws(
        pre_run, data, tmp_path, monkeypatch):
    """The mask offsets and keep masks of iteration ``it`` depend on (seed,
    stage, it) alone (`fold_in(base_key, it)`, `trainer.py:483-495`): a
    self-train stage stopped at its eval boundary 2 and resumed draws at 3
    and 4 what the uninterrupted stage draws there."""
    import shutil
    whole_root, cut_root = tmp_path / "whole", tmp_path / "cut"
    shutil.copytree(pre_run[0], whole_root)
    shutil.copytree(pre_run[0], cut_root)
    whole = _recorded_draws(monkeypatch, _trainer(
        _cfg(whole_root, self_iterations=4), data), "self")
    first = _recorded_draws(monkeypatch, _trainer(
        _cfg(cut_root, self_iterations=2), data), "self")
    resumed_trainer = _trainer(_cfg(cut_root, self_iterations=4), data)
    assert torch.load(os.path.join(resumed_trainer.self_dir,
                                   STATE_FILE))["step"] == 2
    resumed = _recorded_draws(monkeypatch, resumed_trainer, "self",
                              resume=True)
    assert len(whole) == 4 and len(first) == 2 and len(resumed) == 2
    _assert_same_draws(first, whole[:2])
    _assert_same_draws(resumed, whole[2:])
    # not one draw repeated over the iterations
    assert len({s for s, _ in whole}) > 1


@pytest.mark.parametrize("change", [{"stage": "pre"}, {"seed": 1338}])
def test_draws_differ_by_stage_and_seed(data, tmp_path, monkeypatch,
                                        change):
    """Two stages of another kind or another seed draw differently at the
    same iterations."""
    base = _recorded_draws(monkeypatch, _trainer(
        _cfg(tmp_path / "a", pre_iterations=2), data), "pre")
    cfg = _cfg(tmp_path / "b", pre_iterations=2, self_iterations=2,
               seed=change.get("seed", 1337))
    if change.get("stage") == "pre":
        # a self-train stage from the first run's pre-train checkpoint
        import shutil
        shutil.copytree(tmp_path / "a", tmp_path / "b")
        other = _recorded_draws(monkeypatch, _trainer(cfg, data), "self")
    else:
        other = _recorded_draws(monkeypatch, _trainer(cfg, data), "pre")
    assert len(base) == len(other) == 2
    for (sa, ka), (sb, kb) in zip(base, other):
        assert sa != sb or not all(torch.equal(x, y)
                                   for x, y in zip(ka, kb))
    assert [s for s, _ in base] != [s for s, _ in other]


@pytest.mark.parametrize("field", [{"debug_nans": True},
                                   {"profile_dir": "trace"}])
def test_trainer_refuses_fields_it_does_not_honour(data, tmp_path, field):
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        _trainer(_cfg(tmp_path, **field), data)
