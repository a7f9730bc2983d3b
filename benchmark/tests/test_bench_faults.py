"""Each cell kind's run, driven end to end on the CPU at a tiny size with
the timed path broken underneath, comes out not correct: once for each
fault such a cell can have (one card: no exchange between cards to leave
out), and for a train cell once more with a fault that only the groups
after the first have, as a graph replay's would be."""

from __future__ import annotations

import pytest

from bench_helpers import dry_run

import bcp_tpu_torch.train.graphs as graphs
import bcp_tpu_torch.train.steps as steps
from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator


def _state_unchanged(monkeypatch):
    """The update leaves the parameters as they were (and counts the
    step)."""
    def update(state, loss, cfg, stage):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.step += 1
    monkeypatch.setattr(steps, "_update", update)


def _half_batch(monkeypatch):
    """The mix losses over the first half of each mixed sub-batch, their
    mean taken over it."""
    loss = steps.losses.mix_loss_volume

    def half(logits, img_l, patch_l, mask, **kw):
        h = max(logits.shape[0] // 2, 1)
        return loss(logits[:h], img_l[:h], patch_l[:h], mask[:h], **kw)
    monkeypatch.setattr(steps.losses, "mix_loss_volume", half)


def _pseudo_label_altered(monkeypatch):
    """The NMS hands on the first pseudo-label inverted."""
    clean = steps.clean_masks

    def altered(masks, cfg):
        out = clean(masks, cfg).clone()
        out[0] = 1 - out[0]
        return out
    monkeypatch.setattr(steps, "clean_masks", altered)
    monkeypatch.setattr(graphs, "clean_masks", altered)


def _stale_batch(monkeypatch):
    """From the second group on, every step trains on that group's first
    sub-batch: a feed buffer that the graph replays never see refreshed."""
    run = graphs.DispatchGroups.run
    held = {}

    def stale(self, batch, first_it, before_update=None):
        if first_it > self.K:
            first = held.setdefault("sub", {k: v[:1].clone()
                                            for k, v in batch.items()})
            batch = {k: v.expand(self.K, *v.shape[1:]).clone()
                     for k, v in first.items()}
        return run(self, batch, first_it, before_update)
    monkeypatch.setattr(graphs.DispatchGroups, "run", stale)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _pseudo_label_altered, _stale_batch])
def test_train_fault_is_not_correct(fault, monkeypatch, vnet_root):
    fault(monkeypatch)
    _, line = dry_run("vnet_la.self_k4", root=vnet_root)
    assert not line["correct"], line["checks"]


def _half_windows(monkeypatch):
    """Half of each chunk's windows left out, the mean taken over the
    rest (the count map still counts them all)."""
    chunk = SlidingWindowEvaluator._process_chunk

    def half(self, volume, starts, n_valid, score):
        h = max(len(starts) // 2, 1)
        chunk(self, volume, starts[:h], min(n_valid, h), score)
    monkeypatch.setattr(SlidingWindowEvaluator, "_process_chunk", half)


def _label_altered(monkeypatch):
    """A window's worth of each label map inverted where it is
    produced."""
    fetch = SlidingWindowEvaluator.infer_fetch

    def altered(self, handle):
        label, score = fetch(self, handle)
        label = label.copy()
        px, py, pz = self.patch
        label[:px, :py, :pz] = 1 - label[:px, :py, :pz]
        return label, score
    monkeypatch.setattr(SlidingWindowEvaluator, "infer_fetch", altered)


@pytest.mark.parametrize("fault", [_half_windows, _label_altered])
def test_infer_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    _, line = dry_run("vnet_la.infer")
    assert not line["correct"], line["checks"]
