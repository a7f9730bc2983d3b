"""The LA train steps: ``bcp_tpu/train/steps.py`` for the port.

``pretrain_step`` is the labelled copy-paste update (`steps.py:170-222`,
`LA_BCP_train.py:145-170`); ``selftrain_step`` the bidirectional
copy-paste mean-teacher update on the fused-sub-batch path
(`steps.py:228-341`, `LA_BCP_train.py:234-270`): the teacher's pseudo-labels
(:func:`pseudo_labels`) then the student's update
(:func:`selftrain_update`), which a caller may also run on pseudo-labels of
its own.

Batches are dicts of tensors on the device: ``img_a``, ``img_b``,
``uimg_a``, ``uimg_b`` (N, 1, *S) and ``lab_a``, ``lab_b`` (N, *S) integer.
The random draws come from the caller: the copy-paste ``mask``
(``ops.masks.cuboid_mask``) and, per forward, the dropout's draws: None
(the dropouts' own generator), a ``torch.Generator`` or the keep masks, one
(N, C) bool tensor per dropout in forward order.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.models.layers import (bn_groups, dropout_draws,
                                         frozen_running_stats)
from bcp_tpu_torch.ops import cc, losses
from bcp_tpu_torch.ops.ema import ema_update
from bcp_tpu_torch.ops.masks import mix
from bcp_tpu_torch.train.state import TrainState, lr_at


def _draws(model, dropout):
    if dropout is None:
        return contextlib.nullcontext()
    if isinstance(dropout, torch.Generator):
        return dropout_draws(model, generator=dropout)
    return dropout_draws(model, keep=dropout)


def _check(cfg: Config) -> None:
    if cfg.variant != "la" or not cfg.fuse_subbatches:
        raise NotImplementedError(
            "the port's steps are the LA steps with fused sub-batches")


def _update(state: TrainState, loss: torch.Tensor, cfg: Config,
            stage: str) -> None:
    """backward, then one SGD step at this step's learning rate."""
    opt = state.optimizer
    for group in opt.param_groups:
        group["lr"] = lr_at(cfg, stage, state.step)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    state.step += 1


def pretrain_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  mask: torch.Tensor, cfg: Config,
                  dropout=None) -> Dict[str, torch.Tensor]:
    """One labelled update: CE + Dice of the student on the mixed labelled
    pair (`steps.py:174-207`). Returns the losses (device scalars)."""
    _check(cfg)
    model = state.model
    img = mix(batch["img_a"], batch["img_b"], mask)
    lab = mix(batch["lab_a"].long(), batch["lab_b"].long(), mask)
    with _draws(model, dropout):
        logits = model(img)[0]
    ce = losses.cross_entropy_mean(logits, lab)
    dice = losses.masked_dice_loss(logits, lab)
    loss = (ce + dice) / 2.0
    _update(state, loss, cfg, "pre")
    return {"loss": loss.detach(), "loss_dice": dice.detach(),
            "loss_ce": ce.detach()}


@torch.no_grad()
def pseudo_labels(state: TrainState, batch: Dict[str, torch.Tensor],
                  cfg: Config, dropout=None) -> torch.Tensor:
    """The teacher's pseudo-labels of concat(uimg_a, uimg_b): one forward in
    train mode with live dropout and 2-group BatchNorm whose running-stat
    updates are discarded (`steps.py:63-68,298-303`), then the thresholded,
    largest-CC-cleaned mask (`get_cut_mask`)."""
    _check(cfg)
    teacher = state.teacher
    x = torch.cat([batch["uimg_a"], batch["uimg_b"]])
    with bn_groups(teacher, 2), frozen_running_stats(teacher), \
            _draws(teacher, dropout):
        logits = teacher(x)[0]
    return cc.get_cut_mask(logits, nms=cfg.nms,
                           connectivity=cfg.cc_connectivity)


def selftrain_update(state: TrainState, batch: Dict[str, torch.Tensor],
                     plab: torch.Tensor, mask: torch.Tensor, cfg: Config,
                     dropout=None) -> Dict[str, torch.Tensor]:
    """The student's update on the pseudo-labels ``plab`` (concat of the
    two unlabelled sub-batches'): the bidirectional mix
    (`mixed_inputs`, `steps.py:115-126`), one concat forward with 2-group
    BatchNorm, the two mix losses (`steps.py:233-243`), backward, SGD, then
    the EMA of the teacher's parameters from the new student
    (`steps.py:323-334`)."""
    _check(cfg)
    model = state.model
    usub = batch["uimg_a"].shape[0]
    plab = plab.long()
    plab_a, plab_b = plab[:usub], plab[usub:]
    lab_a, lab_b = batch["lab_a"].long(), batch["lab_b"].long()
    in1 = mix(batch["img_a"], batch["uimg_a"], mask)
    in2 = mix(batch["uimg_b"], batch["img_b"], mask)
    n = in1.shape[0]
    with bn_groups(model, 2), _draws(model, dropout):
        logits = model(torch.cat([in1, in2]))[0]
    lmask = mask[None].expand(lab_a.shape)
    loss_l = losses.mix_loss_volume(logits[:n], lab_a, plab_a, lmask,
                                    u_weight=cfg.u_weight)
    loss_u = losses.mix_loss_volume(logits[n:], plab_b, lab_b, lmask,
                                    u_weight=cfg.u_weight, unlab=True)
    loss = loss_l + loss_u
    _update(state, loss, cfg, "self")
    ema_update(state.teacher, model, cfg.ema_alpha)
    return {"loss": loss.detach(), "loss_l": loss_l.detach(),
            "loss_u": loss_u.detach()}


def selftrain_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   mask: torch.Tensor, cfg: Config, teacher_dropout=None,
                   student_dropout=None) -> Dict[str, torch.Tensor]:
    """One self-train update (`make_selftrain_step`, `steps.py:291-339`)."""
    plab = pseudo_labels(state, batch, cfg, teacher_dropout)
    return selftrain_update(state, batch, plab, mask, cfg, student_dropout)
