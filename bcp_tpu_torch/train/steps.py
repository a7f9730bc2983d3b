"""The LA, ACDC and pancreas train steps: ``bcp_tpu/train/steps.py`` for the
port.

``pretrain_step`` is the labelled copy-paste update (`steps.py:170-222`,
`LA_BCP_train.py:145-170`, `ACDC_BCP_train.py:237-255`,
`train_pancreas.py:80-99`); ``selftrain_step`` the bidirectional
copy-paste mean-teacher update on the fused-sub-batch path
(`steps.py:228-341`, `LA_BCP_train.py:234-270`,
`ACDC_BCP_train.py:354-390`, `train_pancreas.py:146-174`): the teacher's
pseudo-labels (:func:`pseudo_labels`: the teacher's forward and threshold
or argmax, :func:`teacher_masks`, then the NMS, :func:`clean_masks`), then
the student's update (:func:`selftrain_update`), which a caller may also
run on pseudo-labels of its own (``train.graphs`` captures the teacher's
part and the update as two CUDA graphs around the NMS). ``cfg.variant``
picks the pipeline's losses, mix order and pseudo-label rule;
``cfg.ema_full_state`` (ACDC) makes the EMA move the teacher's BN running
statistics too.

``cfg.fuse_subbatches`` is honoured by one route: each network runs
once a step on the two sub-batches concatenated (`steps.py:267-303`),
its BatchNorms in :func:`concat_groups` groups. The JAX package's
``_grouped`` (`steps.py:71-80`) gives the concat forward two groups only
for a net with a ``bn_groups`` field (the V-Nets and the 2-D U-Net, whose
port classes set ``grouped``); a zoo net normalises the concat batch as
one. The reference's other route (``False``: two forwards a network, one
a sub-batch, the student's running statistics threaded from the first
into the second, `steps.py:267-289,298-311`) computes what two groups
compute, for any net: grouped BN normalises each sub-batch by its own
statistics and folds the groups' running-stat updates in order, counting
one ``num_batches_tracked`` a group, as two forwards do; a model without
BatchNorm (pancreas' instance-norm V-Net) has nothing to thread.
``tests/test_torch_steps.py`` holds the two routes together in f64 to
1e-10, and the port's step against the JAX package's two-forward step.
Only the order of the dropout draws differs, and the port's draws come
from torch generators, never the JAX package's keys.

The losses take a net's logits by the JAX package's rule
(``layers.logits_of``, `steps.py:43-45`): the first element of a tuple
(a dual-task net's tanh head among them), else the bare tensor.

In a world of several ranks (``parallel.mesh``) each rank runs the step
on its rows of the global batch: the BatchNorm statistics (the teacher's
included) and the losses are the global batch's, the update all-reduces
the gradients once between ``backward`` and the optimizer step, and the
returned losses are the global ones, as the JAX package's step on the
sharded batch computes them. Under a space split a rank's batch holds x
slabs of its rows; the copy-paste mask comes whole (every rank draws the
same one) and each step keeps its slab before the mix, and the NMS, a
property of the whole volume, runs on the masks gathered over the space
group (:func:`clean_masks`).

Batches are dicts of tensors on the device: ``img_a``, ``img_b``,
``uimg_a``, ``uimg_b`` (N, 1, *S) and ``lab_a``, ``lab_b`` (N, *S) integer.
The random draws come from the caller: the copy-paste ``mask``
(``ops.masks``; ``train.trainer.copy_paste_mask``) and, per forward, the
dropout's draws: None (the dropouts' own generator), a
``torch.Generator`` or the keep masks, one bool tensor per dropout in
forward order (``layers.dropout_draws``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.models.layers import (bn_groups, dropout_draws,
                                         frozen_running_stats, logits_of)
from bcp_tpu_torch.ops import cc, losses
from bcp_tpu_torch.ops.ema import ema_update
from bcp_tpu_torch.ops.masks import mix
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train.state import TrainState, lr_at
from bcp_tpu_torch.utils.spans import span


def _draws(model, dropout):
    if dropout is None:
        return contextlib.nullcontext()
    if isinstance(dropout, torch.Generator):
        return dropout_draws(model, generator=dropout)
    return dropout_draws(model, keep=dropout)


def concat_groups(model, cfg: Config) -> int:
    """The BatchNorm groups of a self-train concat forward of two
    sub-batches: two for a net whose JAX counterpart has a ``bn_groups``
    field (``grouped``: the V-Nets and the 2-D U-Net; `_grouped`,
    `steps.py:71-80`) or with ``fuse_subbatches`` off (the JAX package's
    two forwards), else one. The dropouts draw for two sub-batches
    either way (``layers.bn_groups``)."""
    return 2 if getattr(model, "grouped", False) \
        or not cfg.fuse_subbatches else 1


def _check(cfg: Config) -> None:
    if cfg.variant not in ("la", "acdc", "pancreas"):
        raise ValueError(f"unknown variant {cfg.variant!r}")


def _update(state: TrainState, loss: torch.Tensor, cfg: Config,
            stage: str) -> None:
    """backward, then one optimizer step at this step's learning rate."""
    opt = state.optimizer
    for group in opt.param_groups:
        group["lr"] = lr_at(cfg, stage, state.step)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    for p in state.model.parameters():
        if p.grad is None:
            # a parameter the loss does not reach (a dual-task net's second
            # head, the contrastive heads): optax decays it and traces its
            # momentum from a zero gradient, where torch would skip it
            p.grad = torch.zeros_like(p)
    # in a world of several ranks every rank's loss is the global loss and
    # its gradient this rank's share: the sum is the global gradient
    mesh.all_reduce_grads(state.model.parameters())
    opt.step()
    state.step += 1


def pretrain_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  mask: torch.Tensor, cfg: Config,
                  dropout=None) -> Dict[str, torch.Tensor]:
    """One labelled update: (CE + Dice) / 2 of the student on the mixed
    labelled pair (`steps.py:174-207`); LA's and pancreas' on the mixed
    label, ACDC's the mix loss of both labels with weights 1. Returns the
    losses (device scalars), and for pancreas ``train_dice``: the class-1
    probability >= 0.5 against the mixed label, a global Dice with 1e-6
    smoothing, in f32 (`steps.py:195-207`)."""
    _check(cfg)
    model = state.model
    mask = mesh.shard_space(mask, 0)
    img = mix(batch["img_a"], batch["img_b"], mask)
    with _draws(model, dropout):
        logits = logits_of(model(img))
    lab_a, lab_b = batch["lab_a"].long(), batch["lab_b"].long()
    if cfg.variant == "acdc":
        # `steps.py:178-188`: both weights 1.0
        dice, ce = losses.mix_loss_slice(
            logits, lab_a, lab_b, mask[None].expand(lab_a.shape),
            cfg.num_classes, u_weight=1.0, unlab=True)
    else:
        lab = mix(lab_a, lab_b, mask)
        ce = losses.cross_entropy_mean(logits, lab)
        dice = losses.masked_dice_loss(logits, lab)
    loss = (ce + dice) / 2.0
    out = {"loss": loss.detach(), "loss_dice": dice.detach(),
           "loss_ce": ce.detach()}
    if cfg.variant == "pancreas":
        with torch.no_grad():
            pred = (torch.softmax(logits.float(), dim=1)[:, 1]
                    >= 0.5).float()
            labf = lab.float()
            inter, p_sum, l_sum = (pred * labf).sum(), pred.sum(), labf.sum()
            if mesh.active():
                inter, p_sum, l_sum = mesh.sum_ranks(
                    torch.stack([inter, p_sum, l_sum])).unbind(0)
            out["train_dice"] = 2.0 * inter / (p_sum + l_sum + 1e-6)
    _update(state, loss, cfg, "pre")
    return out


@torch.no_grad()
def teacher_masks(state: TrainState, batch: Dict[str, torch.Tensor],
                  cfg: Config, dropout=None) -> torch.Tensor:
    """The teacher's masks of concat(uimg_a, uimg_b) before the NMS: one
    forward in train mode with live dropout and :func:`concat_groups`
    BatchNorm groups, whose running-stat updates are discarded
    (`steps.py:63-68,298-303`), then the mask of ``cfg.pseudo_label``
    (`steps.py:101-106`): class 1's probability thresholded at 0.5
    (``"binary"``, LA, pancreas) or the argmax (``"argmax"``, ACDC);
    int32."""
    _check(cfg)
    teacher = state.teacher
    x = torch.cat([batch["uimg_a"], batch["uimg_b"]])
    with bn_groups(teacher, 2, concat_groups(teacher, cfg)), \
            frozen_running_stats(teacher), _draws(teacher, dropout):
        logits = logits_of(teacher(x))
    if cfg.pseudo_label == "argmax":
        return cc.get_multiclass_mask(logits, cfg.num_classes)
    return cc.get_cut_mask(logits)


def clean_masks(masks: torch.Tensor, cfg: Config) -> torch.Tensor:
    """With ``cfg.nms`` each sample's largest component (``"binary"``) or
    each class's (``"argmax"``) of :func:`teacher_masks`; else the masks.
    The NMS reads a flag back every round (``ops.cc``), so a CUDA graph
    step runs it between its two graphs. Under a space split the largest
    component is the whole volume's: the slabs are gathered over the space
    group, cleaned whole on each of its ranks, and each keeps its slab."""
    if not cfg.nms:
        return masks
    with span("step.nms"):
        whole = mesh.gather_space(masks, 1)
        if cfg.pseudo_label == "argmax":
            whole = cc.largest_cc_per_class(whole, cfg.num_classes,
                                            cfg.cc_connectivity)
        else:
            whole = cc.largest_cc_batch(whole, cfg.cc_connectivity)
        return mesh.shard_space(whole, 1)


def pseudo_labels(state: TrainState, batch: Dict[str, torch.Tensor],
                  cfg: Config, dropout=None) -> torch.Tensor:
    """The teacher's pseudo-labels of concat(uimg_a, uimg_b):
    :func:`teacher_masks` cleaned by :func:`clean_masks`, the thresholded,
    largest-CC-cleaned class 1 (LA, pancreas) or the argmax cleaned class
    by class (ACDC)."""
    with torch.no_grad():
        with span("step.teacher"):
            masks = teacher_masks(state, batch, cfg, dropout)
        return clean_masks(masks, cfg)


def mixed_inputs(variant: str, batch: Dict[str, torch.Tensor],
                 mask: torch.Tensor):
    """The two bidirectionally mixed student inputs (`steps.py:115-126`):
    LA mix(a, ua), mix(ub, b); ACDC mix(ua, a), mix(b, ub); pancreas
    mix(ua, b), mix(a, ub) (`train_pancreas.py:152-154`)."""
    a, b = batch["img_a"], batch["img_b"]
    ua, ub = batch["uimg_a"], batch["uimg_b"]
    if variant == "acdc":
        return mix(ua, a, mask), mix(b, ub, mask)
    if variant == "pancreas":
        return mix(ua, b, mask), mix(a, ub, mask)
    return mix(a, ua, mask), mix(ub, b, mask)


def selftrain_update(state: TrainState, batch: Dict[str, torch.Tensor],
                     plab: torch.Tensor, mask: torch.Tensor, cfg: Config,
                     dropout=None) -> Dict[str, torch.Tensor]:
    """The student's update on the pseudo-labels ``plab`` (concat of the
    two unlabelled sub-batches'): the bidirectional mix
    (:func:`mixed_inputs`), one concat forward (:func:`concat_groups`), the
    two mix losses (`steps.py:233-253`), backward, the optimizer step,
    then the EMA of the teacher from the new student
    (`steps.py:323-334`)."""
    _check(cfg)
    model = state.model
    mask = mesh.shard_space(mask, 0)
    usub = batch["uimg_a"].shape[0]
    plab = plab.long()
    plab_a, plab_b = plab[:usub], plab[usub:]
    lab_a, lab_b = batch["lab_a"].long(), batch["lab_b"].long()
    in1, in2 = mixed_inputs(cfg.variant, batch, mask)
    n = in1.shape[0]
    with bn_groups(model, 2, concat_groups(model, cfg)), \
            _draws(model, dropout):
        logits = logits_of(model(torch.cat([in1, in2])))
    lmask = mask[None].expand(lab_a.shape)
    if cfg.variant == "acdc":
        unl_d, unl_c = losses.mix_loss_slice(
            logits[:n], plab_a, lab_a, lmask, cfg.num_classes,
            u_weight=cfg.u_weight, unlab=True)
        l_d, l_c = losses.mix_loss_slice(
            logits[n:], lab_b, plab_b, lmask, cfg.num_classes,
            u_weight=cfg.u_weight)
        loss = ((unl_d + l_d) + (unl_c + l_c)) / 2.0
        parts = {"loss_dice": unl_d + l_d, "loss_ce": unl_c + l_c}
    elif cfg.variant == "pancreas":
        # `steps.py:253-263`, `train_pancreas.py:155-166`
        loss_1 = losses.mix_loss_volume(logits[:n], plab_a, lab_b, lmask,
                                        u_weight=cfg.u_weight, unlab=True)
        loss_2 = losses.mix_loss_volume(logits[n:], lab_a, plab_b, lmask,
                                        u_weight=cfg.u_weight)
        loss = loss_1 + loss_2
        parts = {"loss_l": loss_1, "loss_u": loss_2}
    else:
        loss_l = losses.mix_loss_volume(logits[:n], lab_a, plab_a, lmask,
                                        u_weight=cfg.u_weight)
        loss_u = losses.mix_loss_volume(logits[n:], plab_b, lab_b, lmask,
                                        u_weight=cfg.u_weight, unlab=True)
        loss = loss_l + loss_u
        parts = {"loss_l": loss_l, "loss_u": loss_u}
    _update(state, loss, cfg, "self")
    ema_update(state.teacher, model, cfg.ema_alpha, cfg.ema_full_state)
    return {"loss": loss.detach(),
            **{k: v.detach() for k, v in parts.items()}}


def selftrain_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   mask: torch.Tensor, cfg: Config, teacher_dropout=None,
                   student_dropout=None,
                   before_update: Optional[Callable[[torch.Tensor], None]]
                   = None) -> Dict[str, torch.Tensor]:
    """One self-train update (`make_selftrain_step`, `steps.py:291-339`).
    ``before_update(plab)``, when given, is called with the pseudo-labels
    before the student's update (the trainer's image snapshots)."""
    plab = pseudo_labels(state, batch, cfg, teacher_dropout)
    if before_update is not None:
        before_update(plab)
    with span("step.update"):
        return selftrain_update(state, batch, plab, mask, cfg,
                                student_dropout)
