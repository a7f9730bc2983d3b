"""TensorBoard image snapshots, the reference's training panels:
``bcp_tpu/train/snapshots.py`` for the port.

Three surfaces, tag for tag:

- LA self-train (`LA_BCP_train.py:294-340`), at ``iter % eval_every ==
  1``: ``Epoch_{e}_Iter_{i}_labeled`` / ``_unlabel`` grids, each (D, 3,
  3H + 3w, W + w): per z-slice, the mixed input (min-max normalised), the
  mixed target and the student's class-1 probability, with white
  separators of width 2 (:func:`make_la_snapshot`,
  :func:`la_snapshot_grid`).
- ACDC pre-train (`ACDC_BCP_train.py:265-271`), every 20 iterations:
  ``pre_train/Mixed_Image`` / ``Mixed_Prediction`` (argmax x 50) /
  ``Mixed_GroundTruth`` (label x 50) of sample 1.
- ACDC self-train (`ACDC_BCP_train.py:399-413`), every 20 iterations: the
  same triple for both mixed streams, ``train/Un_*`` and ``train/L_*``;
  the ground truth mixes the unlabelled slices' true labels
  (`ACDC_BCP_train.py:368-369`), which the feed ships as ``ulab_a`` /
  ``ulab_b`` when snapshots are on (:func:`make_acdc_snapshot`).

The panels show what the step consumed: the JAX package recomputes the
step's mask and teacher forward from the step's key in a program of its
own; here the trainer hands in the step's own mask and, for LA, the
pseudo-labels its teacher and NMS made, before the student's update. The
prediction comes from an eval-mode forward of the pre-update student, as
in the JAX package, where the reference reuses its train-mode forward
(live dropout): the one documented delta (`snapshots.py:27-33`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.models.layers import logits_of
from bcp_tpu_torch.ops.masks import mix
from bcp_tpu_torch.train.state import TrainState
from bcp_tpu_torch.train.steps import mixed_inputs

INS_WIDTH = 2   # separator width (`LA_BCP_train.py:295`)


@torch.no_grad()
def eval_logits(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``model``'s eval-mode logits of ``x`` (BatchNorm on its running
    statistics, no dropout); the model goes back to train mode."""
    model.eval()
    try:
        return logits_of(model(x))
    finally:
        model.train()


@torch.no_grad()
def make_la_snapshot(state: TrainState, batch: Dict[str, torch.Tensor],
                     mask: torch.Tensor, plab: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """``{mixl,mixu}_{img,lab,prob}`` (`snapshots.py:59-103`): sample 0 of
    each mixed stream, its mixed target (labels and pseudo-labels ``plab``,
    the concat of both unlabelled sub-batches') and the pre-update
    student's class-1 softmax; (H, W, D) f32 tensors on the batch's
    device."""
    usub = batch["uimg_a"].shape[0]
    plab = plab.long()
    lab_a, lab_b = batch["lab_a"].long(), batch["lab_b"].long()
    in1, in2 = mixed_inputs("la", batch, mask)
    out = {}
    for tag, img, lab in (("mixl", in1, mix(lab_a, plab[:usub], mask)),
                          ("mixu", in2, mix(plab[usub:], lab_b, mask))):
        logits = eval_logits(state.model, img[:1])
        out[f"{tag}_img"] = img[0, 0].float()
        out[f"{tag}_lab"] = lab[0].float()
        out[f"{tag}_prob"] = torch.softmax(logits.float(), dim=1)[0, 1]
    return out


def la_snapshot_grid(img: np.ndarray, lab: np.ndarray,
                     prob: np.ndarray) -> np.ndarray:
    """One (D, 3, 3H + 3w, W + w) grid from (H, W, D) panels
    (`LA_BCP_train.py:296-321`): rows the min-max-normalised input, the
    target and the class-1 probability, grey replicated to RGB, white
    separators."""
    H, W, D = img.shape
    w = INS_WIDTH
    g = np.zeros((D, 3, 3 * H + 3 * w, W + w), np.float32)
    g[:, :, H:H + w, :] = 1.0
    g[:, :, 2 * H + w:2 * H + 2 * w, :] = 1.0
    g[:, :, 3 * H + 2 * w:3 * H + 3 * w, :] = 1.0
    g[:, :, :, W:W + w] = 1.0
    rng = img.max() - img.min()
    rows = [(img - img.min()) / (rng if rng > 0 else 1.0), lab, prob]
    for r, panel in enumerate(rows):
        block = panel.transpose(2, 0, 1)        # z first, as permute(2,0,1)
        g[:, :, r * (H + w):r * (H + w) + H, :W] = block[:, None]
    return g


@torch.no_grad()
def make_acdc_snapshot(state: TrainState, batch: Dict[str, torch.Tensor],
                       mask: torch.Tensor, cfg: Config, stage: str,
                       ulab_a: Optional[torch.Tensor] = None,
                       ulab_b: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """ACDC's panels under the reference's tags (`snapshots.py:106-162`),
    sample 1 (0 when a sub-batch holds one): pre-train the mixed labelled
    image, the pre-update student's argmax x 50 and the mixed label x 50;
    self-train the same for both mixed streams, their ground truth mixed
    from the labels and the unlabelled slices' true labels ``ulab_a`` /
    ``ulab_b``. Images in the compute dtype, labels int64, (H, W)."""
    s = 1 if cfg.labeled_sub_bs > 1 else 0
    lab_a, lab_b = batch["lab_a"].long(), batch["lab_b"].long()
    if stage == "pre":
        streams = (("pre_train/Mixed_", mix(batch["img_a"], batch["img_b"],
                                            mask),
                    mix(lab_a, lab_b, mask)),)
    else:
        in_unl, in_l = mixed_inputs("acdc", batch, mask)
        streams = (("train/Un_", in_unl, mix(ulab_a.long(), lab_a, mask)),
                   ("train/L_", in_l, mix(lab_b, ulab_b.long(), mask)))
    out = {}
    for prefix, img, lab in streams:
        pred = eval_logits(state.model, img[s:s + 1]).argmax(dim=1)[0]
        out[prefix + "Image"] = img[s, 0]
        out[prefix + "Prediction"] = pred * 50
        out[prefix + "GroundTruth"] = lab[s] * 50
    return out
