"""The LA and ACDC losses: ``bcp_tpu/ops/losses.py`` :34-168 for the port.

Logits are (N, C, *S) (the JAX package's are channels-last), integer
targets (N, *S). Same smoothing constants and reductions as the reference
(`utils/losses.py:47-77`, `utils/BCP_utils.py:58-69`), in the dtype of the
logits (f32 from the model).

In a world of several ranks (``parallel.mesh``) every reduction is taken
over the global batch, as the JAX package's losses over the sharded batch
are: a mean over samples or voxels is the mean of the ranks' means
(``mesh.mean_ranks``), a ratio of sums divides the sums over the ranks
(``mesh.sum_ranks``, one all-reduce of the stacked sums). Every rank then
holds the global loss, and the gradient reaches each rank's rows
unchanged; ``mesh`` derives why the parameter gradients are then summed
over the ranks.

Under a space split every slab holds an equal share of the voxels, so
the world mean of the ranks' means and the world sums are still the
global batch's; only ``masked_dice_loss``, whose Dice is per sample, sums
its two spatial sums over the space group first (``mesh.sum_space``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bcp_tpu_torch.parallel import mesh


def softmax_probs(logits: torch.Tensor) -> torch.Tensor:
    """Class probabilities; sigmoid expanded to [1-p, p] when C == 1
    (`losses.py:34-42`)."""
    if logits.shape[1] == 1:
        p = torch.sigmoid(logits)
        return torch.cat([1.0 - p, p], dim=1)
    return torch.softmax(logits, dim=1)


def _one_hot(target: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(N, *S) -> (N, n, *S)."""
    return F.one_hot(target.long(), n).movedim(-1, 1).to(dtype)


def masked_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     smooth: float = 1e-5) -> torch.Tensor:
    """`mask_DiceLoss` (`losses.py:52-74`): per-(sample, class) dice over
    the spatial dims, the optional mask on both sums, ``1 - mean``. Under a
    space split the sums are the whole volume's before the ratio."""
    probs = softmax_probs(logits)
    n, c = probs.shape[:2]
    p = probs.reshape(n, c, -1)
    t = _one_hot(target, c, p.dtype).reshape(n, c, -1)
    inter = p * t
    union = p + t
    if mask is not None:
        m = mask.reshape(n, 1, -1).to(p.dtype)
        inter = inter * m
        union = union * m
    inter, union = inter.sum(-1), union.sum(-1)
    if mesh.space_split():
        inter, union = mesh.sum_space(torch.stack([inter, union])).unbind(0)
    dice = (2.0 * inter + smooth) / (union + smooth)
    return 1.0 - mesh.mean_ranks(dice.mean())


def dice_loss_per_class(probs: torch.Tensor, target: torch.Tensor,
                        n_classes: int, mask: Optional[torch.Tensor] = None,
                        smooth: float = 1e-10) -> torch.Tensor:
    """`DiceLoss` (`losses.py:77-99`, `utils/losses.py:79-134`): ``probs``
    already softmaxed (N, C, *S); per class one dice over the batch and
    the spatial dims together, squared terms in the denominator, the
    optional mask on every sum; ``mean(1 - dice)``."""
    t = _one_hot(target, n_classes, probs.dtype)
    red = (0,) + tuple(range(2, probs.dim()))
    pt, tt, pp = probs * t, t * t, probs * probs
    if mask is not None:
        m = mask.unsqueeze(1).to(probs.dtype)
        pt, tt, pp = pt * m, tt * m, pp * m
    pt, pp, tt = pt.sum(red), pp.sum(red), tt.sum(red)
    if mesh.active():
        pt, pp, tt = mesh.sum_ranks(torch.stack([pt, pp, tt])).unbind(0)
    dice = (2.0 * pt + smooth) / (pp + tt + smooth)
    return (1.0 - dice).mean()


def pixel_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-pixel cross entropy (`losses.py:100-105`), (N, *S)."""
    logp = torch.log_softmax(logits, dim=1)
    return -(logp * _one_hot(target, logits.shape[1], logp.dtype)).sum(1)


def masked_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """sum(CE * mask) / (sum(mask) + 1e-16) (`losses.py:108-113`)."""
    ce = pixel_ce(logits, target)
    m = mask.to(ce.dtype)
    num, den = (ce * m).sum(), m.sum()
    if mesh.active():
        num, den = mesh.sum_ranks(torch.stack([num, den])).unbind(0)
    return num / (den + 1e-16)


def cross_entropy_mean(logits: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """Plain mean CE (`losses.py:116-118`)."""
    return mesh.mean_ranks(pixel_ce(logits, target).mean())


def mix_loss_volume(logits: torch.Tensor, img_l: torch.Tensor,
                    patch_l: torch.Tensor, mask: torch.Tensor,
                    l_weight: float = 1.0, u_weight: float = 0.5,
                    unlab: bool = False) -> torch.Tensor:
    """The LA mix loss (`losses.py:121-136`): ``mask == 1`` pixels carry
    ``img_l``; with ``unlab`` the image / patch weights swap."""
    image_w, patch_w = (u_weight, l_weight) if unlab else (l_weight, u_weight)
    patch_mask = 1 - mask
    dice = masked_dice_loss(logits, img_l, mask) * image_w
    dice = dice + masked_dice_loss(logits, patch_l, patch_mask) * patch_w
    ce = image_w * masked_cross_entropy(logits, img_l, mask)
    ce = ce + patch_w * masked_cross_entropy(logits, patch_l, patch_mask)
    return (dice + ce) / 2.0


def mix_loss_slice(logits: torch.Tensor, img_l: torch.Tensor,
                   patch_l: torch.Tensor, mask: torch.Tensor, n_classes: int,
                   l_weight: float = 1.0, u_weight: float = 0.5,
                   unlab: bool = False):
    """The ACDC mix loss (`losses.py:139-152`, `ACDC_BCP_train.py:167-179`):
    ``mask == 1`` pixels carry ``img_l``; with ``unlab`` the image / patch
    weights swap. Returns (dice, ce)."""
    image_w, patch_w = (u_weight, l_weight) if unlab else (l_weight, u_weight)
    patch_mask = 1 - mask
    probs = torch.softmax(logits, dim=1)
    dice = dice_loss_per_class(probs, img_l, n_classes, mask) * image_w
    dice = dice + dice_loss_per_class(probs, patch_l, n_classes,
                                      patch_mask) * patch_w
    ce = image_w * masked_cross_entropy(logits, img_l, mask)
    ce = ce + patch_w * masked_cross_entropy(logits, patch_l, patch_mask)
    return dice, ce


def sup_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(mask_DiceLoss + mean CE) / 2 (`losses.py:155-158`,
    `BCP_utils.py:71-76`)."""
    return (masked_dice_loss(logits, target)
            + cross_entropy_mean(logits, target)) / 2.0


def softmax_mse(input_logits: torch.Tensor,
                target_logits: torch.Tensor) -> torch.Tensor:
    """Element-wise squared difference of the class softmaxes, no
    reduction; no gradient reaches ``target_logits``
    (`losses.py:161-168`, `pancreas/losses.py:114-127`)."""
    a = torch.softmax(input_logits, dim=1)
    b = torch.softmax(target_logits.detach(), dim=1)
    return (a - b) ** 2
