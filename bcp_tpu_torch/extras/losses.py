"""The reference's dead loss tail for the port: ``bcp_tpu/extras/losses.py``
(`code/utils/losses.py:137-388`).

Channels-first, as the rest of the port: logits and probabilities (N, C,
*S), integer targets (N, *S). The formulas and constants are the JAX
package's: the masked one-hot cross entropy keeps the reference's all-ones
mask of class 0; ``Dice_Loss`` has linear denominators and smooth 1e-5;
``Binary_dice_loss`` puts its epsilon in the numerator too; ``softDiceLoss``
squares its denominators, smooth 1e-10.

VAT's random direction comes in as ``u``, a uniform draw in [0, 1) of x's
shape, which the caller makes (the JAX package draws it from a key): the
direction is ``u - 0.5`` normalised per sample. The power iteration takes
``torch.autograd.grad`` of the perturbed prediction's distance with respect
to the direction, the clean prediction carries no gradient, and with
``model`` given every forward runs under ``frozen_running_stats``, so the
BatchNorms' running statistics stay as they are (the reference's
``_disable_tracking_bn_stats``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from bcp_tpu_torch.models.layers import frozen_running_stats
from bcp_tpu_torch.ops.losses import softmax_probs


def _one_hot(target: torch.Tensor, n: int) -> torch.Tensor:
    """(N, *S) -> (N, n, *S) f32."""
    return F.one_hot(target.long(), n).movedim(-1, 1).float()


def masked_onehot_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """`CrossEntropyLoss.forward` (`losses.py:47-66`): per class c,
    ``sum(-onehot_c * log(p_c) * mask_c) / (sum(mask_c) + 1e-16)`` averaged
    over the classes, class 0's mask all ones (`_one_hot_mask_encoder`:
    ``mask * 0 == 0`` everywhere)."""
    n_classes = logits.shape[1]
    probs = torch.softmax(logits, dim=1)
    onehot = _one_hot(target, n_classes)
    maskf = mask.float()
    loss = 0.0
    for c in range(n_classes):
        m_c = torch.ones_like(maskf) if c == 0 else maskf
        num = (-onehot[:, c] * torch.log(probs[:, c]) * m_c).sum()
        loss = loss + num / (m_c.sum() + 1e-16)
    return loss / n_classes


def dice_loss_weighted_probs(probs: torch.Tensor, target: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             smooth: float = 1e-5) -> torch.Tensor:
    """`Dice_Loss.prob_forward` (`losses.py:96-112`): per (sample, class)
    ``(2 inter + s) / (p_sum + t_sum + s)``, the optional pixel mask on
    both sums, ``1 - mean``."""
    n, c = probs.shape[:2]
    p = probs.reshape(n, c, -1)
    t = _one_hot(target.reshape(n, -1), c).reshape(n, c, -1)
    inter, union = p * t, p + t
    if mask is not None:
        m = mask.reshape(n, 1, -1).float()
        inter, union = inter * m, union * m
    dice = (2.0 * inter.sum(2) + smooth) / (union.sum(2) + smooth)
    return 1.0 - dice.mean()


def dice_loss_weighted(logits: torch.Tensor, target: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       smooth: float = 1e-5) -> torch.Tensor:
    """`Dice_Loss.forward` (`losses.py:69-93`): :func:`dice_loss_weighted_probs`
    of the probabilities (the sigmoid pair when C == 1)."""
    return dice_loss_weighted_probs(softmax_probs(logits), target, mask,
                                    smooth)


def binary_dice_loss(pred: torch.Tensor, target: torch.Tensor,
                     ep: float = 1e-8) -> torch.Tensor:
    """`Binary_dice_loss` (`losses.py:115-121`): global soft dice, the
    epsilon in the numerator too."""
    inter = 2.0 * (pred * target).sum() + ep
    union = pred.sum() + target.sum() + ep
    return 1.0 - inter / union


def soft_dice_loss(probs: torch.Tensor, target: torch.Tensor,
                   smooth: float = 1e-10) -> torch.Tensor:
    """`softDiceLoss.forward` (`losses.py:124-136`): per class (dim 1) dice
    with squared denominators, averaged over the classes."""
    loss = 0.0
    for c in range(probs.shape[1]):
        s, t = probs[:, c], target[:, c].float()
        inter = (s * t).sum()
        denom = (s * s).sum() + (t * t).sum()
        loss = loss + 1.0 - (2.0 * inter + smooth) / (denom + smooth)
    return loss / probs.shape[1]


def _l2_normalize(d: torch.Tensor) -> torch.Tensor:
    """Per-sample L2 normalisation over every non-batch dim
    (`losses.py:139-145`)."""
    norms = d.reshape(d.shape[0], -1).square().sum(1).sqrt()
    return d / (norms.reshape((-1,) + (1,) * (d.dim() - 1)) + 1e-8)


def _vat_loss(forward: Callable[[torch.Tensor], torch.Tensor],
              x: torch.Tensor, u: torch.Tensor, distance: Callable,
              xi: float, epi: float, ip: int,
              model: Optional[torch.nn.Module]) -> torch.Tensor:
    """The VAT power iteration (`losses.py:148-167`) with the direction
    drawn as ``u`` (module docstring)."""
    frozen = (frozen_running_stats(model) if model is not None
              else contextlib.nullcontext())
    with frozen:
        with torch.no_grad():
            pred = torch.softmax(forward(x), dim=1)
        d = _l2_normalize(u.to(x.dtype) - 0.5)
        for _ in range(ip):
            d = d.detach().requires_grad_(True)
            p_hat = torch.softmax(forward(x + xi * d), dim=1)
            grad, = torch.autograd.grad(distance(p_hat, pred), d)
            d = _l2_normalize(grad.detach())
        p_hat = torch.softmax(forward(x + epi * d), dim=1)
    return distance(p_hat, pred)


def vat_loss_2d(forward: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor, u: torch.Tensor, xi: float = 10.0,
                epi: float = 6.0, ip: int = 1, n_classes: int = 4,
                model: Optional[torch.nn.Module] = None) -> torch.Tensor:
    """`VAT2d.forward` (`losses.py:170-180`): the soft dice distance between
    the perturbed and the clean softmax. ``forward(x)`` returns (N, C, ...)
    logits (the reference's ``model(x)[0]``)."""
    del n_classes   # the distance takes the classes from the probabilities
    return _vat_loss(forward, x, u, soft_dice_loss, xi, epi, ip, model)


def vat_loss_3d(forward: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor, u: torch.Tensor, xi: float = 10.0,
                epi: float = 6.0, ip: int = 1,
                model: Optional[torch.nn.Module] = None) -> torch.Tensor:
    """`VAT3d.forward` (`losses.py:183-188`): the same iteration with
    :func:`binary_dice_loss` over the whole probability tensors."""
    return _vat_loss(forward, x, u, binary_dice_loss, xi, epi, ip, model)
