"""The reference's dead extras for the port (``bcp_tpu/extras``): the
per-class feature memory and class-wise contrastive loss, and the unused
tail of the loss library. No pipeline calls them; they are here so that
the port does what the JAX package does."""

from bcp_tpu_torch.extras.contrastive import (
    ClassSelector,
    FeatureMemory,
    contrastive_class_to_class,
)
from bcp_tpu_torch.extras.losses import (
    binary_dice_loss,
    dice_loss_weighted,
    dice_loss_weighted_probs,
    masked_onehot_cross_entropy,
    soft_dice_loss,
    vat_loss_2d,
    vat_loss_3d,
)

__all__ = [
    "ClassSelector",
    "FeatureMemory",
    "contrastive_class_to_class",
    "binary_dice_loss",
    "dice_loss_weighted",
    "dice_loss_weighted_probs",
    "masked_onehot_cross_entropy",
    "soft_dice_loss",
    "vat_loss_2d",
    "vat_loss_3d",
]
