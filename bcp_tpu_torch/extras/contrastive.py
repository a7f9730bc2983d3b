"""Class-wise feature memory and contrastive loss for the port:
``bcp_tpu/extras/contrastive.py`` (reference `utils/feature_memory.py:9-54`,
`utils/contrastive_losses.py:8-69`; imported by the reference's trainers,
never called).

:class:`ClassSelector` is the per-class ranking MLP with flax's own
BatchNorm (``layers.FlaxBatchNorm``: momentum 0.99, the biased batch
variance, eps 1e-5), its modules named as flax names them (``Dense_0``,
``BatchNorm_0``, ``Dense_1``). The memory is a list of numpy arrays on the
host.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bcp_tpu_torch.models.layers import FlaxBatchNorm


class ClassSelector(nn.Module):
    """`ClassSelector` (`contrastive.py:21-31`, `networks/VNet.py:262-268`):
    Linear, BatchNorm, LeakyReLU(0.2), Linear(1)."""

    def __init__(self, dim_in: int, feat_dim: int = 32):
        super().__init__()
        self.Dense_0 = nn.Linear(dim_in, feat_dim)
        self.BatchNorm_0 = FlaxBatchNorm(feat_dim)
        self.Dense_1 = nn.Linear(feat_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.leaky_relu(self.BatchNorm_0(self.Dense_0(x)),
                                         0.2))


class FeatureMemory:
    """The per-class bank of the best-ranked features
    (`contrastive.py:34-59`): at most ``elements_per_class`` feature rows a
    class, those the class selector scores lowest."""

    def __init__(self, elements_per_class: int = 32, n_classes: int = 2):
        self.elements_per_class = elements_per_class
        self.n_classes = n_classes
        self.memory: List[Optional[np.ndarray]] = [None] * n_classes

    @torch.no_grad()
    def add_features(self, selector_fns: Dict[int, Callable],
                     features: torch.Tensor, class_labels) -> None:
        """features (N, F) rows; class_labels (N,)."""
        feats = features.detach().cpu().numpy()
        labels = np.asarray(class_labels.cpu() if isinstance(
            class_labels, torch.Tensor) else class_labels)
        k = self.elements_per_class
        for c in range(self.n_classes):
            feats_c = feats[labels == c]
            if feats_c.shape[0] == 0:
                continue
            if feats_c.shape[0] > k:
                rank = torch.sigmoid(selector_fns[c](
                    torch.from_numpy(feats_c))).numpy()
                feats_c = feats_c[np.argsort(rank[:, 0])][:k]
            self.memory[c] = feats_c


def contrastive_class_to_class(selector_fns: Dict[int, Callable],
                               memory_selector_fns: Dict[int, Callable],
                               features: torch.Tensor,
                               class_labels: torch.Tensor, num_classes: int,
                               memory: List[Optional[np.ndarray]]
                               ) -> torch.Tensor:
    """`contrastive_class_to_class_learned_memory` (`contrastive.py:62-94`):
    the cosine distance of each class's features to its memory bank,
    weighted by the two selectors' scores, averaged over the classes."""
    loss = features.new_zeros(())
    for c in range(num_classes):
        mem = memory[c]
        feats_c = features[class_labels == c]
        if mem is None or feats_c.shape[0] <= 1 or mem.shape[0] <= 1:
            continue
        mem = torch.as_tensor(mem, dtype=features.dtype,
                              device=features.device)
        mem_n = mem / (mem.norm(dim=1, keepdim=True) + 1e-12)
        f_n = feats_c / (feats_c.norm(dim=1, keepdim=True) + 1e-12)
        distances = 1.0 - f_n @ mem_n.T                     # (M, N)
        w_f = torch.sigmoid(selector_fns[c](feats_c.detach()))   # (M, 1)
        w_f = (w_f.shape[0] / w_f.sum(0)) * w_f
        distances = distances * w_f
        w_m = torch.sigmoid(memory_selector_fns[c](mem)).T       # (1, N)
        w_m = (w_m.shape[1] / w_m.sum(1, keepdim=True)) * w_m
        distances = distances * w_m
        loss = loss + distances.mean()
    return loss / num_classes
