"""Largest-connected-component NMS of the pseudo-labels, on the device.

Counterpart of ``bcp_tpu/ops/cc.py`` (`get_cut_mask` :288,
`largest_cc_batch` :238, `connected_components` :97-170,
`largest_cc_per_class` :271, `get_multiclass_mask` :302), for batches of
2-D or 3-D masks: every foreground pixel is seeded with ``1 + its flat
index``; the largest label is spread through the foreground by
neighbour-max sweeps (``max_pool2d`` / ``max_pool3d`` with the
connectivity's boxes) and pointer jumps (``lab <- lab.flat[lab - 1]``:
every label names a pixel of its own component, so a jump only moves a
larger label of the same component), until a round changes nothing. Then
each component carries its largest seed. The largest component is the
most frequent positive label, size ties going to the lowest label
(``torch.argmax`` takes the first maximum), which is what the JAX
package's ``_mode_by_sort`` picks (`cc.py:173-190`); empty masks pass
through unchanged. Labels are held in f32, exact below 2^24 pixels per
sample. The fixpoint test reads one flag back to the host every round, so
the per-class NMS of ACDC runs every class of every sample as one batch;
each round is an ``nms.round`` span (``utils.spans``), so their count is
the rounds run.
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch
import torch.nn.functional as F

from bcp_tpu_torch.utils.spans import span

#: neighbour-max sweeps and pointer jumps per round between fixpoint tests
SWEEPS = 8
JUMPS = 2


def _neighbor_max(lab: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Max over the connectivity neighbourhood, self included, of (N, *S)
    labels, S of rank 2 or 3; skimage's convention: neighbours differ in
    at most ``connectivity`` axes."""
    nd = lab.dim() - 1
    pool = F.max_pool2d if nd == 2 else F.max_pool3d
    x = lab[:, None]
    if connectivity >= nd:
        return pool(x, 3, 1, 1)[:, 0]
    out = x
    for axes in itertools.combinations(range(nd), connectivity):
        k = tuple(3 if a in axes else 1 for a in range(nd))
        p = tuple(1 if a in axes else 0 for a in range(nd))
        out = torch.maximum(out, pool(x, k, 1, p))
    return out[:, 0]


def connected_components(masks: torch.Tensor,
                         connectivity: Optional[int] = None) -> torch.Tensor:
    """Labels (f32) of the components of each 2-D or 3-D mask of a batch:
    0 on the background, each component its largest ``1 + flat index``.
    ``None`` is full connectivity of the mask's rank (skimage's default)."""
    if connectivity is None:
        connectivity = masks.dim() - 1
    fg = masks > 0
    n = masks[0].numel()
    if n >= 1 << 24:
        raise ValueError(f"{n} voxels per sample: f32 labels are exact "
                         f"below 2^24")
    seeds = torch.arange(1, n + 1, device=masks.device,
                         dtype=torch.float32).view(masks.shape[1:])
    zero = torch.zeros((), device=masks.device)
    lab = torch.where(fg, seeds, zero)
    offsets = (torch.arange(masks.shape[0], device=masks.device) * n).view(
        -1, 1)
    while True:
        with span("nms.round"):
            prev = lab
            for _ in range(SWEEPS):
                lab = torch.where(fg, _neighbor_max(lab, connectivity), zero)
            flat = lab.reshape(masks.shape[0], -1)
            for _ in range(JUMPS):
                parent = (flat.long() - 1).clamp(min=0) + offsets
                flat = torch.where(fg.reshape(flat.shape),
                                   flat.reshape(-1)[parent], zero)
            lab = flat.view(lab.shape)
            if not bool((lab != prev).any()):
                return lab


def largest_cc_batch(masks: torch.Tensor,
                     connectivity: Optional[int] = None) -> torch.Tensor:
    """Keep each sample's largest component (`cc.py:238-268`); int32."""
    B = masks.shape[0]
    labels = connected_components(masks, connectivity).long()
    n = labels[0].numel()
    flat = labels.reshape(B, -1)
    counts = torch.bincount((flat + torch.arange(B, device=flat.device)
                             .view(-1, 1) * (n + 1)).reshape(-1),
                            minlength=B * (n + 1)).view(B, n + 1)
    counts[:, 0] = 0
    best = counts.argmax(dim=1).view(-1, *(1,) * (labels.dim() - 1))
    return ((labels == best) & (labels > 0)).to(torch.int32)


def get_cut_mask(logits: torch.Tensor, thres: float = 0.5, nms: bool = False,
                 connectivity: Optional[int] = None) -> torch.Tensor:
    """Binary pseudo-label (N, *S) int32 from (N, 2, *S) logits: softmax
    class-1 probability >= thres, optionally largest-CC cleaned
    (`cc.py:288-299`)."""
    probs = torch.softmax(logits, dim=1)
    masks = (probs[:, 1] >= thres).to(torch.int32)
    if nms:
        masks = largest_cc_batch(masks, connectivity)
    return masks


def largest_cc_per_class(seg: torch.Tensor, n_classes: int,
                         connectivity: Optional[int] = None) -> torch.Tensor:
    """Each class 1..n_classes-1 of each (H, W) map of ``seg`` (N, H, W)
    kept to its largest component, the maps summed back (`cc.py:271-285`,
    `get_ACDC_2DLargestCC`); int32. Every (sample, class) mask goes through
    one batched :func:`largest_cc_batch`, so the fixpoint's flag is read
    once a round for all of them."""
    classes = torch.arange(1, n_classes, device=seg.device, dtype=seg.dtype)
    shape = (1, -1) + (1,) * (seg.dim() - 1)
    binary = (seg[:, None] == classes.view(shape)).to(torch.int32)
    keep = largest_cc_batch(binary.reshape(-1, *seg.shape[1:]),
                            connectivity).view(binary.shape)
    return (keep * classes.view(shape).to(torch.int32)).sum(1,
                                                            dtype=torch.int32)


def get_multiclass_mask(logits: torch.Tensor, n_classes: int,
                        nms: bool = False,
                        connectivity: Optional[int] = None) -> torch.Tensor:
    """Argmax pseudo-label (N, *S) int32 from (N, C, *S) logits, optionally
    cleaned class by class (`cc.py:302-311`, `get_ACDC_masks`)."""
    seg = torch.argmax(torch.softmax(logits, dim=1), dim=1).to(torch.int32)
    if nms:
        seg = largest_cc_per_class(seg, n_classes, connectivity)
    return seg
