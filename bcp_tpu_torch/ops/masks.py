"""Copy-paste masks: ``bcp_tpu/ops/masks.py`` for the port.

Polarity as in the reference (`BCP_utils.py:26`): ``mask == 0`` marks the
pasted patch, ``mask == 1`` the kept image; the mixed input is
``a * mask + b * (1 - mask)``. A mask is 0 inside one or more boxes, each
a (starts, sizes) pair of host integers: the start offsets are drawn from
a numpy generator (:func:`cuboid_starts`, :func:`fixed_starts`,
:func:`grid_starts`, :func:`slab_start`) or handed in by the caller (the
tests hand in the JAX package's draws). One box is built on the mask's
device from ``arange`` comparisons and needs no copy from the host; the
27 boxes of a 3-D grid are painted on the host and copied once
(:func:`boxes_mask`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


#: one box: its start offsets and sizes, one int a dim
Box = Tuple[Sequence[int], Sequence[int]]


def box_mask(spatial: Sequence[int], starts: Sequence[int],
             sizes: Sequence[int], device=None) -> torch.Tensor:
    """int32 mask of shape ``spatial``: 0 inside the box [start, start+size)
    per dim, 1 outside (`masks.py:31-39`)."""
    inside = torch.ones(tuple(spatial), dtype=torch.bool, device=device)
    for d, (dim, start, size) in enumerate(zip(spatial, starts, sizes)):
        coords = torch.arange(dim, device=device)
        in_d = (coords >= int(start)) & (coords < int(start) + int(size))
        shape = [1] * len(spatial)
        shape[d] = dim
        inside = inside & in_d.view(shape)
    return (~inside).to(torch.int32)


def cuboid_sizes(spatial: Sequence[int], ratio: float = 2.0 / 3.0
                 ) -> Tuple[int, ...]:
    """The patch spans ``int(dim * ratio)`` per dim (`masks.py:53-54`)."""
    return tuple(int(int(s) * ratio) for s in spatial)


def cuboid_starts(rng: np.random.Generator, spatial: Sequence[int],
                  ratio: float = 2.0 / 3.0) -> Tuple[int, ...]:
    """Start offsets uniform in [0, dim - size) per dim (`masks.py:55-59`),
    from a numpy generator."""
    return tuple(int(rng.integers(0, int(dim) - size))
                 for dim, size in zip(spatial, cuboid_sizes(spatial, ratio)))


def cuboid_mask(spatial: Sequence[int], starts: Sequence[int],
                ratio: float = 2.0 / 3.0, device=None) -> torch.Tensor:
    """The single zero-cuboid copy-paste mask of ``context_mask``
    (`masks.py:42-60`) at the given start offsets."""
    return box_mask(spatial, starts, cuboid_sizes(spatial, ratio), device)


def fixed_starts(rng: np.random.Generator, spatial: Sequence[int],
                 patch: int) -> Tuple[int, ...]:
    """Start offsets of the pancreas cube, uniform in [0, dim - patch) per
    dim (`masks.py:63-78`; the reference's ``np.random.randint``), from a
    numpy generator."""
    return tuple(int(rng.integers(0, int(dim) - int(patch)))
                 for dim in spatial)


def cuboid_mask_fixed(spatial: Sequence[int], starts: Sequence[int],
                      patch: int, device=None) -> torch.Tensor:
    """The pancreas copy-paste mask, ``cuboid_mask_fixed``
    (`masks.py:63-78`, `pancreas_utils.py:187-200`): a ``patch``^3 cube of
    zeros at the given start offsets."""
    return box_mask(spatial, starts, (int(patch),) * len(spatial), device)


def _randint(rng: np.random.Generator, lo: int, hi: int) -> int:
    """Uniform in [lo, hi); ``lo`` when the range is empty, as
    ``jax.random.randint`` returns its minimum there."""
    return int(rng.integers(lo, hi)) if hi > lo else int(lo)


def paint_boxes(out: np.ndarray, boxes: Sequence[Box]) -> np.ndarray:
    """``out`` (a host array of the mask's shape) set to 1, then to 0
    inside each of ``boxes``."""
    out.fill(1)
    for starts, sizes in boxes:
        out[tuple(slice(int(s), int(s) + int(n))
                  for s, n in zip(starts, sizes))] = 0
    return out


def boxes_mask(spatial: Sequence[int], boxes: Sequence[Box],
               device=None) -> torch.Tensor:
    """int32 mask of shape ``spatial``: 0 inside any of ``boxes``, 1
    elsewhere, the product of their :func:`box_mask`. One box is built on
    ``device``; several are painted on the host (:func:`paint_boxes`) and
    copied once, so a grid of 27 boxes costs one copy, not 27 launches."""
    if len(boxes) == 1:
        return box_mask(spatial, *boxes[0], device=device)
    out = torch.from_numpy(paint_boxes(
        np.empty(tuple(int(s) for s in spatial), np.int32), boxes))
    return out if device is None else out.to(device, non_blocking=True)


def grid_sizes(spatial: Sequence[int], shrink: int = 3) -> Tuple[int, ...]:
    """The box of one grid cell (`masks.py:85-105`): 3-D
    ``int(int(dim*2/3) / shrink) + 1`` in x and y but no ``+ 1`` in z
    (`BCP_utils.py:30-46`); 2-D ``int(dim*2 / (3*shrink))``
    (`ACDC_BCP_train.py:142-154`)."""
    spatial = tuple(int(s) for s in spatial)
    if len(spatial) == 3:
        patch = [int(dim * 2 / 3) for dim in spatial]
        return (patch[0] // shrink + 1, patch[1] // shrink + 1,
                patch[2] // shrink)
    return tuple(int(dim * 2 / (3 * shrink)) for dim in spatial)


def grid_starts(rng: np.random.Generator, spatial: Sequence[int],
                shrink: int = 3) -> List[Tuple[int, ...]]:
    """The start offsets of the ``shrink**ndim`` grid boxes
    (`masks.py:106-122`), cells in ``flat % shrink`` order (x fastest): in
    cell c of axis d uniform in [c*cell, (c+1)*cell - size), the 3-D upper
    bound one lower still (the reference's ``randint(lo, hi - 1)``)."""
    spatial = tuple(int(s) for s in spatial)
    ndim = len(spatial)
    cell = [dim // shrink for dim in spatial]
    sizes = grid_sizes(spatial, shrink)
    hi_extra = 1 if ndim == 3 else 0
    out = []
    for flat in range(shrink ** ndim):
        idx, rem = [], flat
        for _ in range(ndim):
            idx.append(rem % shrink)
            rem //= shrink
        out.append(tuple(
            _randint(rng, idx[d] * cell[d],
                     (idx[d] + 1) * cell[d] - sizes[d] - hi_extra)
            for d in range(ndim)))
    return out


def grid_boxes(spatial: Sequence[int], starts: Sequence[Sequence[int]],
               shrink: int = 3) -> List[Box]:
    sizes = grid_sizes(spatial, shrink)
    return [(tuple(s), sizes) for s in starts]


def grid_mask(spatial: Sequence[int], starts: Sequence[Sequence[int]],
              shrink: int = 3, device=None) -> torch.Tensor:
    """``random_mask``'s multi-box mask (`masks.py:85-122`): one zero box
    a cell of a ``shrink``^ndim grid, at the given start offsets (one tuple
    a cell, in :func:`grid_starts`'s order)."""
    return boxes_mask(spatial, grid_boxes(spatial, starts, shrink), device)


def slab_box(spatial: Sequence[int], start: int, axis: int = -1,
             fraction: float = 8.0 / 27.0) -> Box:
    """(starts, sizes) of the slab of ``int(dim*fraction)`` along
    ``axis`` from ``start``, full extent on the other axes."""
    spatial = tuple(int(s) for s in spatial)
    axis = axis % len(spatial)
    starts = [0] * len(spatial)
    sizes = list(spatial)
    starts[axis] = int(start)
    sizes[axis] = int(spatial[axis] * fraction)
    return tuple(starts), tuple(sizes)


def slab_start(rng: np.random.Generator, spatial: Sequence[int],
               axis: int = -1, fraction: float = 8.0 / 27.0) -> int:
    """The slab's offset, uniform in [0, dim - length - 1)
    (`masks.py:125-142`: ``randint(0, dim - length - 1)``)."""
    dim = int(tuple(spatial)[axis % len(spatial)])
    return _randint(rng, 0, dim - int(dim * fraction) - 1)


def slab_mask(spatial: Sequence[int], start: int, axis: int = -1,
              fraction: float = 8.0 / 27.0, device=None) -> torch.Tensor:
    """``concate_mask`` (3-D z-slab of 8/27, `BCP_utils.py:48-56`) and
    ``contact_mask`` (2-D, ``axis=0, fraction=4/9``,
    `ACDC_BCP_train.py:156-164`) at the given offset (`masks.py:125-142`)."""
    return box_mask(spatial, *slab_box(spatial, start, axis, fraction),
                    device=device)


def bbox_nd(mask: torch.Tensor) -> torch.Tensor:
    """(ndim, 2) int32 per-axis (min, max + 1) of the nonzero region
    (`masks.py:145-165`, `get_bbox_3d`); (0, 1) on every axis when the
    mask is empty."""
    nz = mask != 0
    empty = not bool(nz.any())
    bounds = []
    for d in range(mask.dim()):
        other = tuple(i for i in range(mask.dim()) if i != d)
        occ = nz.any(dim=other) if other else nz
        where = torch.nonzero(occ).flatten()
        lo, hi = (0, 0) if empty else (int(where[0]), int(where[-1]))
        bounds.append((lo, hi + 1))
    return torch.tensor(bounds, dtype=torch.int32)


def bbox_mask(masks: torch.Tensor) -> torch.Tensor:
    """Batched ``get_bbox_mask`` (`masks.py:168-186`): for each (N,
    *spatial) sample, 0 inside its nonzero bounding box, 1 outside."""
    spatial = tuple(masks.shape[1:])
    out = []
    for m in masks:
        b = bbox_nd(m).tolist()
        out.append(box_mask(spatial, [lo for lo, _ in b],
                            [hi - lo for lo, hi in b], masks.device))
    return torch.stack(out)


def mix(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``a * mask + b * (1 - mask)`` (`masks.py:189-201`). ``mask`` has shape
    ``spatial``; ``a`` / ``b`` are (N, C, *spatial) images or (N, *spatial)
    labels."""
    m = mask.to(a.dtype)
    if a.dim() == m.dim() + 2:
        m = m[None, None]
    elif a.dim() == m.dim() + 1:
        m = m[None]
    return a * m + b * (1 - m)
