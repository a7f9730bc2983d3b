"""Copy-paste masks: ``bcp_tpu/ops/masks.py``'s LA, ACDC and pancreas parts
for the port.

Polarity as in the reference (`BCP_utils.py:26`): ``mask == 0`` marks the
pasted patch, ``mask == 1`` the kept image; the mixed input is
``a * mask + b * (1 - mask)``. The box's start offsets are host integers,
drawn by :func:`cuboid_starts` from a numpy generator or handed in by the
caller (the tests hand in the JAX package's draws), so building the mask
on the card needs no copy from the host.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


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
