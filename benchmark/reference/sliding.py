"""The plain reference of LA's sliding-window inference
(`test_3d_patch.py:85-140` of DeepMed-Lab-ECNU/BCP): pad a volume
smaller than the patch, tile it with windows at strides (18, 18, 4), add
each window's softmax into a score map and count the windows over each
voxel, divide, crop the padding off. The windows are run several at a
time; in eval mode each window's forward is its own."""

from __future__ import annotations

import math

import numpy as np
import torch


def window_origins(shape, patch, stride_xy: int, stride_z: int):
    strides = (stride_xy, stride_xy, stride_z)
    axes = []
    for dim, p, s in zip(shape, patch, strides):
        n = math.ceil((dim - p) / s) + 1 if dim > p else 1
        axes.append([min(s * i, dim - p) for i in range(n)])
    return [(x, y, z) for x in axes[0] for y in axes[1] for z in axes[2]]


@torch.no_grad()
def scores(model, image: np.ndarray, patch, stride_xy: int, stride_z: int,
           n_classes: int, device, batch: int = 8) -> torch.Tensor:
    """(C, X, Y, Z) class scores of ``image`` averaged over the windows,
    in the model's dtype."""
    pads = [(max(p - d, 0) // 2, max(p - d, 0) - max(p - d, 0) // 2)
            for d, p in zip(image.shape, patch)]
    dt = next(model.parameters()).dtype
    vol = torch.from_numpy(np.pad(image, pads)).to(device, dt)
    shape = vol.shape
    score = torch.zeros((n_classes, *shape), device=device, dtype=dt)
    cnt = torch.zeros(shape, device=device, dtype=dt)
    origins = window_origins(shape, patch, stride_xy, stride_z)
    px, py, pz = patch
    for lo in range(0, len(origins), batch):
        chunk = origins[lo:lo + batch]
        x = torch.stack([vol[a:a + px, b:b + py, c:c + pz]
                         for a, b, c in chunk])[:, None]
        prob = torch.softmax(model(x), dim=1)
        for (a, b, c), p in zip(chunk, prob):
            score[:, a:a + px, b:b + py, c:c + pz] += p
            cnt[a:a + px, b:b + py, c:c + pz] += 1
    score /= cnt
    sl = tuple(slice(lo, lo + d) for (lo, _), d in zip(pads, image.shape))
    return score[(slice(None),) + sl]
