"""Synthetic LA volumes: ``bcp_tpu/data/synthetic.py`` for the port.

Noisy backgrounds with one bright ellipsoid blob whose voxels are the
foreground class. The generator draws the same numbers as the JAX
package's from the same seed.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


def blob_volume(rng: np.random.Generator, shape: Sequence[int],
                n_classes: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """One (image f32, label uint8) pair (`synthetic.py:18-31`)."""
    coords = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    image = rng.normal(0.0, 0.3, size=tuple(shape)).astype(np.float32)
    label = np.zeros(tuple(shape), np.uint8)
    for c in range(1, n_classes):
        center = [rng.uniform(0.3, 0.7) * s for s in shape]
        radii = [max(2.0, rng.uniform(0.12, 0.22) * s) for s in shape]
        d = sum(((g - c0) / r0) ** 2 for g, c0, r0 in
                zip(coords, center, radii))
        blob = d <= 1.0
        label[blob] = c
        image[blob] += 0.8 + 0.4 * c
    return image, label


def la_cases(n: int, shape=(64, 64, 48),
             seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` blob volumes in memory, drawn in the order ``make_la_dataset``
    draws them."""
    rng = np.random.default_rng(seed)
    return [blob_volume(rng, shape) for _ in range(n)]


def make_la_dataset(root: str, n_train: int = 6, n_test: int = 2,
                    shape=(64, 64, 48), seed: int = 0) -> str:
    """LA layout: <root>/{train,test}.list +
    <root>/2018LA_Seg_Training Set/<case>/mri_norm2.h5."""
    import h5py
    names = [f"synth_case_{i:03d}" for i in range(n_train + n_test)]
    for name, (image, label) in zip(
            names, la_cases(n_train + n_test, shape, seed)):
        d = os.path.join(root, "2018LA_Seg_Training Set", name)
        os.makedirs(d, exist_ok=True)
        with h5py.File(os.path.join(d, "mri_norm2.h5"), "w") as f:
            f.create_dataset("image", data=image)
            f.create_dataset("label", data=label)
    with open(os.path.join(root, "train.list"), "w") as f:
        f.write("\n".join(names[:n_train]) + "\n")
    with open(os.path.join(root, "test.list"), "w") as f:
        f.write("\n".join(names[n_train:]) + "\n")
    return root
