"""Synthetic LA and pancreas volumes and ACDC slices:
``bcp_tpu/data/synthetic.py`` for the port.

Noisy backgrounds with one bright ellipsoid blob per foreground class
whose voxels are that class. The generators draw the same numbers as the
JAX package's from the same seed.
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


def acdc_cases(n_slices: int, slice_shapes: Sequence[Sequence[int]] = (
        (64, 64),), n_volumes: int = 0, volume_shape=(4, 64, 64),
        n_classes: int = 4, seed: int = 0):
    """ACDC cases in memory, drawn in the order ``make_acdc_dataset`` draws
    them: ``n_slices`` train slices (image f32, label uint8), slice i of
    shape ``slice_shapes[i % len(slice_shapes)]`` (mixed native shapes, as
    ACDC's), then ``n_volumes`` (slices, H, W) volumes of
    ``volume_shape``, one blob draw a slice. Returns (slices, volumes)."""
    rng = np.random.default_rng(seed)
    slices = [blob_volume(rng, slice_shapes[i % len(slice_shapes)],
                          n_classes) for i in range(n_slices)]
    volumes = []
    for _ in range(n_volumes):
        vol = [blob_volume(rng, volume_shape[1:], n_classes)
               for _ in range(volume_shape[0])]
        volumes.append((np.stack([v[0] for v in vol]),
                        np.stack([v[1] for v in vol])))
    return slices, volumes


def make_acdc_dataset(root: str, n_train_slices: int = 24, n_val: int = 2,
                      slice_shape=(64, 64), vol_depth: int = 4,
                      n_classes: int = 4, seed: int = 0) -> str:
    """ACDC layout (`synthetic.py:54-91`): per-slice train h5 under
    data/slices/, volumes under data/, the lists at the root (the
    validation volumes serve as the test list too)."""
    import h5py
    slices, volumes = acdc_cases(n_train_slices, (slice_shape,), n_val,
                                 (vol_depth, *slice_shape), n_classes, seed)
    os.makedirs(os.path.join(root, "data", "slices"), exist_ok=True)
    train = [f"synth_patient_{i:03d}_slice_0" for i in range(n_train_slices)]
    val = [f"synth_val_{i:03d}" for i in range(n_val)]
    files = [os.path.join("slices", n) for n in train] + val
    for name, (image, label) in zip(files, slices + volumes):
        with h5py.File(os.path.join(root, "data", f"{name}.h5"), "w") as f:
            f.create_dataset("image", data=image)
            f.create_dataset("label", data=label)
    for name, cases in (("train_slices", train), ("val", val),
                        ("test", val)):
        with open(os.path.join(root, f"{name}.list"), "w") as f:
            f.write("\n".join(cases) + "\n")
    return root


def pancreas_cases(n_lab: int, n_unlab: int, n_test: int,
                   shapes: Sequence[Sequence[int]] = ((48, 48, 48),),
                   test_shape=None, seed: int = 0):
    """Pancreas cases in memory, drawn in the order ``make_pancreas_dataset``
    draws them (labelled, unlabelled, test): train case i of shape
    ``shapes[i % len(shapes)]`` (counted over both train lists), test
    cases of ``test_shape`` (default ``shapes[0]``). Labels are f32, as the
    reference's h5 files store them. Returns (lab, unlab, test)."""
    rng = np.random.default_rng(seed)
    test_shape = tuple(test_shape or shapes[0])
    out = []
    for i in range(n_lab + n_unlab + n_test):
        shape = (shapes[i % len(shapes)] if i < n_lab + n_unlab
                 else test_shape)
        image, label = blob_volume(rng, shape)
        out.append((image, label.astype(np.float32)))
    return (out[:n_lab], out[n_lab:n_lab + n_unlab],
            out[n_lab + n_unlab:])


def make_pancreas_dataset(root: str, n_lab: int = 4, n_unlab: int = 6,
                          n_test: int = 2, shape=(48, 48, 48),
                          seed: int = 0) -> str:
    """Pancreas layout (`synthetic.py:90-109`): h5 files under <root>/h5 and
    the train_lab / train_unlab / test .txt lists of their relative
    paths."""
    import h5py
    groups = zip(("train_lab", "train_unlab", "test"),
                 pancreas_cases(n_lab, n_unlab, n_test, (shape,), seed=seed))
    os.makedirs(os.path.join(root, "h5"), exist_ok=True)
    for group, cases in groups:
        rels = []
        for i, (image, label) in enumerate(cases):
            rel = os.path.join("h5", f"{group}_{i:03d}.h5")
            with h5py.File(os.path.join(root, rel), "w") as f:
                f.create_dataset("image", data=image)
                f.create_dataset("label", data=label)
            rels.append(rel)
        with open(os.path.join(root, f"{group}.txt"), "w") as f:
            f.write("\n".join(rels) + "\n")
    return root
