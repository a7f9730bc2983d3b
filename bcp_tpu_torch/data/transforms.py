"""Train augmentation: ``bcp_tpu/data/transforms.py``'s LA, ACDC and
pancreas parts for the port. Pure numpy (and scipy's nearest resampling)
over an explicit ``np.random.Generator``, drawing the same numbers in the
same order as the JAX package, so the same seed gives the same samples bit
for bit."""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage


def random_rot_flip(image: np.ndarray, label: np.ndarray,
                    rng: np.random.Generator):
    """k*90-degree rotation in the leading two axes, then a flip along axis
    0 or 1 (`transforms.py:18-29`, `dataloaders/dataset.py:52-59`)."""
    k = int(rng.integers(0, 4))
    image = np.rot90(image, k)
    label = np.rot90(label, k)
    axis = int(rng.integers(0, 2))
    image = np.flip(image, axis=axis).copy()
    label = np.flip(label, axis=axis).copy()
    return image, label


def random_rotate(image: np.ndarray, label: np.ndarray,
                  rng: np.random.Generator):
    """Nearest rotation by an integer angle in [-20, 20) degrees
    (`transforms.py:32-39`, `dataloaders/dataset.py:62-66`)."""
    angle = int(rng.integers(-20, 20))
    image = ndimage.rotate(image, angle, order=0, reshape=False)
    label = ndimage.rotate(label, angle, order=0, reshape=False)
    return image, label


def zoom_to(image: np.ndarray, label: np.ndarray,
            output_size: Sequence[int]):
    """Nearest zoom of a 2-D slice to ``output_size``
    (`transforms.py:42-50`)."""
    x, y = image.shape
    sx, sy = output_size[0] / x, output_size[1] / y
    image = ndimage.zoom(image, (sx, sy), order=0)
    label = ndimage.zoom(label, (sx, sy), order=0)
    return image, label


def acdc_random_generator(image: np.ndarray, label: np.ndarray,
                          output_size: Sequence[int],
                          rng: np.random.Generator):
    """The ACDC train transform (`transforms.py:53-65`,
    `dataloaders/dataset.py:69-88`): with p = 0.5 rot90 + flip, else with
    p = 0.25 a rotation (two coin draws, as the reference's ``if ... elif``),
    then the nearest zoom to ``output_size``."""
    if rng.random() > 0.5:
        image, label = random_rot_flip(image, label, rng)
    elif rng.random() > 0.5:
        image, label = random_rotate(image, label, rng)
    image, label = zoom_to(image, label, output_size)
    return image.astype(np.float32), label.astype(np.uint8)


def _pad_to_fit(arrs, output_size, extra: int):
    """Pad-if-small, +3 per side for LA, +1 for pancreas
    (`transforms.py:63-71`): every axis is padded unless all of them exceed
    the patch."""
    shape = arrs[0].shape
    if all(s > o for s, o in zip(shape, output_size)):
        return arrs
    pads = [max((o - s) // 2 + extra, 0) for s, o in zip(shape, output_size)]
    pad_width = [(p, p) for p in pads]
    return [np.pad(a, pad_width, mode="constant", constant_values=0)
            for a in arrs]


def random_crop(image: np.ndarray, label: np.ndarray,
                output_size: Sequence[int], rng: np.random.Generator,
                pad_extra: int = 3):
    """Pad-then-random-crop (`transforms.py:81-91`, `RandomCrop`)."""
    image, label = _pad_to_fit([image, label], output_size, pad_extra)
    starts = [int(rng.integers(0, s - o))
              for s, o in zip(image.shape, output_size)]
    sl = tuple(slice(st, st + o) for st, o in zip(starts, output_size))
    return image[sl], label[sl]


def la_train_transform(image, label, patch_size, rng):
    """RandomRotFlip -> RandomCrop (`transforms.py:113-118`)."""
    image, label = random_rot_flip(image, label, rng)
    image, label = random_crop(image, label, patch_size, rng)
    return image.astype(np.float32), label.astype(np.int32)


def center_crop(image: np.ndarray, label: np.ndarray,
                output_size: Sequence[int], pad_extra: int = 3):
    """Pad-then-centre-crop (`transforms.py:95-104`, `CenterCrop`); the
    start is ``round((s - o) / 2)``, Python's round half to even."""
    image, label = _pad_to_fit([image, label], output_size, pad_extra)
    starts = [int(round((s - o) / 2.0))
              for s, o in zip(image.shape, output_size)]
    sl = tuple(slice(st, st + o) for st, o in zip(starts, output_size))
    return image[sl], label[sl]


def random_noise(image: np.ndarray, rng: np.random.Generator,
                 mu: float = 0.0, sigma: float = 0.1):
    """Clipped gaussian noise (`transforms.py:105-110`, `RandomNoise`,
    `dataset.py:242-252`)."""
    noise = np.clip(sigma * rng.standard_normal(image.shape),
                    -2 * sigma, 2 * sigma) + mu
    return image + noise


def pancreas_train_transform(image, label, patch_size, rng):
    """RandomCrop only, +1 padding (`transforms.py:121-125`,
    `pancreas/dataloaders.py:120-125`)."""
    image, label = random_crop(image, label, patch_size, rng, pad_extra=1)
    return image.astype(np.float32), label.astype(np.int32)


def pancreas_test_transform(image, label, patch_size):
    """CenterCrop, +1 padding: the unlabelled stream and the test volumes
    (`transforms.py:128-132`, `pancreas/dataloaders.py:127-136`)."""
    image, label = center_crop(image, label, patch_size, pad_extra=1)
    return image.astype(np.float32), label.astype(np.int32)
