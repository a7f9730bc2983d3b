"""Device-resident training volumes: upload once, augment on the device.

``bcp_tpu/data/device_store.py``'s ``DeviceVolumeStore`` for the port (the
ACDC ``DeviceSliceStore`` comes with the ACDC slice). The host feed builds
every crop batch with numpy and uploads it each step; the whole LA training
set fits in a corner of the card's memory (2-3 GB in bf16), so this store
uploads each padded volume once and cuts augmented crop batches out of it
with tensor indexing, ``torch.rot90`` and ``flip`` on the device: per step
the host draws a handful of integers.

Augmentation equivalence with the host transforms (`dataloaders/
dataset.py:52-59,173-212`): the reference rotates and flips the whole
volume, then crops uniformly over the rotated extent. With a square xy
patch that is distributionally identical to cropping in original
coordinates and rotating and flipping the crop, which is what happens here.
Pad-if-small is applied once at upload with the reference's
``(patch - dim) // 2 + pad_extra`` margins, so offset ranges match exactly.

The same seed gives the JAX store's batches bit for bit: the draws
(:meth:`DeviceVolumeStore.draw_params`) consume the numpy generator in the
same order, and crop, rot90 and flip only move values. Images come back as
(N, 1, *patch) in the store's dtype, labels as (N, *patch) uint8.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from bcp_tpu_torch.device import resolve_device


def _pad_like_reference(image, label, patch, pad_extra):
    """`RandomCrop` pad-if-small (`dataset.py:190-196`; pancreas
    pad_extra=1, `pancreas/dataloaders.py:34-38`)."""
    shape = image.shape
    if all(s > p for s, p in zip(shape, patch)):
        return image, label
    pads = [(max((p - s) // 2 + pad_extra, 0),) * 2
            for s, p in zip(shape, patch)]
    return (np.pad(image, pads, mode="constant"),
            np.pad(label, pads, mode="constant"))


class DeviceVolumeStore:
    """Stacked, bucket-padded volumes resident in device memory."""

    def __init__(self, images: Sequence[np.ndarray],
                 labels: Sequence[np.ndarray], patch: Sequence[int],
                 pad_extra: int = 3, img_dtype=torch.bfloat16, device=None):
        patch = tuple(patch)
        padded = [_pad_like_reference(np.asarray(img, np.float32),
                                      np.asarray(lab), patch, pad_extra)
                  for img, lab in zip(images, labels)]
        shapes = np.array([p[0].shape for p in padded], np.int32)
        # square xy bucket so rot90 of the crop stays shape-stable
        bx = int(max(shapes[:, 0].max(), shapes[:, 1].max()))
        bucket = (bx, bx, int(shapes[:, 2].max()))
        imgs = np.zeros((len(padded), *bucket), np.float32)
        labs = np.zeros((len(padded), *bucket), np.uint8)
        for i, (img, lab) in enumerate(padded):
            sl = tuple(slice(0, s) for s in img.shape)
            imgs[i][sl] = img
            labs[i][sl] = lab
        self.patch = patch
        self.shapes = shapes                      # valid extents per volume
        self.device = resolve_device(device)
        self.images = torch.from_numpy(imgs).to(
            img_dtype or torch.float32).to(self.device)
        self.labels = torch.from_numpy(labs).to(self.device)

    @classmethod
    def from_dataset(cls, dataset, indices, patch, pad_extra=3,
                     img_dtype=torch.bfloat16, device=None):
        pairs = [dataset.load(i) for i in indices]
        return cls([p[0] for p in pairs], [p[1] for p in pairs], patch,
                   pad_extra, img_dtype, device)

    # ------------------------------------------------------------------
    def draw_params(self, indices, rng: np.random.Generator,
                    rotflip: bool = True):
        """Host-side augmentation draws for one batch, in the reference's
        order per sample: k ~ U{0..3}, flip axis ~ U{0,1}
        (`dataset.py:52-59`), crop offset ~ U[0, dim - patch)
        (`dataset.py:202-204`)."""
        idx = np.asarray(indices, np.int32)
        n = len(idx)
        ks = np.zeros(n, np.int32)
        flips = np.zeros(n, np.int32)
        offsets = np.zeros((n, 3), np.int32)
        for j, i in enumerate(idx):
            if rotflip:
                ks[j] = rng.integers(0, 4)
                flips[j] = rng.integers(0, 2)
            shape = self.shapes[i]
            for d in range(3):
                offsets[j, d] = rng.integers(
                    0, max(shape[d] - self.patch[d], 1))
        return idx, offsets, ks, flips

    def crop_batch(self, params,
                   rotflip: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply :meth:`draw_params` output on the device, on the calling
        thread's current stream."""
        idx, offsets, ks, flips = params
        if rotflip and self.patch[0] != self.patch[1]:
            raise ValueError(f"rot90 needs a square xy patch, got "
                             f"{self.patch}")
        imgs, labs = [], []
        for i, off, k, f in zip(idx, offsets, ks, flips):
            sl = (int(i),) + tuple(slice(int(o), int(o) + p)
                                   for o, p in zip(off, self.patch))
            for src, out in ((self.images, imgs), (self.labels, labs)):
                crop = src[sl]
                if rotflip:
                    crop = torch.rot90(crop, int(k), (0, 1)).flip(int(f))
                out.append(crop)
        return torch.stack(imgs)[:, None], torch.stack(labs)

    def sample_batch(self, indices, rng: np.random.Generator,
                     rotflip: bool = True):
        """Random-crop (+ optional rot/flip) batch, cut on the device."""
        return self.crop_batch(self.draw_params(indices, rng, rotflip),
                               rotflip)

    def center_batch(self, indices):
        """CenterCrop batch (the pancreas unlabelled stream,
        `pancreas/dataloaders.py:63-91`)."""
        idx = np.asarray(indices, np.int32)
        offsets = np.zeros((len(idx), 3), np.int32)
        for j, i in enumerate(idx):
            shape = self.shapes[i]
            for d in range(3):
                offsets[j, d] = int(round(
                    (int(shape[d]) - self.patch[d]) / 2.0))
        zeros = np.zeros(len(idx), np.int32)
        return self.crop_batch((idx, offsets, zeros, zeros), rotflip=False)
