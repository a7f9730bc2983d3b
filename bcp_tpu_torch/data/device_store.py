"""Device-resident training data: upload once, augment on the device.

``bcp_tpu/data/device_store.py`` for the port: ``DeviceVolumeStore`` (LA)
and ``DeviceSliceStore`` (ACDC). The host feed builds every batch with
numpy and uploads it each step; the whole training set fits in a corner of
the card's memory (LA 2-3 GB in bf16, ACDC's 1312 slices well under one),
so each store uploads the padded cases once and cuts augmented batches out
of them on the device: per step the host draws a handful of integers.

LA augmentation equivalence with the host transforms (`dataloaders/
dataset.py:52-59,173-212`): the reference rotates and flips the whole
volume, then crops uniformly over the rotated extent. With a square xy
patch that is distributionally identical to cropping in original
coordinates and rotating and flipping the crop, which is what happens here.
Pad-if-small is applied once at upload with the reference's
``(patch - dim) // 2 + pad_extra`` margins, so offset ranges match exactly.

The same seed gives the JAX stores' batches: the draws (``draw_params``)
consume the numpy generator in the same order, and crop, rot90, flip and
the nearest zoom only move values (see :class:`DeviceSliceStore` for its
rotate mode). Images come back as (N, 1, *patch) in the store's dtype,
labels as (N, *patch) uint8.
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


class DeviceSliceStore:
    """ACDC train slices on the card, augmented there
    (`device_store.py:170-358`).

    The reference's ``RandomGenerator`` (`dataloaders/dataset.py:69-88`):
    with p = 0.5 rot90 + flip, else with p = 0.25 a nearest rotation by an
    integer angle in [-20, 20), then the nearest zoom to ``out_size``. The
    native slices are stored bucket-padded to the largest (H, W), in the
    image dtype (a nearest resampling only moves values, so casting at
    upload equals the host feed's cast after the transform). A batch is one
    composed per-pixel gather at the output resolution: the source index
    of each output pixel is worked out on the device from the (N, 7)
    integer draws, for all three modes at once.

    What is exact (the JAX class docstring, :171-215):

    - the none and rot90 + flip modes and the zoom equal scipy bit for bit:
      scipy's ``zoom(order=0)`` maps output index i to input index
      ``floor(i * (n_in - 1) / (n_out - 1) + 0.5)``, evaluated here in exact
      integer arithmetic as ``(2 i (n_in - 1) + n_out - 1) // (2 (n_out -
      1))`` (the rational is never on a rounding boundary: odd numerator,
      even denominator), and rot90 / flip are index permutations;
    - the rotate mode follows scipy's conventions (source ``R^-1 (out -
      c) + c``, nearest ``floor(x + 0.5)``, zero outside [0, n - 1]) but
      computes the coordinates in f32 where scipy uses f64, so a pixel
      whose source lies within ~2e-5 of a rounding boundary may take its
      neighbour: under 1e-3 of the pixels, the JAX store's own limit. The
      rotation is evaluated at the zoom's integer source indices, which
      equals rotating the whole slice and then zooming.
    """

    def __init__(self, images: Sequence[np.ndarray],
                 labels: Sequence[np.ndarray], out_size=(256, 256),
                 img_dtype=torch.bfloat16, device=None):
        out_size = tuple(int(s) for s in out_size)
        if len(out_size) != 2 or min(out_size) < 2:
            raise ValueError(f"out_size {out_size}: two sides of >= 2")
        shapes = np.array([np.shape(img) for img in images], np.int32)
        hmax, wmax = int(shapes[:, 0].max()), int(shapes[:, 1].max())
        imgs = np.zeros((len(images), hmax, wmax), np.float32)
        labs = np.zeros((len(images), hmax, wmax), np.uint8)
        for i, (img, lab) in enumerate(zip(images, labels)):
            h, w = np.shape(img)
            imgs[i, :h, :w] = img
            labs[i, :h, :w] = lab
        self.out_size = out_size
        self.shapes = shapes
        self.device = resolve_device(device)
        self.images = torch.from_numpy(imgs).to(
            img_dtype or torch.float32).to(self.device)
        self.labels = torch.from_numpy(labs).to(self.device)

    @classmethod
    def from_dataset(cls, dataset, indices, out_size=(256, 256),
                     img_dtype=torch.bfloat16, device=None):
        pairs = [dataset.load(i) for i in indices]
        return cls([np.asarray(p[0], np.float32) for p in pairs],
                   [np.asarray(p[1], np.uint8) for p in pairs], out_size,
                   img_dtype, device)

    # ------------------------------------------------------------------
    def draw_params(self, indices, rng: np.random.Generator):
        """Host draws for one batch in the reference's order per sample
        (`device_store.py:324-346`, ``transforms.acdc_random_generator``):
        coin > 0.5 -> mode 1, k ~ U{0..3}, flip axis ~ U{0, 1}; elif coin
        > 0.5 -> mode 2, angle ~ U{-20..19}; else mode 0."""
        idx = np.asarray(indices, np.int32)
        n = len(idx)
        modes, ks, flips, angles = (np.zeros(n, np.int32) for _ in range(4))
        for j in range(n):
            if rng.random() > 0.5:
                modes[j] = 1
                ks[j] = rng.integers(0, 4)
                flips[j] = rng.integers(0, 2)
            elif rng.random() > 0.5:
                modes[j] = 2
                angles[j] = rng.integers(-20, 20)
        return idx, modes, ks, flips, angles

    def _source_map(self, p: torch.Tensor):
        """(slice, row, col) source indices (N, oh, ow) and the inside mask
        of each output pixel: the exact zoom, the inverse flip, the inverse
        rot90, then (mode 2) the nearest rotation (`device_store.py:
        264-310`)."""
        oh, ow = self.out_size
        hmax, wmax = self.images.shape[1:]
        i, h, w, mode, k, flip, angle = (c.view(-1, 1, 1)
                                         for c in p.unbind(1))

        def zoom_idx(n_in, n_out):
            o = torch.arange(n_out, device=p.device).view(1, -1)
            return (2 * o * (n_in.view(-1, 1) - 1) + (n_out - 1)) // (
                2 * (n_out - 1))

        rotflip = mode == 1
        swap = rotflip & (k % 2 == 1)
        h2 = torch.where(swap, w, h)
        w2 = torch.where(swap, h, w)
        zi = zoom_idx(h2, oh)[:, :, None]
        zj = zoom_idx(w2, ow)[:, None, :]
        fi = torch.where(rotflip & (flip == 0), h2 - 1 - zi, zi)
        fj = torch.where(rotflip & (flip == 1), w2 - 1 - zj, zj)
        k = torch.where(rotflip, k, 0)
        si = torch.where(k == 0, fi, torch.where(
            k == 1, fj, torch.where(k == 2, h - 1 - fi, h - 1 - fj)))
        sj = torch.where(k == 0, fj, torch.where(
            k == 1, w - 1 - fi, torch.where(k == 2, w - 1 - fj, fi)))
        # mode 2: out(i, j) <- in(R (o - c) + c), c = ((h-1)/2, (w-1)/2),
        # R = [[cos, sin], [-sin, cos]], in f32 as the JAX store
        a = angle.to(torch.float32) * (np.pi / 180.0)
        c, s = torch.cos(a), torch.sin(a)
        hf, wf = h.to(torch.float32), w.to(torch.float32)
        ci0, cj0 = (hf - 1) / 2, (wf - 1) / 2
        di = si.to(torch.float32) - ci0
        dj = sj.to(torch.float32) - cj0
        src_i = c * di + s * dj + ci0
        src_j = -s * di + c * dj + cj0
        rot = mode == 2
        inside = ~rot | ((src_i >= 0) & (src_i <= hf - 1)
                         & (src_j >= 0) & (src_j <= wf - 1))
        ri = torch.floor(src_i + 0.5).long().clamp(0, hmax - 1)
        rj = torch.floor(src_j + 0.5).long().clamp(0, wmax - 1)
        si = torch.where(rot, ri, si)
        sj = torch.where(rot, rj, sj)
        return (i * hmax + si) * wmax + sj, inside

    def aug_batch(self, params) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply :meth:`draw_params` output on the device, on the calling
        thread's current stream: (img (N, 1, oh, ow), lab (N, oh, ow))."""
        idx, modes, ks, flips, angles = params
        p = torch.from_numpy(np.stack(
            [idx, self.shapes[idx, 0], self.shapes[idx, 1], modes, ks, flips,
             angles], axis=1).astype(np.int64))
        if self.device.type == "cuda":
            p = p.pin_memory().to(self.device, non_blocking=True)
        flat, inside = self._source_map(p)
        img = torch.where(inside, self.images.view(-1)[flat], 0)
        lab = torch.where(inside, self.labels.view(-1)[flat], 0)
        return img[:, None], lab

    def sample_batch(self, indices, rng: np.random.Generator):
        """A ``RandomGenerator``-augmented batch, cut on the device."""
        return self.aug_batch(self.draw_params(indices, rng))
