"""2-D per-slice volume inference (ACDC) on the card.

Counterpart of ``bcp_tpu/eval/slice2d.py``. The reference runs one
batch-1 forward per slice (`utils/val_2d.py:20-41`, `test_ACDC.py:36-79`);
here, per volume:

- one nearest zoom of the whole (slices, H, W) volume to the net's size on
  the host (a slice-axis factor of exactly 1 maps slice i to slice i, so
  this equals the reference's per-slice zooms);
- one batched forward of all its slices on the card;
- the softmax and argmax there, fetched as uint8;
- one nearest zoom back.

The JAX package pads the slice count to a bucket only so that XLA compiles
a few programs; eval-mode BatchNorm treats each slice on its own, so the
port, which compiles nothing per shape, runs the real slices alone and
gives the same labels.

In a world of N ranks (``parallel.mesh``) a volume's slices are padded
with zero slices to a multiple of N and split into N contiguous blocks,
as the JAX evaluator shards its bucket over the mesh
(`slice2d.py:25-40`): rank r forwards block r, and the uint8 labels of
all blocks are gathered on every rank.
"""

from __future__ import annotations

from collections import deque
from itertools import repeat
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage

from bcp_tpu_torch.device import resolve_device
from bcp_tpu_torch.eval import metrics as M
from bcp_tpu_torch.models.layers import logits_of
from bcp_tpu_torch.parallel import mesh


class Slice2DEvaluator:
    """Per-slice inference of (slices, H, W) volumes with one eval-mode 2-D
    model, whose weights the caller loads."""

    def __init__(self, model: torch.nn.Module,
                 patch_size: Sequence[int] = (256, 256),
                 num_classes: int = 4, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.patch = tuple(patch_size)
        self.num_classes = num_classes
        # zoomed volumes kept on the device by caller token (a fixed
        # validation set): no host zoom or upload on the next validation
        self._prep_cache: Dict = {}

    def _prepare(self, image: np.ndarray, cache_token=None) -> torch.Tensor:
        if cache_token is not None and cache_token in self._prep_cache:
            return self._prep_cache[cache_token]
        n, x, y = image.shape
        zoomed = ndimage.zoom(
            image, (1.0, self.patch[0] / x, self.patch[1] / y),
            order=0).astype(np.float32)
        W = mesh.world_size()
        if W > 1:
            # this rank's block of the slices padded to a multiple of N
            per = -(-n // W)
            zoomed = np.concatenate([zoomed, np.zeros(
                (per * W - n, *zoomed.shape[1:]), np.float32)])
            zoomed = zoomed[mesh.rank() * per:(mesh.rank() + 1) * per]
        x_dev = torch.from_numpy(zoomed[:, None]).to(self.device)
        if cache_token is not None:
            self._prep_cache[cache_token] = x_dev
        return x_dev

    @torch.no_grad()
    def predict_async(self, image: np.ndarray, cache_token=None):
        """Enqueue one volume on the device and return a handle without
        waiting: the uint8 labels' copy to the host is enqueued behind the
        forward and an event marks its end. ``cache_token`` keeps the
        zoomed volume on the device for the next call with that token."""
        x_dev = self._prepare(np.asarray(image), cache_token)
        out = self.model(x_dev)     # a tuple's first element, as in 3-D
        logits = logits_of(out)
        label = torch.argmax(torch.softmax(logits, dim=1), dim=1).to(
            torch.uint8)
        if mesh.world_size() > 1:
            label = mesh.gather_rows(label)[:np.shape(image)[0]]
        event = None
        if self.device.type == "cuda":
            host = torch.empty(label.shape, dtype=torch.uint8,
                               pin_memory=True)
            label = host.copy_(label, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return label, event, np.shape(image)

    def predict_fetch(self, handle) -> np.ndarray:
        """Wait for a handle of :meth:`predict_async`; the label volume at
        the image's own in-plane size."""
        label, event, (_, x, y) = handle
        if event is not None:
            event.synchronize()
        return ndimage.zoom(label.numpy(),
                            (1.0, x / self.patch[0], y / self.patch[1]),
                            order=0)

    def predict_volume(self, image: np.ndarray) -> np.ndarray:
        """(slices, H, W) image -> label volume, the argmax rule
        (`val_2d.py:27-37`)."""
        return self.predict_fetch(self.predict_async(image))

    def predict_volumes(self, images, depth: int = 3, cache_tokens=None):
        """Label volumes of an iterable of images, in order, with up to
        ``depth`` volumes enqueued beyond the one being yielded, so that
        the host's zooms and the caller's metrics overlap the device."""
        q: deque = deque()
        toks = repeat(None) if cache_tokens is None else iter(cache_tokens)
        for image, tok in zip(images, toks):
            q.append(self.predict_async(image, cache_token=tok))
            if len(q) > depth:
                yield self.predict_fetch(q.popleft())
        while q:
            yield self.predict_fetch(q.popleft())

    def _dice_hd95(self, pred, label) -> List[Tuple[float, float]]:
        return [M.calculate_dice_hd95(pred == c, label == c)
                for c in range(1, self.num_classes)]

    def validate_volume(self, image, label) -> List[Tuple[float, float]]:
        """Per-class (dice, hd95), `val_2d.test_single_volume`
        (`val_2d.py:20-41`)."""
        return self._dice_hd95(self.predict_volume(image), label)

    def validate_volumes(self, cases, cache: bool = False
                         ) -> List[List[Tuple[float, float]]]:
        """:meth:`validate_volume` over (image, label) pairs, pipelined;
        ``cache`` keeps the zoomed volumes on the device across calls (the
        ``i``-th case is token ``("val", i)``)."""
        tokens = (("val", i) for i in range(len(cases))) if cache else None
        preds = self.predict_volumes((img for img, _ in cases),
                                     cache_tokens=tokens)
        return [self._dice_hd95(pred, label)
                for pred, (_, label) in zip(preds, cases)]

    def metrics_for(self, pred, label) -> List[Tuple[float, float, float,
                                                     float]]:
        """Per-class (dice, jc, hd95, asd), zeros where the prediction or
        the label lacks the class (`test_ACDC.py:36-79`)."""
        out = []
        for c in range(1, self.num_classes):
            pc, gc = pred == c, label == c
            if pc.sum() == 0 or gc.sum() == 0:
                out.append((0.0, 0.0, 0.0, 0.0))
            else:
                out.append((M.dice_binary(pc, gc), M.jaccard_binary(pc, gc),
                            M.hd95(pc, gc), M.asd(pc, gc)))
        return out

    def test_volume(self, image, label):
        """(per-class (dice, jc, hd95, asd), label volume)."""
        pred = self.predict_volume(image)
        return self.metrics_for(pred, label), pred
