"""Batched 3-D sliding-window inference on the card.

Counterpart of ``bcp_tpu/eval/sliding_window.py``:

- the padded volume is uploaded once and stays on the device;
- windows are gathered in batches of ``batch`` and run through the net
  (the last chunk is padded with windows at the origin);
- the softmax of each real window's logits is overlap-added into the
  (X, Y, Z, C) f32 score map in window order by
  ``ops.scatter.softmax_scatter_add_windows`` (one launch of the
  hand-written kernel a chunk on the card), which does not read the
  padded windows: the JAX package multiplies them by a ``valid`` mask of
  zeros, and adding +0.0 to a score that starts at +0.0 and only grows
  leaves it as it was;
- the count map depends only on the window grid: it is built once per grid
  on the host and kept on the device;
- then ``score / cnt`` and the reference's decision rule.

The window grid is byte-identical to the reference (`test_3d_patch.py:
109-121`). The JAX package also pads each volume up to a shape bucket, only
to bound how many programs XLA compiles; no window ever reaches that
padding, so the port, which compiles nothing per shape, drops it.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bcp_tpu_torch.device import resolve_device
from bcp_tpu_torch.eval import metrics as M
from bcp_tpu_torch.ops.scatter import softmax_scatter_add_windows


def window_starts(vol_shape: Sequence[int], patch: Sequence[int],
                  stride_xy: int, stride_z: int) -> np.ndarray:
    """The reference's grid (`test_3d_patch.py:109-121`), as an (N,3)
    array of window origins."""
    strides = (stride_xy, stride_xy, stride_z)
    axes = []
    for dim, p, s in zip(vol_shape, patch, strides):
        n = math.ceil((dim - p) / s) + 1 if dim > p else 1
        axes.append([min(s * i, dim - p) for i in range(n)])
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


def pad_to_patch(image: np.ndarray, patch: Sequence[int]):
    """Symmetric pad-if-smaller (`test_3d_patch.py:85-106`); returns the
    padded image and the left-pad offsets for the final crop."""
    pads = []
    for dim, p in zip(image.shape, patch):
        d = max(p - dim, 0)
        pads.append((d // 2, d - d // 2))
    if any(p != (0, 0) for p in pads):
        image = np.pad(image, pads, mode="constant", constant_values=0)
    return image, tuple(p[0] for p in pads)


class SlidingWindowEvaluator:
    """Batched overlap-tiled 3-D inference for one eval-mode model."""

    def __init__(self, model: torch.nn.Module, patch_size: Sequence[int],
                 num_classes: int, stride_xy: int, stride_z: int,
                 batch: int = 8, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.patch = tuple(patch_size)
        self.num_classes = num_classes
        self.stride_xy = stride_xy
        self.stride_z = stride_z
        self.batch = batch
        self._cnt_cache: Dict[Tuple, torch.Tensor] = {}

    # -- one chunk: gather, forward, softmax + overlap-add ---------------
    def _process_chunk(self, volume: torch.Tensor, starts: np.ndarray,
                       n_valid: int, score: torch.Tensor) -> None:
        """The chunk's windows at ``starts``, of which the first
        ``n_valid`` are real and the rest padding."""
        px, py, pz = self.patch
        patches = torch.stack([volume[sx:sx + px, sy:sy + py, sz:sz + pz]
                               for sx, sy, sz in starts.tolist()])[:, None]
        logits = self.model(patches)[0]
        # (B, C, px, py, pz) -> (B, px, py, pz, C), the score map's layout
        # (a view when the net ran channels_last_3d, as it does on the card)
        logits = logits.float().permute(0, 2, 3, 4, 1).contiguous()
        softmax_scatter_add_windows(score, logits, starts, n_valid)

    def _count_map(self, starts: np.ndarray,
                   shape: Tuple[int, ...]) -> torch.Tensor:
        """Windows covering each voxel (at least 1), built once per grid
        with numpy and kept on the device — the reference recomputes it
        per volume (`test_3d_patch.py:133`)."""
        key = (shape, starts.tobytes())
        if key not in self._cnt_cache:
            cnt = np.zeros(shape, np.float32)
            p = self.patch
            for s in starts:
                cnt[s[0]:s[0] + p[0], s[1]:s[1] + p[1],
                    s[2]:s[2] + p[2]] += 1.0
            self._cnt_cache[key] = torch.from_numpy(
                np.maximum(cnt, 1.0)).to(self.device)
        return self._cnt_cache[key]

    # -- public API -----------------------------------------------------
    @torch.no_grad()
    def infer_async(self, image: np.ndarray, rule: str = "threshold",
                    return_score: bool = True):
        """Enqueue one volume on the device and return a handle without
        waiting for it: the label (and score) copies to the host are
        enqueued behind the compute and an event marks their end. Pass the
        handle to :meth:`infer_fetch`."""
        orig_shape = image.shape
        image, off = pad_to_patch(np.asarray(image, np.float32), self.patch)
        shape = image.shape
        starts = window_starts(shape, self.patch, self.stride_xy,
                               self.stride_z)
        volume = torch.from_numpy(image).to(self.device)
        cnt = self._count_map(starts, shape)
        score = torch.zeros((*shape, self.num_classes), dtype=torch.float32,
                            device=self.device)
        B = self.batch
        n = starts.shape[0]
        n_chunks = math.ceil(n / B)
        pad_n = n_chunks * B - n
        all_starts = np.concatenate([starts, np.zeros((pad_n, 3), np.int32)])
        for c in range(n_chunks):
            self._process_chunk(volume, all_starts[c * B:(c + 1) * B],
                                min(B, n - c * B), score)
        score /= cnt[..., None]
        if rule == "argmax":
            label = torch.argmax(score, dim=-1).to(torch.uint8)
        elif rule == "threshold":   # class-1 prob > 0.5 (`test_3d_patch.py:137`)
            label = (score[..., 1] > 0.5).to(torch.uint8)
        else:
            raise ValueError(f"unknown rule {rule!r}")
        label = self._to_host(label)
        score = self._to_host(score) if return_score else None
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return label, score, event, orig_shape, off

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cpu":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    def infer_fetch(self, handle) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Wait for a handle from :meth:`infer_async`; returns (label_map,
        score_map[C-first] or None) cropped to the original volume."""
        label, score, event, orig_shape, off = handle
        if event is not None:
            event.synchronize()
        sl = tuple(slice(o, o + s) for o, s in zip(off, orig_shape))
        label = label.numpy().astype(np.int32)[sl]
        if score is None:
            return label, None
        return label, np.moveaxis(score.numpy(), -1, 0)[(slice(None),) + sl]

    def infer(self, image: np.ndarray, rule: str = "threshold",
              return_score: bool = True
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """One volume -> (label_map, score_map[C,...]) with the reference's
        rules: 'threshold' = class-1 prob > 0.5 (`test_3d_patch.py:137`),
        'argmax' (`pancreas/test_util.py:146`)."""
        return self.infer_fetch(self.infer_async(image, rule, return_score))

    def evaluate_case(self, image, label, nms: bool = False,
                      rule: str = "threshold"):
        pred, _ = self.infer(image, rule=rule, return_score=False)
        if nms:
            pred = M.host_largest_cc(pred)
        if pred.sum() == 0:
            return (0.0, 0.0, 0.0, 0.0), pred
        return M.calculate_metric_percase(pred, label[:]), pred

    def infer_cases(self, images, rule: str = "threshold", depth: int = 1):
        """Label maps of an iterable of volumes, in order. Up to ``depth``
        volumes beyond the one being yielded are enqueued on the device, so
        the host work between yields (NMS, metrics) overlaps the device's
        work on the next volume."""
        q: deque = deque()
        for image in images:
            q.append(self.infer_async(image, rule=rule, return_score=False))
            if len(q) > depth:
                yield self.infer_fetch(q.popleft())[0]
        while q:
            yield self.infer_fetch(q.popleft())[0]

    def validate_dice(self, cases, rule: str = "threshold") -> float:
        """`var_all_case_LA` (`test_3d_patch.py:20-39`): mean Dice over
        (image, label) cases, no NMS, an empty prediction counts 0."""
        labels = [lab for _, lab in cases]
        total = 0.0
        for pred, label in zip(
                self.infer_cases((img for img, _ in cases), rule=rule),
                labels):
            total += M.dice_binary(pred, label) if pred.sum() > 0 else 0.0
        return total / max(len(cases), 1)
