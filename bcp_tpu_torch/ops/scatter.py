"""Sliding-window overlap-add: ``score[window w] += probs[w]`` in window order.

Counterpart of ``bcp_tpu/ops/scatter.py``. On a CUDA tensor
:func:`scatter_add_windows` launches the hand-written kernel
(``kernels/csrc/scatter_add.cu``); on a CPU tensor it runs
:func:`scatter_add_windows_reference`, the plain in-order loop. Both give
the same f32 sums bit for bit, because both add each window's probs in
window order.
"""

from __future__ import annotations

import numpy as np
import torch

from bcp_tpu_torch import kernels

#: most windows one launch takes (they travel in the kernel's parameters)
MAX_WINDOWS = 64


def _host_starts(starts) -> np.ndarray:
    if isinstance(starts, torch.Tensor):
        if starts.device.type != "cpu":
            raise ValueError("window starts must be on the host: the kernel "
                             "takes them by value")
        starts = starts.numpy()
    return np.ascontiguousarray(starts, dtype=np.int32).reshape(-1, 3)


def _check(score: torch.Tensor, probs: torch.Tensor, starts: np.ndarray):
    if score.dim() != 4 or probs.dim() != 5:
        raise ValueError(f"score must be (X,Y,Z,C) and probs (B,px,py,pz,C); "
                         f"got {tuple(score.shape)} and {tuple(probs.shape)}")
    if score.dtype != torch.float32 or probs.dtype != torch.float32:
        raise TypeError("score and probs must be float32")
    if probs.shape[-1] != score.shape[-1]:
        raise ValueError("class counts differ")
    if starts.shape[0] != probs.shape[0]:
        raise ValueError("one start per window")
    patch = np.array(probs.shape[1:4])
    if (starts < 0).any() or (starts + patch > np.array(score.shape[:3])).any():
        raise ValueError("a window reaches outside the score map")


def scatter_add_windows_reference(score: torch.Tensor, probs: torch.Tensor,
                                  starts) -> torch.Tensor:
    """The plain version: one slice ``+=`` per window, in window order."""
    st = _host_starts(starts)
    _check(score, probs, st)
    px, py, pz = probs.shape[1:4]
    for w, (sx, sy, sz) in enumerate(st.tolist()):
        score[sx:sx + px, sy:sy + py, sz:sz + pz] += probs[w]
    return score


def scatter_add_windows(score: torch.Tensor, probs: torch.Tensor,
                        starts) -> torch.Tensor:
    """``score[sx:sx+px, sy:sy+py, sz:sz+pz, :] += probs[w]`` for each window
    w in order, in place; returns ``score``. score (X,Y,Z,C) f32, probs
    (B,px,py,pz,C) f32, starts (B,3) int on the host."""
    if score.device.type == "cpu":
        return scatter_add_windows_reference(score, probs, starts)
    if score.device.type != "cuda" or probs.device != score.device:
        raise ValueError(f"score on {score.device}, probs on {probs.device}")
    st = _host_starts(starts)
    _check(score, probs, st)
    if not (score.is_contiguous() and probs.is_contiguous()):
        raise ValueError("score and probs must be contiguous")
    b = st.shape[0]
    if b > MAX_WINDOWS:
        raise ValueError(f"at most {MAX_WINDOWS} windows per launch, got {b}")
    X, Y, Z, C = score.shape
    px, py, pz = probs.shape[1:4]
    lib = kernels.library("scatter_add")
    code = lib.scatter_add_windows_f32(
        score.data_ptr(), probs.data_ptr(), st.ctypes.data, b, X, Y, Z, C,
        px, py, pz, kernels.stream_handle(score.device))
    kernels.check(code, "scatter_add_windows")
    kernels.count_launch(scatter_add_windows)
    return score


#: kernel launches; a caller sets it to 0 before the run it counts
scatter_add_windows.launches = 0
